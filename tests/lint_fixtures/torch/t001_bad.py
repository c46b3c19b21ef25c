"""BAD: Python control flow on a tensor's value inside step bodies."""
import torch

WARP = 32


def _warp_live(finished):
    return ~finished.view(-1, WARP).all(dim=1)


def _masked_steps(s, p, draws, *, macro_threshold: float):
    for i in range(draws.shape[0]):
        live_w = _warp_live(s.finished)
        if not bool(live_w.any()):             # T001 (and T002): host sync
            break
        s = s + draws[i]
    return s


def _apply(s, u, any_pm: bool):
    if (u > 0.5).any():                         # T001: if on a value
        s = s + 1.0
    while (s < 0.0).any():                      # T001: while on a value
        s = s + 1.0
    assert torch.isfinite(s).all()              # T001: assert on a value
    t = s * 2.0 if s.sum() > 0 else s           # T001: conditional expression
    return [x for x in t if x > 0]              # T001: comprehension filter
