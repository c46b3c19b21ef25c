"""GOOD: one generator threaded through helpers in a fixed order, or a
generator of the helper's own; names that only look like the generator."""
import torch


def truncated_normal_init(gen, shape):
    return torch.randn(shape, generator=gen).clamp(-2.0, 2.0)


def _dt_bias_init(gen, n):
    return torch.rand(n, generator=gen)


def init(gen: torch.Generator):
    dt_bias = _dt_bias_init(gen, 4)
    w = truncated_normal_init(gen, (4, 4))
    return dt_bias, w


def child_streams(seed: int):
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(4, generator=g)
    w = truncated_normal_init(torch.Generator().manual_seed(seed + 1), (4,))
    dev = torch.Generator(device=g.device)
    return u, w, dev, isinstance(g, torch.Generator)


def checks(gaps):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(3, generator=g)
    return x, all(ok(g) for g in gaps)          # the comprehension's own g


def ok(g: dict) -> bool:
    return g["finite"]
