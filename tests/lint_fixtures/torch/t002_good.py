"""GOOD: step bodies that stay on the device; host conversions only of
metadata and of static arguments."""
import numpy as np
import torch


def _masked_steps(s, p, draws, *, macro_threshold: float):
    n = int(draws.shape[0])                     # metadata
    thr = float(macro_threshold)                # keyword flag
    B = int(s.numel())
    return s * thr + n + B


def _attempt(s, p, u2, any_store: bool, chunk: int):
    width = float(s.shape[1] - 1)               # metadata
    steps = int(chunk)                          # int parameter
    use = bool(any_store)                       # bool parameter
    table = np.asarray([1.0, 2.0])              # host constant
    mu = torch.clamp_max(s.t * p, width) * steps
    return torch.where(u2 > 0.5, mu, mu * table[0]) if use else mu
