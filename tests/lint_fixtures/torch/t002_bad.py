"""BAD: host round-trips inside step bodies."""
import numpy as np
import torch


def _masked_steps(s, p, draws, *, macro_threshold: float):
    done = int(s.finished.sum())                # T002: int() of a value
    return s, done


def _attempt(s, p, u2, any_store: bool):
    mu = s.t * p
    top = mu.max().item()                       # T002: .item()
    rows = mu.tolist()                          # T002: .tolist()
    host = mu.cpu()                             # T002: .cpu()
    arr = mu.detach().numpy()                   # T002: .numpy()
    frac = float(mu.mean())                     # T002: float()
    view = np.asarray(mu)                       # T002: np.asarray
    flag = bool(u2.any())                       # T002: bool()
    return top, rows, host, arr, frac, view, flag
