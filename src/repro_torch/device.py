"""Device resolution and float64 constants shared by the port's entry points.

Entry points take ``device=None`` and run on CUDA; the CPU is used only
when the caller asks for it (``device="cpu"``), which is what the tests do.
There is no silent fallback: with no card and no explicit CPU request,
:func:`resolve_device` raises.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

F64 = torch.float64


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


_CONSTS: Dict[Tuple[str, float], torch.Tensor] = {}


def const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim float64 tensor holding ``value`` on ``like``'s device.

    Dividing by a Python float on CUDA multiplies by its reciprocal (one
    extra rounding); dividing by a device tensor is IEEE true division on
    every device, the same operation numpy and the CUDA kernel perform.
    """
    key = (str(like.device), float(value))
    c = _CONSTS.get(key)
    if c is None:
        c = torch.tensor(float(value), dtype=F64, device=like.device)
        _CONSTS[key] = c
    return c


def div(a: torch.Tensor, value: float) -> torch.Tensor:
    """``a / value`` as true division on every device (see :func:`const`)."""
    return a / const(value, a)
