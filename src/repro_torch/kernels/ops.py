"""Public wrappers over the port's kernels (the port of
``repro/kernels/ops.py``).

Each wrapper launches the hand-written CUDA kernel for CUDA tensors and
runs the kernel's plain torch version for CPU tensors.  The
``flash_attention`` and ``quantize_blocks`` entries wait for their slices
(ROADMAP Queue 2).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ssd_scan as _ssd


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD: x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,n)."""
    return _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk,
                         initial_state=initial_state)
