"""Public wrappers over the port's kernels (the port of
``repro/kernels/ops.py``).

Each wrapper launches the hand-written CUDA kernel for CUDA tensors and
runs the kernel's plain torch version for CPU tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ckpt_quant as _q
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True,
                    softcap: Optional[float] = None, block_q: int = 128,
                    block_kv: int = 128) -> torch.Tensor:
    """GQA flash attention: q (BG, R, Sq, D), k/v (BG, Skv, D).

    ``block_q`` and ``block_kv`` (the Pallas kernel's VMEM tiling) are
    accepted for the JAX signature and do not enter: the CUDA kernels
    tile by their own sizes and the result does not depend on them."""
    del block_q, block_kv
    return _fa.flash_attention(q, k, v, scale=scale, causal=causal,
                               softcap=softcap)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD: x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,n)."""
    return _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk,
                         initial_state=initial_state)


def quantize_blocks(x: torch.Tensor, *, block: int = 512
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat x (N,) -> (int8 codes (N,), float32 scales (N/block,))."""
    return _q.quantize_blocks(x, block)


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor, *,
                      block: int = 512,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 codes (N,) + float32 scales (N/block,) -> (N,) in ``dtype``."""
    return _q.dequantize_blocks(q, scales, block, dtype)
