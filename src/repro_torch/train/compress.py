"""Int8 gradient compression with error feedback (the port of
``repro/train/compress.py``).

Before the cross-replica gradient reduction, each leaf is block-quantized
to int8 (:mod:`repro_torch.kernels.ckpt_quant`, the same kernels that
compress checkpoint images) and the quantization residual is carried into
the next step (error feedback).  On the wire this cuts gradient
all-reduce bytes 4x against float32.

A gradient "pytree" here is the port's flat mapping of parameter name to
tensor; each leaf is padded to a block multiple on its own, as the JAX
package pads each of its leaves.  The structure is the reference's: one
quantize and two dequantizes per leaf (one inside
:func:`compress_leaf` for the residual, one for the output).
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import dequantize_blocks, quantize_blocks

Grads = Mapping[str, torch.Tensor]


def _pad_to(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat, pad


def compress_leaf(g: torch.Tensor, err: torch.Tensor, block: int = 512):
    """Quantize (g + err); return (codes, scales, new_err)."""
    g32 = g.float() + err
    flat, pad = _pad_to(g32, block)
    codes, scales = quantize_blocks(flat, block=block)
    deq = dequantize_blocks(codes, scales, block=block)
    if pad:
        deq = deq[:-pad]
    deq = deq.reshape(g.shape)
    new_err = g32 - deq
    return codes, scales, new_err


def init_error_feedback(params: Grads) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def compress_grads(grads: Grads, err_state: Grads, block: int = 512
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Compress a gradient mapping; returns (dequantized grads, new error
    state), both keyed like ``grads``.

    The dequantized values are what the optimizer consumes: what every
    peer reconstructs after the compressed all-reduce.
    """
    outs, errs = {}, {}
    for name, g in grads.items():
        codes, scales, new_err = compress_leaf(g, err_state[name], block)
        deq = dequantize_blocks(codes, scales, block=block)
        outs[name] = deq[:g.numel()].reshape(g.shape).to(g.dtype)
        errs[name] = new_err
    return outs, errs


def compressed_bytes(params: Grads, block: int = 512) -> Tuple[int, int]:
    """(compressed, raw fp32) wire bytes for a gradient mapping."""
    comp = raw = 0
    for p in params.values():
        n = int(p.numel())
        nb = (n + block - 1) // block
        comp += n + 4 * nb       # int8 codes + fp32 scales
        raw += 4 * n
    return comp, raw
