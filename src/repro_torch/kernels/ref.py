"""Plain-torch oracles for the port's kernels (the port of
``repro/kernels/ref.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, causal: bool = True,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Reference attention.

    q: (B, R, Sq, D) query groups; k, v: (B, Sk, D).  (GQA is expressed by
    folding kv-head groups into B and query-heads-per-group into R.)  As
    the JAX oracle does, a row that sees no key (Sq > Sk, causal) gets the
    softmax of its all -1e30 scores, the mean of v; the kernels give 0
    there (ROADMAP Queue 3).
    """
    s = torch.einsum("brsd,btd->brst", q.float(), k.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        Sq, Sk = q.shape[2], k.shape[1]
        # bottom-right aligned causal mask (decode-style when Sq < Sk)
        qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        mask = torch.arange(Sk, device=q.device)[None, :] <= qpos
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("brst,btd->brsd", p, v.float()).to(q.dtype)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor,
                 initial_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential (non-chunked) SSD recurrence -- the exact oracle.

    x: (b, s, h, p), dt: (b, s, h), A: (h,), B/C: (b, s, n).
    Returns y (b, s, h, p), final_state (b, h, p, n).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf = B.float(), C.float()
    state = (torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        dA = torch.exp(dtf[:, t] * A)[..., None, None]          # (b,h,1,1)
        dBx = torch.einsum("bh,bn,bhp->bhpn", dtf[:, t], Bf[:, t], xf[:, t])
        state = state * dA + dBx
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state


def quantize_blocks_ref(x: torch.Tensor, block: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization of a flat float array.

    x: (N,) with N % block == 0.  Returns (q int8 (N,), scales f32
    (N/block,)).  The scale is ``amax / 127`` by true division (the
    kernels multiply by float32(1/127) instead; within 1 ulp).
    """
    xb = x.float().reshape(-1, block)
    amax = xb.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0),
                        torch.ones_like(amax))
    q = torch.round(xb / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q.reshape(-1), scale


def dequantize_blocks_ref(q: torch.Tensor, scale: torch.Tensor, block: int,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    qb = q.reshape(-1, block).float()
    return (qb * scale[:, None]).reshape(-1).to(dtype)
