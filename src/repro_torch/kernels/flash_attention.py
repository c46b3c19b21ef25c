"""GQA flash attention (forward): the CUDA kernel and its plain version.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:37``
(``_flash_kernel``, entry ``flash_attention`` at ``:87``), whose grid
``(BG, R, q blocks, kv blocks)`` carries the online-softmax statistics
(float32 m, l, acc) in VMEM across a sequential kv axis, skips kv blocks
above the causal diagonal and writes the input's dtype.  Layout: q (BG, R,
Sq, D), k and v (BG, Skv, D), the kv groups folded into BG and the R query
heads of a group sharing one kv head.  The causal mask is bottom-right
aligned: key j is visible to query i iff ``j <= i + Skv - Sq``.

The CUDA version (``csrc/flash_attention.cu``) runs one block of 256
threads per (bg, r, 64-row q block) and loops over 64-key tiles up to the
block's last visible key, the q and k tiles transposed in shared memory as
float32, the products on the float32 SIMT units.  It takes float32 and
bfloat16, any Sq and Skv (the Pallas kernel asks for block multiples, a
tiling constraint), and head_dim 16, 32, 64 or 128.  A query row that sees
no key (Sq > Skv under the causal mask) gives 0, as the Pallas kernel gives
it where such rows fill whole q blocks; the JAX oracle
``ref.flash_attention_ref`` gives the mean of v there instead (ROADMAP
Queue 3).

What bounds it on an H100: at olmo-1b's prefill shape (BG 128, R 1, Sq =
Skv = 1024, D 128, bf16) the causal work is 34.4 GFLOP and q, k, v and o
are 134 MB, so the least time is ~0.040 ms, set by the bytes at 3.35 TB/s
(the operations take 0.035 ms at the bf16 tensor-core rate).  Keeping the
TPU kernel's float32 products, the float32 SIMT rate (67 TFLOP/s) bounds
this kernel at ~0.51 ms.  Tensor cores (``wgmma``), TMA and a split-KV
decode form are later work; PERF.md holds the measured time.

``flash_attention`` launches the kernel for CUDA tensors (or raises) and
runs ``flash_attention_plain`` for CPU tensors.  ``LAUNCHES`` counts kernel
launches.  The kernel has no backward (neither has the Pallas kernel): on
CUDA tensors under autograd ``flash_attention`` raises rather than return
an output that no gradient flows through.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

LAUNCHES = 0
HEAD_DIMS = (16, 32, 64, 128)   # head_dim the kernel takes
NEG_INF = -1e30


def _visible(sq: int, skv: int, device) -> torch.Tensor:
    """(Sq, Skv) bottom-right causal mask: True where key j is visible."""
    return (torch.arange(skv, device=device)[None, :]
            <= torch.arange(sq, device=device)[:, None] + (skv - sq))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float, causal: bool = True,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in torch ops: float32 scores, the optional
    softcap, the bottom-right causal mask, softmax, float32 p v; a row
    with no visible key gives 0.  q (BG, R, Sq, D), k and v (BG, Skv, D)
    -> (BG, R, Sq, D) in q's dtype.  Differentiable."""
    s = torch.einsum("brsd,btd->brst", q.float(), k.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        vis = _visible(q.shape[2], k.shape[1], q.device)
        m = torch.where(vis, s, NEG_INF).amax(dim=-1, keepdim=True)
        p = torch.where(vis, torch.exp(s - m), 0.0)
    else:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("brst,btd->brsd", p, v.float())
    return (o / torch.where(den == 0, 1.0, den)).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           softcap: Optional[float]) -> None:
    """Raise on operands the kernel does not take (any device)."""
    if q.dim() != 4 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q must be (BG, R, Sq, D) and k, v (BG, Skv, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BG, R, Sq, D = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != BG \
            or k.shape[2] != D:
        raise ValueError(f"k and v must be ({BG}, Skv, {D}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if min(BG, R, Sq, k.shape[1]) == 0:
        raise ValueError(f"empty operand: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {D}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"k and v must have q's dtype {q.dtype}, got "
                         f"{k.dtype} and {v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it in place (unit stride along
    D, every row 16-byte aligned), else a contiguous copy."""
    rows_aligned = all(st % 4 == 0 for st in t.stride()[:-1])
    if t.stride(-1) == 1 and rows_aligned and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous()


def _lib():
    from repro_torch.kernels import build

    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        P, I, LL, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.flash_attention_launch.argtypes = (
            [P] * 4 + [I] * 6 + [LL] * 7 + [F, I, F, P])
        lib.flash_attention_launch.restype = I
        lib.flash_attention_error_string.argtypes = [I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_smem_bytes.argtypes = [I]
        lib.flash_attention_smem_bytes.restype = LL
        lib._typed = True
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q (BG, R, Sq, D); k, v (BG, Skv, D) -> (BG, R, Sq, D) in q's dtype.

    CUDA tensors: one launch of the CUDA kernel (raises if it cannot be
    built or launched, or if the operands are not what it takes; operands
    it cannot read in place are copied contiguous first).  CPU tensors:
    :func:`flash_attention_plain`.
    """
    global LAUNCHES
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, causal=causal,
                                     softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CPU or CUDA tensors, got "
                         f"{q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the flash-attention kernel has no backward (neither in the JAX "
            "package nor in the port): its output would carry no gradient "
            "to q, k or v.  Call it under torch.no_grad or "
            "torch.inference_mode, or run the plain attention "
            "(use_flash_kernel=False)")
    _check(q, k, v, softcap)
    q, k, v = _rows(q), _rows(k), _rows(v)
    BG, R, Sq, D = q.shape
    o = torch.empty((BG, R, Sq, D), dtype=q.dtype, device=q.device)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        int(q.dtype == torch.bfloat16), BG, R, Sq, k.shape[1], D,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), float(scale), int(bool(causal)),
        float(softcap) if softcap is not None else 0.0, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{lib.flash_attention_error_string(rc).decode()}")
    LAUNCHES += 1
    return o
