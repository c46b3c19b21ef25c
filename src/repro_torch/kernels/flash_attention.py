"""GQA flash attention (forward): the CUDA kernel and its plain version.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:37``
(``_flash_kernel``, entry ``flash_attention`` at ``:87``), whose grid
``(BG, R, q blocks, kv blocks)`` carries the online-softmax statistics
(float32 m, l, acc) in VMEM across a sequential kv axis, skips kv blocks
above the causal diagonal and writes the input's dtype.  Layout: q (BG, R,
Sq, D), k and v (BG, Skv, D), the kv groups folded into BG and the R query
heads of a group sharing one kv head.  The causal mask has a diagonal
offset ``off``: key j is visible to query i iff ``j <= i + off``, by
default ``off = Skv - Sq`` (bottom-right alignment: a call over its own
keys).  A part of the keys that starts at position ``s``, called with q
holding every query row from position 0, passes ``off = -s`` (context
parallelism, ``models/parallel_attention.py``).  With ``stats=True`` a
call also returns each row's float32 statistics, ``m`` (the row's max of
the scaled, softcapped scores over its visible keys) and ``l`` (the sum of
``exp(s - m)``), (BG, R, Sq) each: the parts of a key sequence combine by
them.  A row that sees no key has ``m = NEG_INF`` (-1e30, never -inf) and
``l = 0``, which gives it weight 0 in the combine.

The CUDA source (``csrc/flash_attention.cu``) holds two kernels, and
:func:`route` picks one from the dtype and head_dim alone:

* ``"wgmma"`` -- bfloat16 with head_dim 64 or 128 (olmo-1b's prefill and
  every dense serving config), and bfloat16 with a head_dim that is a
  multiple of 16 between them (zamba2-7b's 112): a tensor-core kernel for
  Hopper.  One block
  per (bg, r, 128 query rows): a producer warp loads the q tile once and
  K/V tiles of 128 keys into a two-stage ring by TMA (128-byte swizzle,
  mbarrier completion); two consumer warpgroups of 64 rows each run
  ``S = q k^T`` as ``wgmma`` from shared memory, the online softmax on the
  accumulator registers, and ``O += P V`` with P rounded to bfloat16 in
  registers as wgmma's A operand (the TPU's default-precision float32 dot
  rounds that operand the same way); m, l (from the unrounded p) and O
  stay float32.
* ``"simt"`` -- float32, and head_dim 16 or 32: the first port of the
  kernel, one block of 256 threads per (bg, r, 64-row q block), products
  on the float32 SIMT units from shared memory.  The float32 parity paths
  run it.

A bfloat16 head_dim strictly between 64 and 128 (:func:`padded_head_dim`)
is zero-padded along D to 128 by the wrapper, run by the D-128 tensor-core
kernel and sliced back: the zero columns add nothing to q k^T, and v's
come out as zero columns that are cut off.  The scale is the caller's
(1/sqrt(112) for zamba2), never one recomputed from the padded D.  The
pad copies are part of the call and of its measured time.  :func:`takes`
says whether any kernel takes a dtype and head_dim; the model asks it
before it routes a call here, so a shape no kernel takes (float32 at
head_dim 112, float16) runs the plain attention by its shape.

Both take any Sq and Skv and read q, k and v through their strides (unit
stride along D, every other stride a multiple of 16 bytes, else ``_rows``
copies first).  A query row that sees no key (Sq > Skv under the causal
mask) gives 0, as the Pallas kernel gives it where such rows fill whole q
blocks; the JAX oracle ``ref.flash_attention_ref`` gives the mean of v
there instead (ROADMAP Queue 3).

What bounds it on an H100: at olmo-1b's prefill shape (BG 128, R 1, Sq =
Skv = 1024, D 128, bf16) the causal work is 34.4 GFLOP and q, k, v and o
are 134 MB, so the least time is ~0.040 ms, set by the bytes at 3.35 TB/s
(the operations take 0.035 ms at the bf16 tensor-core rate).  The SIMT
kernel is bound at ~0.51 ms by the float32 rate; the tensor-core kernel
by its unhidden softmax between the two products.  PERF.md holds the
measured times; a split-KV decode form and a backward are later work.

``flash_attention`` launches the routed kernel for CUDA tensors (or
raises) and runs ``flash_attention_plain`` for CPU tensors.  ``LAUNCHES``
counts kernel launches, ``LAUNCHES_BY_ROUTE`` the launches of each
kernel.  The kernel has no backward (neither has the Pallas kernel): on
CUDA tensors under autograd ``flash_attention`` raises rather than return
an output that no gradient flows through.

Each launch reports its work to an active cost counter
(``launch.cost_analysis``): the dense products its plain version runs,
``4 · BG · R · Sq · Skv · D`` (the causal mask does not cut them, as
the JAX dense path's HLO counts them), and q, k, v and o's bytes.  On
the meta device (the dry run) the wrapper checks the operands, reports
the same work and returns an uninitialised output of the right shape.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.launch import cost_analysis as CA

LAUNCHES = 0                                # launches of either kernel
LAUNCHES_BY_ROUTE = {"wgmma": 0, "simt": 0}
# launches given an explicit diagonal offset, and launches with statistics
LAUNCHES_BY_MODE = {"offset": 0, "stats": 0}
HEAD_DIMS = (16, 32, 64, 128)   # head_dim the kernel takes
TC_HEAD_DIMS = (64, 128)        # head_dim the tensor-core kernel takes
PAD_TO = 128    # bf16 head_dim strictly between 64 and 128 is padded to it
NEG_INF = -1e30


def padded_head_dim(dtype: torch.dtype, head_dim: int) -> int:
    """The head_dim the kernel runs a call at: PAD_TO for bfloat16 with a
    head_dim that is a multiple of 16 strictly between 64 and 128 (the
    wrapper zero-pads D), else ``head_dim`` itself."""
    if dtype == torch.bfloat16 and head_dim % 16 == 0 \
            and TC_HEAD_DIMS[0] < head_dim < PAD_TO:
        return PAD_TO
    return head_dim


def takes(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether a kernel takes q, k and v of this dtype and head_dim:
    bfloat16 or float32 at a head_dim of HEAD_DIMS, or bfloat16 at one
    :func:`padded_head_dim` pads."""
    return dtype in (torch.float32, torch.bfloat16) \
        and padded_head_dim(dtype, head_dim) in HEAD_DIMS


def route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel a call of this dtype and head_dim takes: ``"wgmma"``
    (the tensor-core kernel: bfloat16 with head_dim 64 or 128, or one
    padded to 128) or ``"simt"`` (the float32 SIMT kernel: float32, and
    head_dim 16 or 32)."""
    if dtype == torch.bfloat16 and \
            padded_head_dim(dtype, head_dim) in TC_HEAD_DIMS:
        return "wgmma"
    return "simt"


def _visible(sq: int, skv: int, device, off: Optional[int] = None
             ) -> torch.Tensor:
    """(Sq, Skv) causal mask of diagonal offset ``off`` (default ``Skv -
    Sq``): True where key j is visible to row i (``j <= i + off``)."""
    off = skv - sq if off is None else off
    return (torch.arange(skv, device=device)[None, :]
            <= torch.arange(sq, device=device)[:, None] + off)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float, causal: bool = True,
                          softcap: Optional[float] = None,
                          off: Optional[int] = None, stats: bool = False):
    """The kernel's function in torch ops: float32 scores, the optional
    softcap, the causal mask of offset ``off`` (default ``Skv - Sq``),
    softmax, float32 p v; a row with no visible key gives 0.  q (BG, R,
    Sq, D), k and v (BG, Skv, D) -> (BG, R, Sq, D) in q's dtype, and with
    ``stats`` the rows' float32 ``m`` and ``l`` (BG, R, Sq) beside it.
    Differentiable."""
    s = torch.einsum("brsd,btd->brst", q.float(), k.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        vis = _visible(q.shape[2], k.shape[1], q.device, off)
        m = torch.where(vis, s, NEG_INF).amax(dim=-1, keepdim=True)
        p = torch.where(vis, torch.exp(s - m), 0.0)
    else:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("brst,btd->brsd", p, v.float())
    o = (o / torch.where(den == 0, 1.0, den)).to(q.dtype)
    if not stats:
        return o
    return o, torch.where(den == 0, NEG_INF, m)[..., 0], den[..., 0]


def empty_stats(q: torch.Tensor):
    """What a call over no key gives, launching nothing: zero rows in q's
    dtype, ``m = NEG_INF`` and ``l = 0``."""
    rows = q.shape[:-1]
    return (torch.zeros(q.shape, dtype=q.dtype, device=q.device),
            torch.full(rows, NEG_INF, device=q.device),
            torch.zeros(rows, device=q.device))


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
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if not takes(q.dtype, D):
        raise ValueError(f"the flash kernel takes head_dim in {HEAD_DIMS} "
                         f"(bfloat16 also a multiple of 16 between "
                         f"{TC_HEAD_DIMS[0]} and {PAD_TO}, padded), got {D} "
                         f"in {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"k and v must have q's dtype {q.dtype}, got "
                         f"{k.dtype} and {v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")


def _strides(t: torch.Tensor) -> tuple:
    """``t``'s strides, with the stride of each axis of size 1 (which torch
    leaves arbitrary) replaced by that of a contiguous layout."""
    out, inner = [], 1
    for size, st in zip(reversed(t.shape), reversed(t.stride())):
        out.append(inner if size == 1 else st)
        inner *= size
    return tuple(reversed(out))


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can read it in place (unit stride
    along D, every row and batch stride a multiple of 16 bytes -- the
    SIMT kernel's 16-byte loads and TMA's rule -- and a 16-byte aligned
    base), else a contiguous copy."""
    st = _strides(t)
    aligned = all(x * t.element_size() % 16 == 0 for x in st[:-1])
    if st[-1] == 1 and aligned and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous()


def _lib():
    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        P, I, LL, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.flash_attention_launch.argtypes = (
            [P] * 4 + [I] * 6 + [LL] * 7 + [F, I, F, I, P, P, P])
        lib.flash_attention_launch.restype = I
        lib.flash_attention_error_string.argtypes = [I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_smem_bytes.argtypes = [I]
        lib.flash_attention_smem_bytes.restype = LL
        lib.flash_attention_tc_launch.argtypes = (
            [P] * 4 + [I] * 5 + [LL] * 7 + [F, I, F, I, P, P, P])
        lib.flash_attention_tc_launch.restype = I
        lib._typed = True
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True,
                    softcap: Optional[float] = None,
                    off: Optional[int] = None, stats: bool = False):
    """q (BG, R, Sq, D); k, v (BG, Skv, D) -> (BG, R, Sq, D) in q's dtype;
    with ``stats``, ``(o, m, l)``, the rows' float32 statistics (BG, R,
    Sq).  ``off``: the causal mask's diagonal offset (default ``Skv -
    Sq``).

    CUDA tensors: one launch of the CUDA kernel (raises if it cannot be
    built or launched, or if the operands are not what it takes; operands
    it cannot read in place are copied contiguous first; a head_dim that
    :func:`padded_head_dim` pads is zero-padded before the launch and the
    output sliced back).  CPU tensors: :func:`flash_attention_plain`.
    :func:`route` names the kernel.  ``LAUNCHES_BY_MODE`` counts the
    launches with an explicit ``off`` and with ``stats``.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, causal=causal,
                                     softcap=softcap, off=off, stats=stats)
    if q.device.type == "meta":
        _check(q, k, v, softcap)
        o = torch.empty(q.shape, dtype=q.dtype, device="meta")
        report_work(q, k, v, o)
        if stats:
            return (o, torch.empty(q.shape[:-1], device="meta"),
                    torch.empty(q.shape[:-1], device="meta"))
        return o
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
    D = q.shape[-1]
    pad = padded_head_dim(q.dtype, D) - D
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    out = _launch(q, k, v, route(q.dtype, D), scale=scale, causal=causal,
                  softcap=softcap, off=off, stats=stats, report=not pad)
    o = out[0] if stats else out
    if pad:
        o = o[..., :D]
        report_work(q[..., :D], k[..., :D], v[..., :D], o)
    return (o,) + out[1:] if stats else o


def work(BG: int, R: int, Sq: int, Skv: int, D: int) -> int:
    """The FLOPs of the plain version's two products (q k^T and p v)."""
    return 4 * BG * R * Sq * Skv * D


def report_work(q, k, v, o) -> None:
    """One call's work to an active cost counter (at q's unpadded D)."""
    BG, R, Sq, D = q.shape
    CA.report_kernel(flops=work(BG, R, Sq, k.shape[1], D),
                     nbytes=sum(CA.nbytes(t) for t in (q, k, v, o)))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, how: str, *,
            scale: float, causal: bool, softcap: Optional[float],
            off: Optional[int] = None, stats: bool = False,
            report: bool = True):
    """One launch of the kernel ``how`` names on checked CUDA operands:
    o, or ``(o, m, l)`` with ``stats``.  :func:`flash_attention` passes
    :func:`route`'s choice; ``chip_smoke.py`` also times the SIMT kernel
    at the shapes the tensor-core kernel serves."""
    global LAUNCHES
    q, k, v = _rows(q), _rows(k), _rows(v)
    BG, R, Sq, D = q.shape
    Skv = k.shape[1]
    o = torch.empty((BG, R, Sq, D), dtype=q.dtype, device=q.device)
    ml = [torch.empty((BG, R, Sq), device=q.device) for _ in range(2)] \
        if stats else []
    lib = _lib()
    (q_bg, q_r, q_s, _), (k_bg, k_s, _), (v_bg, v_s, _) = (
        _strides(q), _strides(k), _strides(v))
    common = (BG, R, Sq, Skv, D, q_bg, q_r, q_s, k_bg, k_s, v_bg,
              v_s, float(scale), int(bool(causal)),
              float(softcap) if softcap is not None else 0.0,
              int(Skv - Sq if off is None else off),
              *([t.data_ptr() for t in ml] if stats else [None, None]))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    if how == "wgmma":
        rc = build.launch(lib.flash_attention_tc_launch, q.device, *ptrs,
                          *common)
    else:
        rc = build.launch(lib.flash_attention_launch, q.device, *ptrs,
                          int(q.dtype == torch.bfloat16), *common)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel ({how}) launch failed: "
                           f"{lib.flash_attention_error_string(rc).decode()}")
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[how] += 1
    LAUNCHES_BY_MODE["offset"] += off is not None
    LAUNCHES_BY_MODE["stats"] += stats
    if report:
        report_work(q, k, v, o)
    return (o, *ml) if stats else o
