"""Mamba2 SSD chunked scan (forward): the CUDA kernel and its plain version.

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py:33``
(``_ssd_kernel``, entry ``ssd_scan`` at ``:79``), whose grid ``(b, h, nc)``
carries the ``(p, n)`` float32 state in VMEM across a sequential chunk
axis and computes each chunk in the quadratic "dual" form:

    y_intra = ((C B^T) o L) (dt x),  L[i, j] = exp(cum_i - cum_j), i >= j
    y_inter = (C e^{cum}) state^T
    state   = state e^{cum_Q} + (dt x e^{cum_Q - cum})^T B

The CUDA source (``csrc/ssd_scan.cu``) holds two implementations, and
:func:`route` picks one from the dtype and shapes alone:

* ``"mma"`` -- bfloat16 x / B / C, head_dim a multiple of 16 up to 64,
  d_state 64 or 128, chunk a multiple of 64 up to 256 (mamba2-130m's
  serving prefill): three tensor-core kernels, as Mamba2's GPU kernels
  split the work.  (1) Per (chunk, head, batch): the chunk's cumulative
  decay by a block scan and its local state ``(dt x e^{cum_Q - cum})^T
  B``.  (2) Per (batch, head): the state entering each chunk,
  ``state_c = state_{c-1} e^{cum_Q} + local_{c-1}``, and the final state.
  (3) Per (64-row tile, chunk, batch): ``G = C B^T`` once, shared by all
  heads, then per head ``y = (G o L o dt) x + e^{cum} C state_in^T``, the
  heads in two streams of 4 warps so that one's loads run under the
  other's products.
  Products run as ``mma.sync`` bf16 with float32 accumulation; C B^T is
  exact, and each float32 operand (the masked scores, the decay-weighted
  x, the state) is split into three bf16 parts, hi + mid + lo, and issued
  as three products (~2^-25 relative error where one bf16 rounding gives
  2^-9; two parts, ~2^-17, were measured too coarse for S4's 24-layer
  logits check).  Each call is three CUDA launches; ``LAUNCHES`` counts
  calls.
* ``"simt"`` -- float32, and the shapes above it does not take: the first
  port of the kernel, one block per (batch, head) looping over the chunks
  with the state in shared memory, 64 x 64 score tiles at or below the
  diagonal, products on the float32 SIMT units.

What bounds it on an H100: at the serving shape (b 8, s 1024, h 24, p 64,
n 128, Q 256) the work is ~10 GFLOP (0.27 bf16, 9.67 with a float32
operand) against ~68 MB to move; with every operation counted once at
the bf16 tensor rate the bytes set the bound (0.0203 ms at 3.35 TB/s).
The SIMT kernel's own bound is the float32 rate (~0.14 ms).  PERF.md
holds the measured times.

Contract: equal to :func:`ssd_scan_plain` (float32 sums in another order,
one rounding of y to x's type) within the tolerance the callers state.

``ssd_scan`` launches the routed kernel(s) for CUDA tensors (or raises)
and runs ``ssd_scan_plain`` for CPU tensors.  ``LAUNCHES`` counts calls
that launched, ``LAUNCHES_BY_ROUTE`` those of each route.
The kernel has no backward: on CUDA tensors under autograd (grad enabled
and an input that requires grad) ``ssd_scan`` raises rather than return
outputs that no gradient flows through.

Each call that launches reports its work to an active cost counter
(``launch.cost_analysis``): the products of ``models.ssm.ssd_chunked``
over the same inputs (:func:`chunked_work`; ``chunk`` the caller's, the
sequence padded to it as ``ssd_chunked`` pads) and the bytes of x, dt,
B, C, y and the states.  On the meta device (the dry run) the wrapper
reports the same and returns uninitialised outputs of the right shapes.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.launch import cost_analysis as CA

LAUNCHES = 0                             # calls that launched a kernel
LAUNCHES_BY_ROUTE = {"mma": 0, "simt": 0}
MAX_P = 64      # head_dim the kernel takes
MAX_N = 128     # d_state the kernel takes
MAX_SMEM = 232_448   # bytes of shared memory one block may use on Hopper
TC_N = (64, 128)     # d_state the tensor-core kernels take
TC_ROW_TILE = 64     # the chunk is a multiple of this ...
TC_MAX_Q = 256       # ... up to this


def route(dtype: torch.dtype, p: int, n: int, chunk: int) -> str:
    """Which kernel a call takes, from the dtype of x / B / C, head_dim p,
    d_state n and the chunk length actually used (``min(chunk, s)``):
    ``"mma"`` (the tensor-core kernels: bfloat16, p a multiple of 16 up to
    64, n 64 or 128, chunk a multiple of 64 up to 256) or ``"simt"`` (the
    float32 SIMT kernel: everything else it takes)."""
    if (dtype == torch.bfloat16 and p % 16 == 0 and p <= MAX_P
            and n in TC_N and chunk % TC_ROW_TILE == 0
            and chunk <= TC_MAX_Q):
        return "mma"
    return "simt"


def _chunk(s: int, chunk: int) -> int:
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0 (the SSD kernel "
                         f"does not pad)")
    return chunk


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
                   initial_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's chunk math in torch ops, chunk after chunk.

    x (b, s, h, p), dt (b, s, h), A (h,), B/C (b, s, n), initial state
    (b, h, p, n).  Returns y (b, s, h, p) in x's dtype and the final state
    (b, h, p, n) in float32.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    Q = _chunk(s, chunk)
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    Af = A.float()
    state = (torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    ys = []
    for t0 in range(0, s, Q):
        xc, dtc = xf[:, t0:t0 + Q], dtf[:, t0:t0 + Q]      # (b,Q,h,p), (b,Q,h)
        Bc, Cc = Bf[:, t0:t0 + Q], Cf[:, t0:t0 + Q]        # (b,Q,n)
        cum = torch.cumsum(dtc * Af, dim=1)                # (b,Q,h)
        ch = cum.transpose(1, 2)                           # (b,h,Q)
        L = torch.where(tri, torch.exp(ch[..., :, None] - ch[..., None, :]),
                        0.0)                               # (b,h,Q,Q)
        scores = Cc @ Bc.transpose(1, 2)                   # (b,Q,Q)
        dtx = xc * dtc[..., None]                          # (b,Q,h,p)
        y_intra = torch.einsum("bhij,bjhp->bihp", scores[:, None] * L, dtx)
        y_inter = (torch.einsum("bin,bhpn->bihp", Cc, state)
                   * torch.exp(cum)[..., None])
        ys.append(y_intra + y_inter)
        decay_to_end = torch.exp(cum[:, -1:] - cum)[..., None]   # (b,Q,h,1)
        contrib = torch.einsum("bjhp,bjn->bhpn", dtx * decay_to_end, Bc)
        state = state * torch.exp(cum[:, -1])[..., None, None] + contrib
    return torch.cat(ys, dim=1).to(x.dtype), state


def _check(x, dt, A, B, C, initial_state, Q: int) -> None:
    b, s, h, p = x.shape
    n = B.shape[-1]
    dev = x.device
    named = dict(x=x, dt=dt, A=A, B=B, C=C)
    if initial_state is not None:
        named["initial_state"] = initial_state
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"B and C must have x's dtype {x.dtype}, got "
                         f"{B.dtype} and {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32, got {dt.dtype} and "
                         f"{A.dtype}")
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,):
        raise ValueError(f"dt must be {(b, s, h)} and A {(h,)}, got "
                         f"{tuple(dt.shape)} and {tuple(A.shape)}")
    if B.dim() != 3 or tuple(B.shape[:2]) != (b, s) or C.shape != B.shape:
        raise ValueError(f"B and C must be ({b}, {s}, n), got "
                         f"{tuple(B.shape)} and {tuple(C.shape)}")
    if p > MAX_P or n > MAX_N:
        raise ValueError(f"the kernel takes head_dim <= {MAX_P} and "
                         f"d_state <= {MAX_N}, got {p} and {n}")
    # Batch and sequence strides are free; the inner axes must be dense.
    if x.stride(3) != 1 or (h > 1 and x.stride(2) != p):
        raise ValueError(f"x must have dense (h, p) axes, strides "
                         f"{x.stride()}")
    if dt.stride(2) != 1:
        raise ValueError(f"dt must have a dense h axis, strides {dt.stride()}")
    if B.stride(2) != 1 or C.stride(2) != 1:
        raise ValueError("B and C must have a dense n axis")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")
    if initial_state is not None and (
            initial_state.dtype != torch.float32
            or tuple(initial_state.shape) != (b, h, p, n)
            or not initial_state.is_contiguous()):
        raise ValueError(f"initial_state must be a contiguous float32 "
                         f"{(b, h, p, n)}")
    smem = _lib().ssd_scan_smem_bytes(p, n, Q)
    if smem > MAX_SMEM:
        raise ValueError(f"chunk {Q} needs {smem} bytes of shared memory, "
                         f"more than the {MAX_SMEM} one block may use")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the tensor-core kernels can copy its rows in
    16-byte pieces (batch and sequence strides multiples of 8 elements, a
    16-byte aligned base), else a contiguous copy."""
    if all(st % 8 == 0 for st in t.stride()[:2]) and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous()


def _lib():
    lib = build.load("ssd_scan")
    if not getattr(lib, "_typed", False):
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_scan_launch.argtypes = [P] * 8 + [I] * 7 + [LL] * 8 + [P]
        lib.ssd_scan_launch.restype = I
        lib.ssd_scan_error_string.argtypes = [I]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib.ssd_scan_smem_bytes.argtypes = [I, I, I]
        lib.ssd_scan_smem_bytes.restype = LL
        lib.ssd_scan_tc_launch.argtypes = [P] * 11 + [I] * 6 + [LL] * 8 + [P]
        lib.ssd_scan_tc_launch.restype = I
        lib._typed = True
    return lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, h, p); dt (b, s, h); A (h,); B, C (b, s, n).

    Returns (y (b, s, h, p) in x's dtype, final state (b, h, p, n) float32).
    ``chunk = min(chunk, s)`` must divide s.  CUDA tensors: one launch of
    the CUDA kernel (raises if it cannot be built or launched, or if the
    operands are not what it takes).  CPU tensors: :func:`ssd_scan_plain`.
    :func:`route` names the kernel.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    Q = _chunk(s, chunk)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk=Q,
                              initial_state=initial_state)
    if x.device.type == "meta":
        y = torch.empty((b, s, h, p), dtype=x.dtype, device="meta")
        final = torch.empty((b, h, p, n), dtype=torch.float32, device="meta")
        _report(x, dt, B, C, y, final, initial_state, chunk)
        return y, final
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan takes CPU or CUDA tensors, got {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, B, C, initial_state)):
        raise RuntimeError(
            "the SSD kernel has no backward (neither in the JAX package nor "
            "in the port): its outputs would carry no gradient to x, dt, A, "
            "B or C.  Training runs ssd_chunked (use_flash_kernel=False); "
            "call the kernel under torch.no_grad or torch.inference_mode")
    _check(x, dt, A, B, C, initial_state, Q)
    y, final = _launch(x, dt, A, B, C, initial_state, Q,
                       route(x.dtype, p, n, Q))
    _report(x, dt, B, C, y, final, initial_state, chunk)
    return y, final


def chunked_work(b: int, s: int, h: int, p: int, n: int, chunk: int) -> int:
    """The FLOPs of ``ssd_chunked``'s four products over a sequence padded
    to ``chunk``: C B^T, the intra-chunk (G o L) x, the chunk states and
    the inter-chunk C state."""
    nc = -(-s // chunk)
    Q = chunk
    return 2 * b * nc * (Q * Q * n + Q * Q * h * p + 2 * Q * h * p * n)


def _report(x, dt, B, C, y, final, initial_state, chunk: int) -> None:
    b, s, h, p = x.shape
    ts = [x, dt, B, C, y, final] + ([] if initial_state is None
                                    else [initial_state])
    CA.report_kernel(flops=chunked_work(b, s, h, p, B.shape[-1], chunk),
                     nbytes=sum(CA.nbytes(t) for t in ts))


def _launch(x, dt, A, B, C, initial_state, Q: int, how: str
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call of the kernel(s) ``how`` names on checked CUDA operands.
    :func:`ssd_scan` passes :func:`route`'s choice; ``chip_smoke.py`` also
    times the SIMT kernel at the shapes the tensor-core kernels serve."""
    global LAUNCHES
    b, s, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    lib = _lib()
    init_ptr = initial_state.data_ptr() if initial_state is not None else None
    if how == "mma":
        x, B, C = _aligned(x), _aligned(B), _aligned(C)
        nc = s // Q
        f32 = dict(dtype=torch.float32, device=x.device)
        cum = torch.empty((b, nc, h, Q), **f32)
        sloc = torch.empty((b, nc, h, p, n), **f32)
        state_in = torch.empty((b, nc, h, p, n), **f32)
        rc = build.launch(
            lib.ssd_scan_tc_launch, x.device,
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), init_ptr, y.data_ptr(), final.data_ptr(),
            cum.data_ptr(), sloc.data_ptr(), state_in.data_ptr(), b, s, h,
            p, n, Q, x.stride(0), x.stride(1),
            dt.stride(0), dt.stride(1), B.stride(0), B.stride(1),
            C.stride(0), C.stride(1))
    else:
        rc = build.launch(
            lib.ssd_scan_launch, x.device,
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), init_ptr, y.data_ptr(), final.data_ptr(),
            int(x.dtype == torch.bfloat16), b, s, h, p, n, Q, x.stride(0),
            x.stride(1), dt.stride(0), dt.stride(1), B.stride(0),
            B.stride(1), C.stride(0), C.stride(1))
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel ({how}) launch failed: "
                           f"{lib.ssd_scan_error_string(rc).decode()}")
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[how] += 1
    return y, final
