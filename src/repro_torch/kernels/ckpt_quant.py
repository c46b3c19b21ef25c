"""Per-block symmetric int8 quantization: the CUDA kernels and their plain
versions.

Replaces the TPU kernels ``src/repro/kernels/ckpt_quant.py:28``
(``_quant_kernel``, entry ``quantize_blocks`` at ``:42``) and ``:37``
(``_dequant_kernel``, entry ``dequantize_blocks`` at ``:69``).  A flat
array is cut into blocks of ``block`` elements; each block gets one float32
scale and int8 codes:

    scale = amax * float32(1/127)    (1.0 for an all-zero block)
    codes = clip(round_half_even(x / scale), -127, 127)
    x'    = float(codes) * scale, cast to the output dtype

The scale is a multiply by the float32 constant 1/127, which is what XLA
makes of the Pallas kernel's ``amax / 127.0`` (the JAX oracle
``ref.quantize_blocks_ref`` divides, and differs by up to ~1e-7 relative);
``x / scale`` is IEEE division on every device (a tensor divided by a
tensor).  So the kernels (``csrc/ckpt_quant.cu``) equal
:func:`quantize_blocks_plain` and :func:`dequantize_blocks_plain` bit for
bit on the card, and those equal the Pallas kernels, blocks holding a NaN
or an inf included: a NaN absmax takes the scale 1.0 (``amax > 0`` is
false), an inf absmax an inf scale, and a NaN quotient the code 0 (what
XLA's conversion gives; the plain version says so before its cast).

The kernels take any number of blocks and any ``block`` that is a
multiple of 32 up to 4096 (the Pallas kernel's ``n_blocks % block_rows``
tiling constraint is not kept).  What bounds them on an H100 is bytes
(each element read once and written once as a code); see the source.

``quantize_blocks``/``dequantize_blocks`` launch the kernel for CUDA
tensors (or raise) and run the plain version for CPU tensors.
``LAUNCHES`` counts kernel launches per kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.launch import cost_analysis as CA

LAUNCHES: Dict[str, int] = {"quantize_blocks": 0, "dequantize_blocks": 0}
MAX_BLOCK = 4096
_DTYPES = (torch.float32, torch.bfloat16)


def _inv127(like: torch.Tensor) -> torch.Tensor:
    """float32(1/127) as a 0-dim tensor on ``like``'s device."""
    return torch.tensor(1.0 / 127.0, dtype=torch.float32, device=like.device)


def quantize_blocks_plain(x: torch.Tensor, block: int = 512
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x flat (N,), N % block == 0 -> (codes int8 (N,), scales f32 (N/block,))."""
    xb = x.float().reshape(-1, block)
    amax = xb.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax * _inv127(amax),
                        torch.ones_like(amax))
    q = (torch.round(xb / scale[:, None]).clamp_(-127, 127)
         .nan_to_num_(nan=0.0).to(torch.int8))
    return q.reshape(-1), scale


def dequantize_blocks_plain(q: torch.Tensor, scales: torch.Tensor,
                            block: int = 512,
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """codes (N,) and scales (N/block,) -> (N,) in ``dtype``."""
    x = q.reshape(-1, block).float() * scales[:, None]
    return x.reshape(-1).to(dtype)


def _check_block(n: int, block: int) -> int:
    if block % 32 or not 32 <= block <= MAX_BLOCK:
        raise ValueError(f"block must be a multiple of 32 in [32, "
                         f"{MAX_BLOCK}], got {block}")
    if n == 0 or n % block:
        raise ValueError(f"length {n} must be a positive multiple of block "
                         f"{block}")
    return n // block


def _lib():
    lib = build.load("ckpt_quant")
    if not getattr(lib, "_typed", False):
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ckpt_quantize_launch.argtypes = [P, P, P, I, LL, I, P]
        lib.ckpt_quantize_launch.restype = I
        lib.ckpt_dequantize_launch.argtypes = [P, P, P, I, LL, I, P]
        lib.ckpt_dequantize_launch.restype = I
        lib.ckpt_quant_error_string.argtypes = [I]
        lib.ckpt_quant_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.ckpt_quant_error_string(rc).decode()}")


def quantize_blocks(x: torch.Tensor, block: int = 512
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: flat (N,) float32 or bfloat16, N % block == 0 -> (codes int8 (N,),
    scales float32 (N/block,)).  CUDA tensors: one kernel launch; CPU
    tensors: :func:`quantize_blocks_plain`."""
    if x.dim() != 1:
        raise ValueError(f"x must be flat, got shape {tuple(x.shape)}")
    n_blocks = _check_block(x.shape[0], block)
    if x.device.type == "cpu":
        return quantize_blocks_plain(x, block)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_blocks takes CPU or CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32 or bfloat16, got "
                         f"{x.dtype}")
    return _launch_quantize(x, n_blocks, block)


def _launch_quantize(x: torch.Tensor, n_blocks: int, block: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty(n_blocks, dtype=torch.float32, device=x.device)
    lib = _lib()
    rc = build.launch(lib.ckpt_quantize_launch, x.device, x.data_ptr(),
                      q.data_ptr(), scales.data_ptr(),
                      int(x.dtype == torch.bfloat16), n_blocks, block)
    _raise_on(lib, rc, "quantize_blocks")
    LAUNCHES["quantize_blocks"] += 1
    CA.report_kernel(nbytes=CA.nbytes(x) + CA.nbytes(q) + CA.nbytes(scales))
    return q, scales


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor, block: int = 512,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """codes int8 (N,) and scales float32 (N/block,) -> (N,) in ``dtype``
    (float32 or bfloat16).  CUDA tensors: one kernel launch; CPU tensors:
    :func:`dequantize_blocks_plain`."""
    if q.dim() != 1:
        raise ValueError(f"codes must be flat, got shape {tuple(q.shape)}")
    n_blocks = _check_block(q.shape[0], block)
    if tuple(scales.shape) != (n_blocks,):
        raise ValueError(f"scales must be ({n_blocks},), got "
                         f"{tuple(scales.shape)}")
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    if q.device.type == "cpu":
        return dequantize_blocks_plain(q, scales, block, dtype)
    if q.device.type != "cuda" or scales.device != q.device:
        raise ValueError(f"codes and scales must be on one CUDA device, got "
                         f"{q.device} and {scales.device}")
    if (q.dtype != torch.int8 or scales.dtype != torch.float32
            or not q.is_contiguous() or not scales.is_contiguous()
            or q.data_ptr() % 4):
        raise ValueError("codes must be contiguous 4-byte-aligned int8 and "
                         "scales contiguous float32")
    return _launch_dequantize(q, scales, n_blocks, block, dtype)


def _launch_dequantize(q: torch.Tensor, scales: torch.Tensor, n_blocks: int,
                       block: int, dtype: torch.dtype) -> torch.Tensor:
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    lib = _lib()
    rc = build.launch(lib.ckpt_dequantize_launch, q.device, q.data_ptr(),
                      scales.data_ptr(), out.data_ptr(),
                      int(dtype == torch.bfloat16), n_blocks, block)
    _raise_on(lib, rc, "dequantize_blocks")
    LAUNCHES["dequantize_blocks"] += 1
    CA.report_kernel(nbytes=CA.nbytes(q) + CA.nbytes(scales)
                     + CA.nbytes(out))
    return out
