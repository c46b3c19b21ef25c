"""The reference's weight products, in float32 or a lower precision.

``float32``: a plain float32 product with TF32 off.  ``fp8``: the control
(the precision below the configuration's bfloat16): both operands rounded
to float8 e4m3 with one scale a tensor (its largest magnitude over 448,
the format's largest finite value), the product then taken in float32,
as an fp8 matrix unit accumulates in float32.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0
MODES = ("float32", "fp8")


def strict_float32() -> None:
    """Float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under a per-tensor scale, back in float32
    (under autograd the rounding passes the gradient straight through)."""
    t = t.float()
    with torch.no_grad():
        amax = t.abs().amax()
        scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
        q = (t / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach() if t.requires_grad else q


class Products:
    def __init__(self, mode: str = "float32"):
        if mode not in MODES:
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode
        strict_float32()

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """(..., k) @ (k, n) in this precision, float32 out."""
        a, w = a.float(), w.float()
        if self.mode == "fp8":
            a, w = to_fp8(a), to_fp8(w)
        return a @ w
