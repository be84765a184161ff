"""Rounding of operands, as a precision profile states it.

The configurations state two precisions: the learned iterations' products
in bfloat16 (operands rounded, float32 sums) and everything else in float32
with no TF32.  The reference applies them with ``low`` (the bf16 operands)
and ``f32`` (the float32 operands).  The control is the same reference one
step lower: fp8 (e4m3, scaled by the tensor's largest magnitude, as an fp8
kernel scales its operands) in place of bf16, TF32 (10-bit mantissa,
rounded to nearest even) in place of float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

F8_MAX = 448.0   # largest finite float8_e4m3fn


def _through(a: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The rounded value ``r`` forward, the identity backward: the
    reference differentiates the stated forward in float32."""
    a = a.to(torch.float32)
    return a + (r - a).detach() if a.requires_grad else r


def ident(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float32)


def bf16(a: torch.Tensor) -> torch.Tensor:
    return _through(a, a.detach().to(torch.bfloat16).to(torch.float32))


def fp8(a: torch.Tensor) -> torch.Tensor:
    d = a.detach().to(torch.float32)
    s = d.abs().amax().clamp_min(1e-30) / F8_MAX
    return _through(a, (d / s).to(torch.float8_e4m3fn).to(torch.float32) * s)


def tf32(a: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10-bit mantissa, to nearest even."""
    d = a.detach().to(torch.float32).contiguous()
    i = d.view(torch.int32)
    r = ((i + (0x0FFF + ((i >> 13) & 1))) & -0x2000).view(torch.float32)
    return _through(a, torch.where(torch.isfinite(d), r, d))


@dataclasses.dataclass(frozen=True)
class Precision:
    """``low`` rounds the operands the profile states in bf16, ``f32`` those
    it states in float32."""
    low: Callable
    f32: Callable
    name: str


def profile(name: str) -> Precision:
    """'reference': bf16 / float32, as the configurations state;
    'control': fp8 / TF32, the reference one step lower."""
    if name == "reference":
        return Precision(bf16, ident, name)
    if name == "control":
        return Precision(fp8, tf32, name)
    raise ValueError(f"unknown precision profile {name!r}")


@contextlib.contextmanager
def no_tf32():
    """Float32 products in full float32 on the card."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
