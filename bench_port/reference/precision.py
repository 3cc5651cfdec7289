"""The arithmetic of the plain reference and of its lower-precision control.

Every matrix product, convolution and attention product of the reference
goes through one ``Precision``. ``EXACT`` computes in float32 with TF32 off
(the reference proper). ``Rounded(dtype)`` first rounds both operands to
``dtype`` and then computes in float32: the control, which puts the
reference in the program's place one precision step below what the
configuration states (float8 e4m3 with a per-tensor scale where the program
computes in bfloat16, bfloat16 where it computes in float32 on cuDNN's
default TF32 convolutions).

Imports nothing of the program.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and cuDNN convolutions inside the block, and the
    flags as they were afterwards (the program runs with the defaults)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Precision:
    """float32 arithmetic; subclasses round the operands first."""

    name = "float32"

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return x.float()

    def linear(self, x, w, b=None):
        return F.linear(self.round(x), self.round(w), None if b is None else b.float())

    def matmul(self, a, b):
        return self.round(a) @ self.round(b)

    def conv2d(self, x, w, b=None, **kw):
        return F.conv2d(self.round(x), self.round(w), None if b is None else b.float(), **kw)

    def conv_transpose2d(self, x, w, b=None, **kw):
        return F.conv_transpose2d(self.round(x), self.round(w), None if b is None else b.float(), **kw)


class Rounded(Precision):
    """Operands rounded to ``dtype`` (float8 with a per-tensor scale that
    maps the largest magnitude to the format's largest finite value)."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.name = str(dtype).split(".")[-1]

    def round(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.dtype == torch.float8_e4m3fn:
            scale = x.abs().amax().clamp_min(1e-30) / _E4M3_MAX
            return (x / scale).to(self.dtype).float() * scale
        return x.to(self.dtype).float()


EXACT = Precision()


def control_precisions():
    """(model precision, matting precision) of the control: one step below
    the bfloat16 encoder and decoder, and below the float32 (TF32 by
    default) u2net."""
    return Rounded(torch.float8_e4m3fn), Rounded(torch.bfloat16)
