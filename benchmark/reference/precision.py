"""The precisions the reference computes in.

``float64`` is the reference itself. ``tf32`` is its control: float32
arithmetic whose every product takes operands rounded to TF32 (10 explicit
mantissa bits, to nearest, ties away from zero, as ``cvt.rna.tf32.f32``), the
step below the configurations' exact float32 with TF32 off. The rounding is
explicit, so the control is the same on the CPU and on the card. ``float32``
is the program's own precision, in which the planted faults run.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32, still stored as float32."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _RoundTf32(torch.autograd.Function):
    """Rounds its input to TF32, and the gradient it passes back too."""

    @staticmethod
    def forward(ctx, t):
        return round_tf32(t)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


class Precision(NamedTuple):
    name: str
    dtype: torch.dtype

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as an operand of a product (matmul or convolution)."""
        t = t.to(self.dtype)
        return _RoundTf32.apply(t) if self.name == "tf32" else t


PRECISIONS = {
    "float64": Precision("float64", torch.float64),
    "float32": Precision("float32", torch.float32),
    "tf32": Precision("tf32", torch.float32),
}
