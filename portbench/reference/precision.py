"""The precision the reference computes its products in.

"float32" is what the configurations state: full float32 products, TF32 off.
"tf32" is the control's: each operand of a product rounded to TF32's 10-bit
significand (to nearest, ties to even), as the tensor cores read them, with
the products exact and the sums in float32. It is written out rather than
left to a backend switch, so that it reads the same on every device and in
every product, the matrix-vector ones included.
"""
from __future__ import annotations

import torch

PRECISIONS = ("float32", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """`x` (float32) rounded to the nearest TF32 value, held in float32."""
    bits = x.contiguous().view(torch.int32)
    # round to nearest even on the 13 dropped bits, then clear them
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    out = rounded.view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def set_full_float32():
    """Products in full float32 in every library call the reference makes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).transpose(-1, -2), round_tf32(a).transpose(-1, -2) @ g


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return a @ b
    if precision == "tf32":
        return _TF32MatMul.apply(a, b)
    raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """An operand as a product in `precision` reads it."""
    return round_tf32(x) if precision == "tf32" else x
