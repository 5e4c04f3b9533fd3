"""The precision of the reference's contractions: every convolution and
matrix product of the towers and the FC heads takes its operands through
``contract``. "float32" leaves them as they are; "float8" rounds each
operand to float8 e4m3 under a per-tensor scale (its largest magnitude
to 448, the format's largest finite value), the step below the
configuration's bfloat16 that the benchmark's control takes;
"bfloat16" rounds each operand to bfloat16, the configuration's own
precision, as a witness of what its rounding alone moves. The products
and sums stay float32 (TF32 off). In a backward pass ``product`` rounds
the gradient that reaches a contraction's output the same way, so the
operands of the backward's contractions are of the precision too."""
from __future__ import annotations

import torch

PRECISIONS = ("float32", "float8", "bfloat16")
E4M3_MAX = 448.0


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """The float32 values of ``x`` rounded to ``precision``."""
    if precision == "float32":
        return x
    if precision == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    if precision != "float8":
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    amax = x.abs().amax()
    scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def contract(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` in float32 as an operand of a contraction at ``precision``."""
    x = x.to(torch.float32)
    if precision == "float32":
        return x
    # straight-through: the rounding has no gradient of its own
    return x + (rounded(x.detach(), precision) - x).detach()


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, precision):
        ctx.precision = precision
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return rounded(g.to(torch.float32), ctx.precision), None


def product(y: torch.Tensor, precision: str) -> torch.Tensor:
    """A contraction's output ``y``, unchanged; in the backward, the
    gradient that reaches it rounded to ``precision``."""
    if precision == "float32" or not y.requires_grad:
        return y
    return _RoundGrad.apply(y, precision)
