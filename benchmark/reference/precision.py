"""The precisions a reference product can be computed in.

``"float32"`` is the reference itself (IEEE float32 products; TF32 is
switched off by :func:`exact_float32`). The others emulate a lower
precision by rounding both operands of every product before an exact
float32 product: the controls that must fail the comparison. The rounding
passes gradients straight through, so a control's backward multiplies the
rounded operands by float32 gradients (no gradient is flushed to zero by
the narrow type's range).
"""

from __future__ import annotations

import torch


def exact_float32() -> None:
    """No TF32 in float32 products (PyTorch may use it on the card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away
    from zero), kept in float32."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _straight_through(rounded):
    def q(x: torch.Tensor) -> torch.Tensor:
        return x + (rounded(x.detach()) - x.detach())
    return q


OPERAND_ROUNDING = {
    "float32": _identity,
    "tf32": _straight_through(round_tf32),
    "bfloat16": _straight_through(
        lambda x: x.to(torch.bfloat16).to(torch.float32)),
    "fp8_e4m3": _straight_through(
        lambda x: x.to(torch.float8_e4m3fn).to(torch.float32)),
}


def operand_rounding(name: str):
    """The function that rounds a product's operands in precision
    ``name``."""
    try:
        return OPERAND_ROUNDING[name]
    except KeyError:
        raise ValueError(f"unknown precision {name!r}; one of "
                         f"{sorted(OPERAND_ROUNDING)}") from None


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           q=_identity) -> torch.Tensor:
    """``x @ weight.T + bias`` with both operands rounded by ``q`` and a
    float32 product."""
    return q(x) @ q(weight).t() + bias
