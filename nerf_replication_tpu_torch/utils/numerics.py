"""Correctly rounded float32 square roots and 3-vector norms.

``torch.sqrt`` on float32 CPU tensors is not correctly rounded in every
PyTorch build: its vectorised CPU kernels can land one ulp off IEEE
``sqrt``, and ``torch.linalg.norm`` sums and rounds in its own order. The
JAX package, numpy and the CUDA kernels (``__fsqrt_rn``) all round a float32
sqrt once. The plain versions that are held to them bitwise (the march
distances, the view directions) go through these helpers instead.

``sqrt_rn`` takes the root in float64 and rounds it to float32: a float64
root of a float32 value rounded to float32 is the correctly rounded float32
root (53 ≥ 2·24 + 2 bits, so the double rounding is harmless).
"""

from __future__ import annotations

import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 ``sqrt(x)`` rounded once (IEEE round to nearest even)."""
    return torch.sqrt(x.double()).to(x.dtype)


def sq_norm3(d: torch.Tensor) -> torch.Tensor:
    """``x² + y² + z²`` over the last axis of ``d [..., 3]``, summed left to
    right with each product and sum rounded."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def norm3_rn(d: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """‖d‖ over the last axis of ``d [..., 3]``: :func:`sq_norm3`, then
    :func:`sqrt_rn`."""
    n = sqrt_rn(sq_norm3(d))
    return n[..., None] if keepdim else n
