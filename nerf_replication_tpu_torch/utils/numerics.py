"""Correctly rounded float32 square roots and 3-vector norms; a capturable
cumulative product.

``torch.sqrt`` on float32 CPU tensors is not correctly rounded in every
PyTorch build: its vectorised CPU kernels can land one ulp off IEEE
``sqrt``, and ``torch.linalg.norm`` sums and rounds in its own order. The
JAX package, numpy and the CUDA kernels (``__fsqrt_rn``) all round a float32
sqrt once. The plain versions that are held to them bitwise (the march
distances, the view directions) go through these helpers instead.

``sqrt_rn`` takes the root in float64 and rounds it to float32: a float64
root of a float32 value rounded to float32 is the correctly rounded float32
root (53 ≥ 2·24 + 2 bits, so the double rounding is harmless).

``cumprod`` is ``torch.cumprod`` along the last axis with a backward that
the card runs without asking the host anything, so that a train step can
be captured in a CUDA graph (the compositing transmittances).

``prefix_sum`` is ``torch.cumsum`` along the last axis whose additions come
in an order fixed by the shape, run after run (the packed march's float64
stream sums; the CPU and the card each take theirs): a 1-D float
``torch.cumsum`` on CUDA is CUB's single-pass scan, whose decoupled
look-back takes a predecessor tile's inclusive prefix or adds up its
aggregates as timing has it, so two runs can differ in the last bit (a
200×200 packed view: a few rays a float32 ulp apart).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


class _Cumprod(torch.autograd.Function):
    """``torch.cumprod(x, -1)`` with a backward that never reads a device
    value on the host. ``torch.cumprod``'s own backward asks the host
    whether ``x`` holds a zero (a synchronisation, which a step captured in
    a CUDA graph cannot make); this one computes both cases on the card and
    picks per element: before a row's first zero ``rev_cumsum(g·y) / x``,
    at it ``rev_cumsum(g·y')`` with ``y'`` the product over the row with
    that zero taken as 1, after it 0."""

    @staticmethod
    def forward(ctx, x):
        y = torch.cumprod(x, -1)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors

        def rev_cumsum(t):
            return torch.flip(torch.cumsum(torch.flip(t, [-1]), -1), [-1])

        zero = x == 0
        n_zero = torch.cumsum(zero.to(torch.int32), -1)
        first = zero & (n_zero == 1)
        one = torch.ones_like(x)
        plain = rev_cumsum(g * y) / torch.where(zero, one, x)
        at_zero = rev_cumsum(g * torch.cumprod(torch.where(first, one, x), -1))
        return torch.where(n_zero == 0, plain,
                           torch.where(first, at_zero, torch.zeros_like(x)))


def cumprod(x: torch.Tensor) -> torch.Tensor:
    """``torch.cumprod(x, -1)`` (the same forward) whose gradient needs no
    host synchronisation (:class:`_Cumprod`)."""
    return _Cumprod.apply(x)


# row length of prefix_sum's blocked scan
SCAN_ROW = 1024


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of ``x [..., n]`` along its last axis: each
    series cut into rows of ``SCAN_ROW`` (at least two), each row scanned,
    plus the prefix of the earlier rows' totals, taken the same way over
    the series and a zero series. A scan along the inner axis of a tensor
    that holds more than one row takes PyTorch's per-row kernel, which adds
    in an order fixed by the shape; only a tensor that is a single row goes
    to the 1-D scan."""
    lead, n = x.shape[:-1], x.shape[-1]
    rows = max(2, -(-n // SCAN_ROW))
    inner = torch.cumsum(F.pad(x, (0, rows * SCAN_ROW - n))
                         .reshape(*lead, rows, SCAN_ROW), -1)
    before = F.pad(inner[..., :-1, -1], (1, 0)).reshape(-1, rows)
    offset = torch.cumsum(torch.cat([before, torch.zeros_like(before[:1])]),
                          -1)[:-1]
    return (inner + offset.reshape(*lead, rows, 1)).reshape(
        *lead, rows * SCAN_ROW)[..., :n]
