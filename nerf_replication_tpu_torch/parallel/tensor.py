"""Tensor-parallel seams over the model group: the collectives a column
split needs, as autograd functions, and the column-parallel layers.

This module has no JAX counterpart. Under GSPMD (``build_gspmd_step``) the
JAX package states only where each parameter lives (``parallel/sharding.py``
rules) and XLA derives the collectives that a column-split layer needs. The
port writes them out:

* :func:`gather_model` — the all-gather of each rank's column block along
  the last dimension over the model group, in model order; its backward
  hands each rank its own slice of the gradient (the downstream compute is
  replicated over the model group, so every rank holds the same full dY).
* :func:`copy_to_model` — the identity forward; its backward all-reduces
  (sums) the gradient over the model group: each rank's block contributes
  ``dY_blk @ W_blk`` to the input's gradient.
* :func:`column_parallel` — for the plain trunk (``network.nerf.fused_trunk
  false``): while the context is open, each listed ``Dense`` /
  ``SplitDense`` layer computes its own output columns from its weight
  block (``x @ W_blk.T + b_blk``, ``torch.matmul``: the JAX package computes
  these layers outside any Pallas kernel) and all-gathers the activations.

A block is ``ceil(n / M)`` rows (the last one shorter when ``M`` does not
divide ``n``), the ceiling the JAX shard byte count uses; the gathers pad
every block to that size. ``COUNTS`` / ``BYTES`` of ``parallel/collectives``
count these collectives too (kinds ``all_gather`` / ``all_reduce``).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.distributed as dist

from .collectives import _count


def block_range(n: int, mesh) -> tuple[int, int]:
    """``(start, length)`` of this rank's block of an ``n``-long dimension
    split over the model axis."""
    b = -(-int(n) // mesh.model)
    start = min(mesh.model_index * b, n)
    return start, max(0, min(b, n - start))


def block(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``."""
    start, length = block_range(x.shape[dim], mesh)
    return x.narrow(dim, start, length)


def pad_block(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``x`` zero-padded along ``dim`` to ``size``."""
    short = size - x.shape[dim]
    if short == 0:
        return x.contiguous()
    shape = list(x.shape)
    shape[dim] = short
    return torch.cat([x, x.new_zeros(shape)], dim)


def gather_blocks(x: torch.Tensor, mesh, dim: int, n: int) -> torch.Tensor:
    """The full ``n``-long dimension ``dim`` from every rank's block ``x``
    (an all-gather over the model group, no autograd)."""
    b = -(-int(n) // mesh.model)
    src = pad_block(x, dim, b)
    _count("all_gather", src)
    parts = [torch.empty_like(src) for _ in range(mesh.model)]
    dist.all_gather(parts, src, group=mesh.model_group)
    return torch.cat(parts, dim).narrow(dim, 0, n)


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, n):
        ctx.mesh = mesh
        return gather_blocks(x, mesh, x.dim() - 1, n)

    @staticmethod
    def backward(ctx, g):
        return block(g, ctx.mesh, g.dim() - 1).contiguous(), None, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _count("all_reduce", g)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.mesh.model_group)
        return g, None


def gather_model(x: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """All-gather of the last dimension's blocks (``n`` long in all) over
    the model group; backward: this rank's slice."""
    return _GatherModel.apply(x, mesh, int(n))


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Identity; backward: the all-reduce (sum) over the model group."""
    return _CopyToModel.apply(x, mesh)


def _column_forward(layer, w_blk, b_blk, mesh):
    """The forward of ``layer`` (``Dense`` or ``SplitDense``) on its
    blocks, gathered."""
    n_out = layer.weight.shape[0]
    c1 = getattr(layer, "c1", None)

    if c1 is None:
        def forward(x, dtype=torch.float32):
            y = (copy_to_model(x, mesh).to(dtype) @ w_blk.to(dtype).T
                 + b_blk.to(dtype))
            return gather_model(y, mesh, n_out)
    else:
        def forward(x1, x2, dtype=torch.float32):
            w = w_blk.to(dtype)
            y = (copy_to_model(x1, mesh).to(dtype) @ w[:, :c1].T
                 + copy_to_model(x2, mesh).to(dtype) @ w[:, c1:].T
                 + b_blk.to(dtype))
            return gather_model(y, mesh, n_out)
    return forward


@contextmanager
def column_parallel(layers, mesh):
    """Run each ``(layer, weight_block, bias_block)`` of ``layers``
    column-parallel while the context is open (an instance ``forward``,
    taken away on exit: outside it the layer computes on its full weights,
    as validation and checkpoints want)."""
    for layer, w_blk, b_blk in layers:
        layer.forward = _column_forward(layer, w_blk, b_blk, mesh)
    try:
        yield
    finally:
        for layer, _, _ in layers:
            del layer.forward
