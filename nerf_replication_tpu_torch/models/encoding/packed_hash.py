"""Cell-packed multiresolution hash grid (port of
``nerf_replication_tpu/models/encoding/packed_hash.py``), in plain PyTorch:
the JAX package has no Pallas kernel for it.

Each table row packs all 2^D corner values of one CELL (row width 2^D·C),
so the forward is one row gather per (point, level) and a blend of the
row's corners; cells do not share corners with their neighbours, so the
field is discontinuous at cell faces (a point on a face belongs to the cell
``floor(x·scale + 0.5)`` names, one fused multiply-add as in the jitted JAX
train step: ``hashgrid.level_terms``). The backward
(:class:`PackedHashFunction`) sums ``outer(w, g)`` rows into their buckets
with ``index_add_`` (``ops.histogram.indexed_row_sum``) and takes dx in
closed form.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from .hashgrid import (
    _PRIMES,
    _U32,
    _register_bbox,
    corner_weight,
    geometry_levels,
    init_table,
    level_terms,
    normalize_points,
    scale_factor,
)


def packed_level_geometry(
    input_dim: int,
    num_levels: int,
    per_level_scale: float,
    base_resolution: int,
    log2_hashmap_size: int,
):
    """Static per-level constants for the cell-packed layout.

    Returns (offsets [L+1], scales [L], n_cells [L], use_hash [L]): bucket
    offsets into the flat table, the float grid scale, cells per dim, and
    whether the level hashes its cell id.
    """
    corners = 1 << input_dim
    bucket_cap = max(2**log2_hashmap_size // corners, 1)
    offsets, scales, n_cells_l, use_hash = [0], [], [], []
    s = float(per_level_scale)
    for lvl in range(num_levels):
        scale = 2.0 ** (lvl * np.log2(s)) * base_resolution - 1.0
        # pos = x*scale + 0.5 in [0.5, scale+0.5] => cell ids 0..ceil(scale)
        n_cells = int(np.ceil(scale)) + 1
        dense_buckets = n_cells**input_dim
        hashed = dense_buckets > bucket_cap
        if hashed:
            buckets = max(int(bucket_cap / 8) * 8, 8)
        else:
            # round UP: rounding down would alias the top row-major cells
            # onto buckets 0..k via the modulo
            buckets = max(-(-dense_buckets // 8) * 8, 8)
        offsets.append(offsets[-1] + buckets)
        scales.append(float(scale))
        n_cells_l.append(n_cells)
        use_hash.append(hashed)
    return offsets, scales, n_cells_l, use_hash


def _cell_index(cell: torch.Tensor, n_cells: int, buckets: int,
                hashed: bool) -> torch.Tensor:
    """Bucket id (pre-offset, int64) of cells ``[..., D]`` (int64); dense
    row-major or XOR-prime hash, in uint32 arithmetic."""
    d = cell.shape[-1]
    index = torch.zeros(cell.shape[:-1], dtype=torch.int64, device=cell.device)
    if not hashed:
        stride = 1
        for dd in range(d):
            index = (index + ((cell[..., dd] & _U32) * stride & _U32)) & _U32
            stride = (stride * n_cells) & _U32
    else:
        for dd in range(d):
            index = index ^ ((cell[..., dd] & _U32) * _PRIMES[dd] & _U32)
    return index % buckets


def _cells_and_weights(x: torch.Tensor, scale: float):
    """cell ids [N, D] int64, corner weights [N, 2^D], frac [N, D]."""
    cell, frac = level_terms(x, scale)
    w = torch.stack([corner_weight(frac, bits)
                     for bits in range(1 << x.shape[-1])], -1)
    return cell, w, frac


def packed_forward(x: torch.Tensor, table: torch.Tensor, geometry,
                   gather_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x [N, D]`` → ``[N, L·C]``; rows gathered in ``gather_dtype``,
    positions, weights and the blend in float32."""
    x = x.to(torch.float32)
    n, d = x.shape
    corners = 1 << d
    c = table.shape[-1] // corners
    tab_g = table.to(gather_dtype)
    outs = []
    for off, buckets, scale, n_cells, hashed in geometry_levels(geometry):
        cell, w, _ = _cells_and_weights(x, scale)
        idx = _cell_index(cell, n_cells, buckets, hashed)
        vals = tab_g[idx + off].reshape(n, corners, c).to(torch.float32)
        outs.append(torch.sum(w[..., None] * vals, 1))
    return torch.cat(outs, -1)


def packed_backward(x: torch.Tensor, g: torch.Tensor, table: torch.Tensor,
                    geometry, gather_dtype: torch.dtype = torch.float32,
                    want_dx: bool = True):
    """``(dtable [T, 2^D·C] float32, dx [N, D] or None)``: per level the
    ``outer(w, g_l)`` rows summed into their buckets, and ``dx_d = Σ_l
    scale_l Σ_b sign_b(d) Π_{d'≠d} w_b(d') ⟨row_b, g_l⟩``."""
    from ...ops.histogram import indexed_row_sum

    x = x.to(torch.float32)
    g = g.to(torch.float32)
    n, d = x.shape
    corners = 1 << d
    c = table.shape[-1] // corners
    slices = []
    dx = torch.zeros((n, d), dtype=torch.float32, device=x.device) \
        if want_dx else None
    for lvl, (off, buckets, scale, n_cells, hashed) in enumerate(
            geometry_levels(geometry)):
        cell, w, frac = _cells_and_weights(x, scale)
        idx = _cell_index(cell, n_cells, buckets, hashed)
        g_l = g[:, lvl * c:(lvl + 1) * c]
        upd = (w[:, :, None] * g_l[:, None, :]).reshape(n, corners * c)
        slices.append(indexed_row_sum(idx, upd, buckets))
        if want_dx:
            vals = table.to(gather_dtype)[idx + off].reshape(
                n, corners, c).to(torch.float32)
            rowg = torch.sum(vals * g_l[:, None, :], -1)  # [N, 2^D]
            for dd in range(d):
                acc = torch.zeros(n, dtype=torch.float32, device=x.device)
                for bits in range(corners):
                    sign = 1.0 if (bits >> dd) & 1 else -1.0
                    acc = acc + sign * corner_weight(frac, bits, dd) \
                        * rowg[:, bits]
                dx[:, dd] += np.float32(scale) * acc
    return torch.cat(slices, 0), dx


class PackedHashFunction(torch.autograd.Function):
    """The packed encoder with its closed-form backward (no autodiff of the
    gather: ``index_add_`` for dtable, dx only when asked for)."""

    @staticmethod
    def forward(ctx, x, table, geometry, gather_dtype):
        ctx.geometry, ctx.gather_dtype = geometry, gather_dtype
        ctx.save_for_backward(x, table)
        return packed_forward(x, table, geometry, gather_dtype)

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        dtable, dx = packed_backward(x, g, table, ctx.geometry,
                                     ctx.gather_dtype,
                                     want_dx=ctx.needs_input_grad[0])
        return (dx, dtable.to(table.dtype) if ctx.needs_input_grad[1]
                else None, None, None)


def packed_hash_encode(x: torch.Tensor, table: torch.Tensor, input_dim: int,
                       num_levels: int, per_level_scale: float,
                       base_resolution: int, log2_hashmap_size: int,
                       gather_dtype: str = "float32") -> torch.Tensor:
    """``[..., D]`` in [0, 1] → ``[..., L·C]`` (the JAX signature), through
    :class:`PackedHashFunction`."""
    geometry = packed_level_geometry(input_dim, num_levels, per_level_scale,
                                     base_resolution, log2_hashmap_size)
    batch_shape = x.shape[:-1]
    out = PackedHashFunction.apply(
        x.reshape(-1, input_dim).to(torch.float32), table, geometry,
        getattr(torch, gather_dtype))
    return out.reshape(*batch_shape, out.shape[-1])


class PackedHashGridEncoder(nn.Module):
    """``nn.Module`` owning the cell-packed table ``embeddings [buckets,
    2^D·C]`` (uniform ±1e-4 from an explicit generator), with world-bounds
    normalization to [0, 1]. Same config knobs and out_dim as
    :class:`HashGridEncoder`."""

    def __init__(self, input_dim: int = 3, num_levels: int = 16,
                 level_dim: int = 2, per_level_scale: float = 2.0,
                 base_resolution: int = 16, log2_hashmap_size: int = 19,
                 desired_resolution: int = -1, bbox=None,
                 gather_dtype: str = "float32"):
        super().__init__()
        self.input_dim = int(input_dim)
        self.num_levels = int(num_levels)
        self.level_dim = int(level_dim)
        self.scale_factor = scale_factor(self.num_levels,
                                         float(per_level_scale),
                                         int(base_resolution),
                                         int(desired_resolution))
        self.gather_dtype = getattr(torch, str(gather_dtype))
        self.geometry = packed_level_geometry(
            self.input_dim, self.num_levels, self.scale_factor,
            int(base_resolution), int(log2_hashmap_size))
        self.embeddings = nn.Parameter(torch.zeros(
            self.geometry[0][-1], (1 << self.input_dim) * self.level_dim))
        _register_bbox(self, bbox)

    @property
    def out_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def n_buckets(self) -> int:
        return self.geometry[0][-1]

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_table(self.embeddings, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = normalize_points(self, x)
        batch_shape = x.shape[:-1]
        out = PackedHashFunction.apply(
            x.reshape(-1, self.input_dim).to(torch.float32), self.embeddings,
            self.geometry, self.gather_dtype)
        return out.reshape(*batch_shape, out.shape[-1])

    @classmethod
    def from_cfg(cls, enc_cfg, precision=None) -> "PackedHashGridEncoder":
        bbox = enc_cfg.get("bbox", None)
        if bbox is None:
            raise ValueError(
                "hashgrid_packed encoder config needs "
                "'bbox: [[lo...],[hi...]]' world bounds for [0,1] "
                "normalization"
            )
        # gather rows stay f32 unless pinned explicitly (``precision`` is
        # accepted and not consulted, as in the JAX package)
        del precision
        return cls(
            input_dim=int(enc_cfg.get("input_dim", 3)),
            num_levels=int(enc_cfg.get("num_levels", 16)),
            level_dim=int(enc_cfg.get("level_dim", 2)),
            per_level_scale=float(enc_cfg.get("per_level_scale", 2.0)),
            base_resolution=int(enc_cfg.get("base_resolution", 16)),
            log2_hashmap_size=int(enc_cfg.get("log2_hashmap_size", 19)),
            desired_resolution=int(enc_cfg.get("desired_resolution", -1)),
            bbox=bbox,
            gather_dtype=str(enc_cfg.get("gather_dtype", "float32")),
        )
