"""The multiresolution hash encoder: kernels K6 (forward) and K6b (backward)
and their plain versions.

Port of ``nerf_replication_tpu/models/encoding/pallas_hash.py``. One TPU
kernel becomes two hand-written CUDA kernels (``csrc/hash_encode.cu``), each
beside a plain PyTorch version of the same function:

* **K6**, :func:`hash_encode_fwd` (replaces ``_hash_kernel``,
  pallas_hash.py:102, launched through ``_squeeze_page_kernel`` :229): ``x
  [N, D]`` in [0, 1], ``table [T, C]`` → ``out [N, L·C]`` in the JAX concat
  layout (``out[:, l·C + c]``); plain version :func:`forward_plain`. On the
  TPU the kernel never lowered (Mosaic rejects its in-kernel gather), so the
  JAX package runs the XLA ``hash_encode``; on Hopper the gather is native
  and K6 is the encoder of the main path.
* **K6b**, :func:`hash_encode_bwd`: ``dtable [T, C]`` (the ``atomicAdd``
  scatter of ``w·g`` that the reference CUDA encoder had; the JAX package
  reaches the same sums through a sort-based histogram, because the TPU's
  scatter is slow) and, when asked for, ``dx [N, D]`` in closed form; plain
  version :func:`backward_plain` (``index_add_``). The JAX package has no
  backward kernel: its VJP is XLA.

``dtable`` from K6b is NOT deterministic run to run: float32 atomics add
the same terms in another order each launch. :class:`HashEncodeFunction`
ties the two into autograd. A wrapper runs the plain version for tensors on
the CPU and the kernel for tensors on a card, with no fallback from one to
the other; each launch adds one to :data:`LAUNCHES`.

The descriptor of a level (scale, resolution, hashed flag, slice offset and
size) comes from ``hashgrid.level_geometry`` and travels to the kernel by
value (:class:`HashDescC`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.encoding.hashgrid import (
    _corner_index,
    corner_weight,
    geometry_levels,
    level_terms,
)

# kernel launches per wrapper since the last reset
LAUNCHES: dict[str, int] = {"hash_encode_fwd": 0, "hash_encode_bwd": 0}

MAX_LEVELS = 32  # NRT_HASH_MAX_LEVELS of csrc/hash_encode.cu
KERNEL_DIMS = (2, 3, 4)
KERNEL_FEATURES = (1, 2, 4, 8)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _corners(pos_grid: torch.Tensor, corner_bits: int) -> torch.Tensor:
    d = pos_grid.shape[-1]
    sel = [(corner_bits >> dd) & 1 for dd in range(d)]
    return pos_grid + torch.tensor(sel, dtype=torch.int64,
                                   device=pos_grid.device)


def forward_plain(x: torch.Tensor, table: torch.Tensor,
                  geometry) -> torch.Tensor:
    """The plain version of K6: ``x [N, D]`` → ``[N, L·C]`` float32. Per
    level the 2^D corners in JAX's order, each corner's ``w·row`` added to
    the running sum."""
    x = x.to(torch.float32)
    outs = []
    for off, size, scale, res, hashed in geometry_levels(geometry):
        pos_grid, frac = level_terms(x, scale)
        acc = None
        for bits in range(1 << x.shape[-1]):
            idx = _corner_index(_corners(pos_grid, bits), res, size, hashed)
            contrib = corner_weight(frac, bits)[:, None] * table[idx + off]
            acc = contrib if acc is None else acc + contrib
        outs.append(acc)
    return torch.cat(outs, -1)


def backward_plain(x: torch.Tensor, g: torch.Tensor, table: torch.Tensor,
                   geometry, want_dx: bool = True,
                   accum: torch.dtype = torch.float32):
    """The plain version of K6b: ``(dtable [T, C], dx [N, D] or None)``
    under the cotangent ``g [N, L·C]``. ``dtable`` sums ``w·g`` into each
    corner's row (``index_add_``); ``dx_d = Σ_l scale_l Σ_b sign_b(d)
    Π_{d'≠d} w_b(d') ⟨row_b, g_l⟩``. ``accum=torch.float64`` takes the
    weights (from the float32 positions), the products and the sums in
    float64: the reference the kernel's float32 atomics are held to."""
    x = x.to(torch.float32)
    g = g.to(accum)
    n, d = x.shape
    c = table.shape[-1]
    dtable = torch.zeros(table.shape, dtype=accum, device=x.device)
    dx = torch.zeros((n, d), dtype=accum, device=x.device) \
        if want_dx else None
    for lvl, (off, size, scale, res, hashed) in enumerate(geometry_levels(geometry)):
        pos_grid, frac = level_terms(x, scale)
        frac = frac.to(accum)
        g_l = g[:, lvl * c:(lvl + 1) * c]
        rowg = []
        for bits in range(1 << d):
            idx = _corner_index(_corners(pos_grid, bits), res, size,
                                hashed) + off
            dtable.index_add_(0, idx, corner_weight(frac, bits)[:, None]
                              * g_l)
            if want_dx:
                rowg.append(torch.sum(table[idx].to(accum) * g_l, -1))
        if want_dx:
            for dd in range(d):
                acc = torch.zeros(n, dtype=accum, device=x.device)
                for bits in range(1 << d):
                    sign = 1.0 if (bits >> dd) & 1 else -1.0
                    acc = acc + sign * corner_weight(frac, bits, dd) \
                        * rowg[bits]
                dx[:, dd] += np.float32(scale) * acc
    return dtable, dx


def touched_rows(x: torch.Tensor, geometry) -> int:
    """How many distinct table rows the corners of points ``x`` reach (the
    table bytes an encode of ``x`` must read at least once)."""
    x = x.to(torch.float32)
    rows = []
    for off, size, scale, res, hashed in geometry_levels(geometry):
        pos_grid, _ = level_terms(x, scale)
        rows += [_corner_index(_corners(pos_grid, bits), res, size, hashed)
                 + off for bits in range(1 << x.shape[-1])]
    return int(torch.unique(torch.cat(rows)).numel())


class HashDescC(ctypes.Structure):
    """``struct HashDesc`` of ``csrc/hash_encode.cu`` (passed by value)."""

    _fields_ = [
        ("levels", ctypes.c_int),
        ("scale", ctypes.c_float * MAX_LEVELS),
        ("resolution", ctypes.c_uint * MAX_LEVELS),
        ("hashed", ctypes.c_uint * MAX_LEVELS),
        ("offset", ctypes.c_uint * MAX_LEVELS),
        ("size", ctypes.c_uint * MAX_LEVELS),
    ]


_DESCS: dict = {}


def _desc(geometry) -> HashDescC:
    """The kernels' level descriptor, built once per geometry."""
    key = tuple(map(tuple, geometry))
    desc = _DESCS.get(key)
    if desc is None:
        desc = _DESCS[key] = _make_desc(geometry)
    return desc


def _make_desc(geometry) -> HashDescC:
    levels = geometry_levels(geometry)
    desc = HashDescC()
    desc.levels = len(levels)
    for lvl, (off, size, scale, res, hashed) in enumerate(levels):
        desc.scale[lvl] = float(np.float32(scale))
        desc.resolution[lvl] = int(res)
        desc.hashed[lvl] = int(bool(hashed))
        desc.offset[lvl] = int(off)
        desc.size[lvl] = int(size)
    return desc


def _check(x: torch.Tensor, table: torch.Tensor, geometry) -> None:
    n_levels = len(geometry[1])
    if x.dim() != 2 or table.dim() != 2:
        raise ValueError(f"x must be [N, D] and table [T, C], got "
                         f"{tuple(x.shape)} and {tuple(table.shape)}")
    if table.shape[0] != geometry[0][-1]:
        raise ValueError(f"table has {table.shape[0]} rows, the geometry "
                         f"{geometry[0][-1]}")
    if table.device != x.device:
        raise ValueError(f"x on {x.device}, table on {table.device}")
    if x.device.type == "cpu":
        return
    d, c = x.shape[1], table.shape[1]
    if d not in KERNEL_DIMS or c not in KERNEL_FEATURES or \
            n_levels > MAX_LEVELS:
        raise ValueError(
            f"the hash-encode kernels take D in {KERNEL_DIMS}, C in "
            f"{KERNEL_FEATURES} and at most {MAX_LEVELS} levels; got D={d}, "
            f"C={c}, L={n_levels}")
    if x.dtype != torch.float32 or table.dtype != torch.float32:
        raise ValueError("the hash-encode kernels take float32 x and table")


def hash_encode_fwd(x: torch.Tensor, table: torch.Tensor,
                    geometry) -> torch.Tensor:
    """K6: ``[N, L·C]`` float32 features of ``x [N, D]``. The plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    _check(x, table, geometry)
    if x.device.type == "cpu":
        return forward_plain(x, table, geometry)
    from .kernels import _ptr, _raise_on, _stream, load

    x, table = x.contiguous(), table.contiguous()
    n, c = x.shape[0], table.shape[1]
    out = torch.empty((n, len(geometry[1]) * c), dtype=torch.float32,
                      device=x.device)
    if n == 0:
        return out
    lib = load("hash_encode")
    err = lib.nrt_hash_encode_fwd(_ptr(x), n, x.shape[1], _ptr(table), c,
                                  ctypes.byref(_desc(geometry)), _ptr(out),
                                  _stream(x.device))
    _raise_on(lib, err, "hash_encode_fwd")
    LAUNCHES["hash_encode_fwd"] += 1
    return out


def hash_encode_bwd(x: torch.Tensor, g: torch.Tensor, table: torch.Tensor,
                    geometry, want_dx: bool = False):
    """K6b: ``(dtable [T, C] float32, dx [N, D] or None)``. ``table`` is
    read only for ``dx``; ``dtable`` has its shape. The plain version for
    CPU tensors, the CUDA kernel for CUDA tensors (``dtable``
    nondeterministic: float32 atomics)."""
    _check(x, table, geometry)
    n_feat = len(geometry[1]) * table.shape[1]
    if g.shape != (x.shape[0], n_feat) or g.device != x.device:
        raise ValueError(f"g must be [{x.shape[0]}, {n_feat}] on {x.device}")
    if x.device.type == "cpu":
        return backward_plain(x, g, table, geometry, want_dx)
    from .kernels import _ptr, _raise_on, _stream, load

    x, table = x.contiguous(), table.contiguous()
    g = g.to(torch.float32).contiguous()
    n = x.shape[0]
    dtable = torch.zeros(table.shape, dtype=torch.float32, device=x.device)
    dx = torch.empty((n, x.shape[1]), dtype=torch.float32, device=x.device) \
        if want_dx else None
    if n == 0:
        return dtable, dx
    lib = load("hash_encode")
    err = lib.nrt_hash_encode_bwd(_ptr(x), n, x.shape[1], _ptr(table),
                                  table.shape[1], ctypes.byref(_desc(geometry)),
                                  _ptr(g), _ptr(dtable), _ptr(dx),
                                  _stream(x.device))
    _raise_on(lib, err, "hash_encode_bwd")
    LAUNCHES["hash_encode_bwd"] += 1
    return dtable, dx


class HashEncodeFunction(torch.autograd.Function):
    """``out = encode(x, table)`` whose forward is K6 and whose backward is
    K6b. dx is computed only when autograd asks for it (march and render
    points are data: the train step never does)."""

    @staticmethod
    def forward(ctx, x, table, geometry):
        ctx.geometry = geometry
        ctx.save_for_backward(x, table)
        return hash_encode_fwd(x, table, geometry)

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        dtable, dx = hash_encode_bwd(x, g, table, ctx.geometry,
                                     want_dx=ctx.needs_input_grad[0])
        return dx, dtable if ctx.needs_input_grad[1] else None, None


def encode(x: torch.Tensor, table: torch.Tensor, geometry) -> torch.Tensor:
    """``[..., D]`` points in [0, 1] → ``[..., L·C]`` through
    :class:`HashEncodeFunction` (rows flattened around the call)."""
    batch_shape = x.shape[:-1]
    out = HashEncodeFunction.apply(
        x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous(), table,
        geometry)
    return out.reshape(*batch_shape, out.shape[-1])
