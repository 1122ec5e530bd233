"""Multiresolution hash-grid encoder (port of
``nerf_replication_tpu/models/encoding/hashgrid.py``).

* :func:`normalize_bbox` is the JAX package's, its division by the bbox
  extent taken as XLA takes it in the jitted step (a product with the
  float32 reciprocal).
* :func:`level_geometry` is copied: per-level ``scale = 2^(l·log2 s)·H −
  1``, ``resolution = ceil(scale) + 1``, a table slice of
  ``min(2^log2_hashmap_size, (ceil(H·s^l) + 1)^D)`` entries rounded DOWN to
  a multiple of 8 — the quirk that makes nearly every level hash, level 0
  included unless ``(res + 1)^D`` is itself a multiple of 8.
* :func:`_corner_index` is the dense row-major or XOR-prime index of a
  corner, in uint32 arithmetic: int64 tensors masked to 32 bits after every
  multiply and xor, then ``% slice_size``.
* :func:`hash_encode` is the JAX signature over the plain PyTorch version
  of the encoder (``ops.hash_encode.forward_plain``, the function kernel K6
  computes): per level ``pos = x·scale + 0.5`` as one fused multiply-add
  (:func:`level_terms`) — XLA on the CPU contracts it inside the jitted JAX
  train step and renders (measured on lego_hash's geometry with runtime
  inputs; JAX run eagerly, or on inputs XLA constant-folds, rounds twice,
  an ulp of ``pos`` apart) — then the 2^D corners in JAX's order
  (``corner_bits`` 0 … 2^D − 1), each weight the product of the
  per-dimension factors in dimension order, each corner's contribution
  ``w·row`` added to the running sum.
* :class:`HashGridEncoder` owns the ``[T, C]`` table (``embeddings``) and
  normalizes world points into [0, 1] by the scene bbox. Its forward goes
  through ``ops.hash_encode.HashEncodeFunction``: kernel K6 forward and K6b
  backward on the card, the plain versions on the CPU. ``custom_bwd`` (the
  JAX package's choice between two XLA backwards) selects nothing here.
* Every clip is :func:`clip`, ``minimum(maximum(x, lo), hi)`` as
  ``jnp.clip`` is spelled: at a tie (``x == lo`` or ``x == hi``) both
  libraries hand half the gradient through, where ``torch.clamp`` hands
  all of it. The values are the same either way; the gradient with respect
  to a point (the deformation encoders' warped points) is the JAX one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

# fast_hash primes (hashencoder.cu:43); 1 for dim 0 keeps memory coherence
_PRIMES = (1, 19349663, 83492791, 25165843, 6291469, 12582917, 3145739)
_U32 = 0xFFFFFFFF


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, whose gradient at a
    tie is 0.5 (``torch.clamp`` passes 1). ``lo``/``hi``: tensors, or
    Python floats (made on ``x``'s device by a fill)."""
    if not torch.is_tensor(lo):
        lo = x.new_full((), float(lo))
    if not torch.is_tensor(hi):
        hi = x.new_full((), float(hi))
    return torch.minimum(torch.maximum(x, lo), hi)


def normalize_bbox(x: torch.Tensor, bbox) -> torch.Tensor:
    """Clip to world bounds and scale into [0, 1] by the LARGEST extent
    (the one convention every encoder in the family shares). The division
    by the constant extent is a product with its float32 reciprocal, as
    XLA evaluates it inside the jitted JAX step."""
    lo = torch.as_tensor(bbox[0], dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(bbox[1], dtype=x.dtype, device=x.device)
    return (clip(x, lo, hi) - lo) * _inv_extent(lo, hi)


def _inv_extent(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return 1.0 / (torch.max(hi - lo) + 1e-6)


def level_geometry(
    input_dim: int,
    num_levels: int,
    per_level_scale: float,
    base_resolution: int,
    log2_hashmap_size: int,
):
    """Static per-level constants.

    Returns (offsets [L+1], scales [L], resolutions [L], use_hash [L]):
    table-slice offsets in entries, the float grid scale, the corner-grid
    resolution, and whether the level indexes by hash.
    """
    max_params = 2**log2_hashmap_size
    offsets, scales, resolutions, use_hash = [0], [], [], []
    s = float(per_level_scale)
    for lvl in range(num_levels):
        # allocation-side resolution (hashgrid.py:167-171)
        res_alloc = int(np.ceil(base_resolution * s**lvl))
        params_in_level = min(max_params, (res_alloc + 1) ** input_dim)
        params_in_level = int(params_in_level / 8) * 8
        offsets.append(offsets[-1] + params_in_level)

        # kernel-side geometry (hashencoder.cu:101-102)
        scale = 2.0 ** (lvl * np.log2(s)) * base_resolution - 1.0
        resolution = int(np.ceil(scale)) + 1
        scales.append(float(scale))
        resolutions.append(resolution)
        # dense iff the full corner grid fits the slice (cu:61-68 semantics)
        use_hash.append((resolution + 1) ** input_dim > params_in_level)
    return offsets, scales, resolutions, use_hash


def scale_factor(num_levels: int, per_level_scale: float,
                 base_resolution: int, desired_resolution: int) -> float:
    """The per-level scale: ``desired_resolution`` (the finest level's)
    overrides ``per_level_scale`` when set."""
    if desired_resolution != -1:
        return float(2.0 ** (np.log2(desired_resolution / base_resolution)
                             / (num_levels - 1)))
    return float(per_level_scale)


def _corner_index(corner: torch.Tensor, resolution: int, hashmap_size: int,
                  hashed: bool) -> torch.Tensor:
    """Table index (pre-offset, int64) of corners ``[..., D]`` (int64) of one
    level: dense row-major or XOR-prime hash, in uint32 arithmetic."""
    d = corner.shape[-1]
    index = torch.zeros(corner.shape[:-1], dtype=torch.int64,
                        device=corner.device)
    if not hashed:
        # row-major: sum_d corner_d * (resolution+1)^d  (cu:61-65)
        stride = 1
        for dd in range(d):
            index = (index + ((corner[..., dd] & _U32) * stride & _U32)) & _U32
            stride = (stride * (resolution + 1)) & _U32
    else:
        for dd in range(d):
            index = index ^ ((corner[..., dd] & _U32) * _PRIMES[dd] & _U32)
    return index % hashmap_size


def geometry_levels(geometry):
    """``(offset, size, scale, resolution or cells, hashed)`` of every level
    of a ``level_geometry`` (or ``packed_level_geometry``) result."""
    offsets, scales, resolutions, use_hash = geometry
    return [(offsets[lvl], offsets[lvl + 1] - offsets[lvl], scales[lvl],
             resolutions[lvl], use_hash[lvl]) for lvl in range(len(scales))]


@torch.no_grad()
def init_table(table: torch.Tensor, generator: torch.Generator) -> None:
    """Uniform ±1e-4 (hashgrid.py:184-186), drawn from ``generator``."""
    t = torch.rand(table.shape, generator=generator, dtype=torch.float32)
    table.copy_(t * 2e-4 - 1e-4)


def hash_encode(x: torch.Tensor, table: torch.Tensor, input_dim: int,
                num_levels: int, per_level_scale: float,
                base_resolution: int, log2_hashmap_size: int) -> torch.Tensor:
    """``[..., D]`` in [0, 1] → ``[..., L·C]``, the JAX signature over the
    plain version of kernel K6 (``ops.hash_encode.forward_plain``)."""
    from ...ops.hash_encode import forward_plain

    geometry = level_geometry(input_dim, num_levels, per_level_scale,
                              base_resolution, log2_hashmap_size)
    batch_shape = x.shape[:-1]
    out = forward_plain(x.reshape(-1, input_dim), table, geometry)
    return out.reshape(*batch_shape, out.shape[-1])


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a·b + c`` rounded once: the float32 product is exact in
    float64, and the float64 sum rounds to the float32 fused result (but
    where a float64 rounding lands on a float32 tie, ~2^-28 of inputs)."""
    return (a.double() * float(b) + float(c)).float()


def level_terms(x: torch.Tensor, scale: float):
    """One level's ``(pos_grid [N, D] int64, frac [N, D])`` of points ``x
    [N, D]``: ``pos = x·scale + 0.5`` as one fused multiply-add (the
    jitted JAX step's rounding)."""
    pos = fma(x.to(torch.float32), np.float32(scale), 0.5)
    pos_grid = torch.floor(pos)
    return pos_grid.to(torch.int64), pos - pos_grid


def corner_weight(frac: torch.Tensor, corner_bits: int,
                  skip: int = -1) -> torch.Tensor:
    """``Π_d (frac_d or 1 − frac_d)`` of corner ``corner_bits`` in
    dimension order, leaving out dimension ``skip``."""
    w = torch.ones(frac.shape[:-1], dtype=frac.dtype, device=frac.device)
    for dd in range(frac.shape[-1]):
        if dd != skip:
            w = w * (frac[:, dd] if (corner_bits >> dd) & 1
                     else 1.0 - frac[:, dd])
    return w


def _register_bbox(module: nn.Module, bbox) -> None:
    """The world bounds as non-persistent buffers (they follow ``.to()``
    and stay out of the state dict, which holds the JAX tree's leaves)."""
    module.has_bbox = bbox is not None
    if module.has_bbox:
        b = torch.tensor(bbox, dtype=torch.float32)
        module.register_buffer("bbox_lo", b[0].clone(), persistent=False)
        module.register_buffer("bbox_hi", b[1].clone(), persistent=False)
        module.register_buffer("bbox_inv", _inv_extent(b[0], b[1]),
                               persistent=False)


def normalize_points(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """World points → [0, 1] by the module's bbox (:func:`normalize_bbox`
    with the extent's reciprocal precomputed); without one the caller
    pre-normalized, and a clip keeps out-of-range coords from wrapping
    through uint32 into scrambled table indices."""
    if module.has_bbox:
        return (clip(x, module.bbox_lo, module.bbox_hi)
                - module.bbox_lo) * module.bbox_inv
    return clip(x, 0.0, 1.0)


class HashGridEncoder(nn.Module):
    """The hash-grid encoder as an ``nn.Module`` owning ``embeddings [T,
    C]`` (uniform ±1e-4, drawn by :meth:`reset_parameters` from an explicit
    generator), with world-bounds normalization to [0, 1]."""

    def __init__(self, input_dim: int = 3, num_levels: int = 16,
                 level_dim: int = 2, per_level_scale: float = 2.0,
                 base_resolution: int = 16, log2_hashmap_size: int = 19,
                 desired_resolution: int = -1, bbox=None):
        super().__init__()
        self.input_dim = int(input_dim)
        self.num_levels = int(num_levels)
        self.level_dim = int(level_dim)
        self.base_resolution = int(base_resolution)
        self.log2_hashmap_size = int(log2_hashmap_size)
        self.scale_factor = scale_factor(self.num_levels,
                                         float(per_level_scale),
                                         self.base_resolution,
                                         int(desired_resolution))
        self.geometry = level_geometry(
            self.input_dim, self.num_levels, self.scale_factor,
            self.base_resolution, self.log2_hashmap_size)
        self.embeddings = nn.Parameter(
            torch.zeros(self.geometry[0][-1], self.level_dim))
        _register_bbox(self, bbox)

    @property
    def out_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def n_entries(self) -> int:
        return self.geometry[0][-1]

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_table(self.embeddings, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ...ops.hash_encode import encode

        return encode(normalize_points(self, x), self.embeddings,
                      self.geometry)

    @classmethod
    def from_cfg(cls, enc_cfg) -> "HashGridEncoder":
        bbox = enc_cfg.get("bbox", None)
        if bbox is None:
            # config-driven world-coordinate encoders must declare bounds
            raise ValueError(
                "hashgrid encoder config needs 'bbox: [[lo...],[hi...]]' "
                "world bounds for [0,1] normalization"
            )
        return cls(
            input_dim=int(enc_cfg.get("input_dim", 3)),
            num_levels=int(enc_cfg.get("num_levels", 16)),
            level_dim=int(enc_cfg.get("level_dim", 2)),
            per_level_scale=float(enc_cfg.get("per_level_scale", 2.0)),
            base_resolution=int(enc_cfg.get("base_resolution", 16)),
            log2_hashmap_size=int(enc_cfg.get("log2_hashmap_size", 19)),
            desired_resolution=int(enc_cfg.get("desired_resolution", -1)),
            bbox=bbox,
        )
