"""Tri-plane encoder: three axis-aligned 2-D hash grids (port of
``nerf_replication_tpu/models/encoding/triplane.py``).

The xy / yz / xz projections of a 3-D point each go through an independent
2-D multiresolution hash encoder (``plane_01``, ``plane_12``, ``plane_02``)
and the three feature vectors concatenate. Each plane is a
:class:`~.hashgrid.HashGridEncoder` with ``input_dim=2``, so on the card its
forward is kernel K6 at D = 2 and its backward K6b; each projection is made
contiguous (``torch.stack`` of two columns) before the call.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .hashgrid import HashGridEncoder, _register_bbox, normalize_points

_PLANES = ((0, 1), (1, 2), (0, 2))  # xy, yz, xz


def project(x: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """``x[..., (a, b)]`` as a contiguous tensor, whose backward is a plain
    slice (no scatter)."""
    return torch.stack([x[..., a], x[..., b]], dim=-1)


def make_planes(module: nn.Module, kwargs: dict) -> list:
    """Add the three D = 2 hash grids to ``module`` under the JAX names."""
    planes = []
    for a, b in _PLANES:
        plane = HashGridEncoder(**{**kwargs, "input_dim": 2})
        module.add_module(f"plane_{a}{b}", plane)
        planes.append(plane)
    return planes


def encode_planes(planes, x: torch.Tensor) -> torch.Tensor:
    return torch.cat([plane(project(x, a, b))
                      for plane, (a, b) in zip(planes, _PLANES)], dim=-1)


class TriPlaneEncoder(nn.Module):
    """``[..., 3]`` → ``[..., 3·L·C]``."""

    def __init__(self, num_levels: int = 16, level_dim: int = 2,
                 per_level_scale: float = 2.0, base_resolution: int = 16,
                 log2_hashmap_size: int = 19, desired_resolution: int = -1,
                 bbox=None):
        super().__init__()
        self.num_levels, self.level_dim = int(num_levels), int(level_dim)
        self.planes = make_planes(self, dict(
            num_levels=num_levels, level_dim=level_dim,
            per_level_scale=per_level_scale, base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size,
            desired_resolution=desired_resolution))
        _register_bbox(self, bbox)

    @property
    def out_dim(self) -> int:
        return 3 * self.num_levels * self.level_dim

    def reset_parameters(self, generator: torch.Generator) -> None:
        for plane in self.planes:
            plane.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.has_bbox:
            x = normalize_points(self, x)
        return encode_planes(self.planes, x)

    @classmethod
    def from_cfg(cls, enc_cfg) -> "TriPlaneEncoder":
        bbox = enc_cfg.get("bbox", None)
        return cls(
            num_levels=int(enc_cfg.get("num_levels", 16)),
            level_dim=int(enc_cfg.get("level_dim", 2)),
            per_level_scale=float(enc_cfg.get("per_level_scale", 2.0)),
            base_resolution=int(enc_cfg.get("base_resolution", 16)),
            log2_hashmap_size=int(enc_cfg.get("log2_hashmap_size", 19)),
            desired_resolution=int(enc_cfg.get("desired_resolution", -1)),
            bbox=tuple(map(tuple, bbox)) if bbox is not None else None,
        )
