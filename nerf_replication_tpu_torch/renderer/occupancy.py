"""Occupancy-grid baking, I/O and lookup (port of
``nerf_replication_tpu/renderer/occupancy.py``).

The ``.npz`` artifact has the same keys as the JAX package's (``grid``,
``bbox``, ``threshold``, ``pyramid_version``, ``pyramid_factors``,
``level_1``, ``level_2``) and the same SHA-256 sidecar
(``resil/checksum.py``), so a grid baked by either package loads in the
other. A load passes the ``occupancy.load`` fault point with retries; a
checksum mismatch or a torn archive is a ``fault`` row and an ``OSError``,
on which the renderer falls back to the chunked (slow) path.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..resil import (
    fault_point,
    report,
    verify_checksum,
    with_retry,
    write_checksum,
)

SUBSAMPLES = (2, 2, 2)
PYRAMID_VERSION = 1
# reduction factor of each coarse level relative to the fine grid; the
# fused march tests the coarsest (last) level
PYRAMID_FACTORS = (2, 4)


def voxel_sample_points(bbox: np.ndarray, resolution: int) -> np.ndarray:
    """[R³, n_sub, 3] world-space sample positions: each voxel's base corner
    plus a sub-grid spanning the voxel."""
    lo, hi = np.asarray(bbox[0], np.float32), np.asarray(bbox[1], np.float32)
    voxel_size = (hi - lo) / resolution
    axes = [np.linspace(0.0, 1.0, s) * voxel_size[d]
            for d, s in enumerate(SUBSAMPLES)]
    sub = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    ranges = [np.arange(resolution)] * 3
    grid_idx = np.stack(np.meshgrid(*ranges, indexing="ij"), -1).astype(
        np.float32
    )
    base = lo + grid_idx * voxel_size
    pts = base.reshape(-1, 1, 3) + sub[None, :, :]
    return pts.astype(np.float32)


@torch.no_grad()
def bake_occupancy_grid(network, cfg, device="cuda") -> np.ndarray:
    """bool [R,R,R]: any of a voxel's 2×2×2 sub-samples has coarse-network
    density ``relu(σ)`` over ``task_arg.occupancy_grid_threshold``, queried
    with zero viewdirs in batches of ``occupancy_grid_batch_size`` voxels."""
    from ..utils.platform import resolve_device

    dev = resolve_device(device)
    ta = cfg.task_arg
    resolution = int(ta.occupancy_grid_res)
    threshold = float(ta.occupancy_grid_threshold)
    batch = int(ta.get("occupancy_grid_batch_size", 4096))
    bbox = np.asarray(cfg.train_dataset.scene_bbox, np.float32)
    pts = torch.from_numpy(voxel_sample_points(bbox, resolution)).to(dev)
    occupied = []
    for i in range(0, pts.shape[0], batch):
        p = pts[i:i + batch]
        dirs = torch.zeros((p.shape[0], 3), dtype=torch.float32, device=dev)
        raw = network(p, dirs, model="coarse")
        occupied.append(torch.any(torch.relu(raw[..., 3]) > threshold, -1))
    grid = torch.cat(occupied).cpu().numpy()
    return grid.reshape(resolution, resolution, resolution)


def default_grid_path(cfg_file: str) -> str:
    """logs/<config_name>/occupancy_grid.npz (the JAX package's layout)."""
    name = os.path.splitext(os.path.basename(cfg_file))[0]
    return os.path.join("logs", name, "occupancy_grid.npz")


def _reduce_any(grid, factor: int):
    """Any-reduce a bool [R,R,R] grid (numpy array or tensor) by
    ``factor`` per axis; a resolution not divisible by it pads with False."""
    r = grid.shape[0]
    rp = -(-r // factor) * factor
    rc = rp // factor
    if isinstance(grid, torch.Tensor):
        if rp != r:
            g = torch.zeros((rp, rp, rp), dtype=torch.bool, device=grid.device)
            g[:r, :r, :r] = grid
            grid = g
        return grid.reshape(rc, factor, rc, factor, rc, factor).any(5).any(
            3).any(1)
    if rp != r:
        grid = np.pad(grid, [(0, rp - r)] * 3)
    return grid.reshape(rc, factor, rc, factor, rc, factor).any(axis=(1, 3, 5))


def coarse_from_grid(grid: torch.Tensor, factor: int) -> torch.Tensor:
    """The coarse pyramid level of a bool fine grid, on its device."""
    return _reduce_any(grid, factor)


def build_pyramid(grid: np.ndarray) -> list[np.ndarray]:
    """Host-side ``[fine, coarse@2, coarse@4]`` mip stack of a bool grid."""
    grid = np.asarray(grid, bool)
    return [grid] + [_reduce_any(grid, f) for f in PYRAMID_FACTORS]


def save_occupancy_grid(path: str, grid: np.ndarray, bbox,
                        threshold: float) -> str:
    """Write the versioned pyramid artifact plus its checksum sidecar."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    levels = build_pyramid(grid)
    np.savez_compressed(
        path,
        grid=levels[0],
        bbox=np.asarray(bbox, np.float32),
        threshold=np.float32(threshold),
        pyramid_version=np.int32(PYRAMID_VERSION),
        pyramid_factors=np.asarray(PYRAMID_FACTORS, np.int32),
        **{f"level_{i}": lv for i, lv in enumerate(levels[1:], start=1)},
    )
    write_checksum(path)
    return path


def load_occupancy_pyramid(path: str):
    """(levels ``[fine, coarse@2, coarse@4]``, bbox [2,3]).

    A flat legacy grid or one baked with other pyramid factors rebuilds
    its levels from the fine grid. Transient read errors retry with
    backoff; a checksum mismatch or an unreadable archive raises
    ``OSError`` after a detected-fault row."""
    if verify_checksum(path) is False:
        report("occupancy.load", "checksum", path=path)
        raise OSError(f"corrupt occupancy artifact (checksum mismatch): {path}")

    def _read():
        fault_point("occupancy.load", path=path)
        with np.load(path) as z:
            grid = np.asarray(z["grid"], bool)
            bbox = np.asarray(z["bbox"], np.float32)
            baked_ok = (
                "pyramid_version" in z
                and int(z["pyramid_version"]) == PYRAMID_VERSION
                and tuple(np.asarray(z["pyramid_factors"]).tolist())
                == PYRAMID_FACTORS
            )
            if baked_ok:
                levels = [grid] + [
                    np.asarray(z[f"level_{i}"], bool)
                    for i in range(1, len(PYRAMID_FACTORS) + 1)
                ]
            else:
                levels = build_pyramid(grid)
        return levels, bbox

    try:
        return with_retry(_read, point="occupancy.load")
    except OSError:
        raise
    except Exception as exc:  # torn zip member / bad header / missing key
        report("occupancy.load", "torn", path=path,
               detail=f"{type(exc).__name__}")
        raise OSError(
            f"corrupt occupancy artifact: {path} ({type(exc).__name__})"
        ) from exc


def occupancy_stats(grid: np.ndarray) -> dict:
    """Sanity-check stats of a baked grid (bool, 3-D)."""
    if grid.dtype != np.bool_ or grid.ndim != 3:
        raise ValueError(f"grid must be a 3-D bool array, got {grid.dtype} "
                         f"{grid.shape}")
    occupied = int(grid.sum())
    return {
        "shape": tuple(grid.shape),
        "occupied": occupied,
        "total": grid.size,
        "occupancy_pct": 100.0 * occupied / grid.size,
    }


def world_to_voxel(pts: torch.Tensor, bbox: torch.Tensor,
                   resolution: int) -> torch.Tensor:
    """World points → int64 voxel indices, clamped into the grid:
    clip to the bbox → normalise → ``floor(u · R)`` → clamp. Each step is
    its own rounded float32 operation (no fused multiply-add), the order
    the JAX function computes and the CUDA kernel reproduces."""
    lo, hi = bbox[0], bbox[1]
    normalized = (torch.minimum(torch.maximum(pts, lo), hi) - lo) / (hi - lo)
    idx = torch.floor(normalized * float(resolution)).to(torch.int64)
    return idx.clamp(0, resolution - 1)
