"""The serving slice's fixed on-card inputs, shared by ``chip_smoke.py`` and
``tools/profile_fused_march.py``: lego.yaml with the fused-march serving
opts, a 128³ ball grid and one lego-style view."""

from __future__ import annotations

import numpy as np

from ..datasets.rays import focal_from_fov, get_rays_np, pose_spherical

SLICE_OPTS = ["task_arg.march_coarse_block", "8", "task_arg.march_fused",
              "full"]
LEGO_CAMERA_ANGLE_X = 0.6911112070083618  # nerf_synthetic lego, test split


def ball_grid(res: int = 128, radius: float = 0.46) -> np.ndarray:
    """bool res³ ball in normalized [-1, 1]³ (scripts/bench_traversal.py's
    carved arm: radius 0.46 fills ~5% of the volume)."""
    c = (np.arange(res) + 0.5) / res * 2.0 - 1.0
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    return (x * x + y * y + z * z) < radius * radius


def view_rays(theta: float, hw: int) -> np.ndarray:
    """[hw², 6] rays of an hw×hw lego-camera view from radius 4, phi -30."""
    focal = focal_from_fov(hw, LEGO_CAMERA_ANGLE_X)
    o, d = get_rays_np(hw, hw, focal, pose_spherical(theta, -30.0, 4.0))
    return np.concatenate([o, d], -1).reshape(-1, 6).astype(np.float32)
