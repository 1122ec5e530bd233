"""Pinhole-camera ray generation and camera-path helpers (NumPy).

The port's copy of ``nerf_replication_tpu/datasets/rays.py``: ``get_rays_np``,
``ndc_rays_np``, ``pose_spherical`` and ``focal_from_fov``. Convention
is the Blender/NeRF one: camera looks down -z, x right, y up; ``c2w`` is a 3x4
or 4x4 camera-to-world matrix.
"""

from __future__ import annotations

import numpy as np


def get_rays_np(
    H: int,
    W: int,
    focal: float,
    c2w: np.ndarray,
    fl_y: float | None = None,
    cx: float | None = None,
    cy: float | None = None,
):
    """Ray origins/directions for every pixel of an HxW pinhole image.

    Returns ``(rays_o, rays_d)`` each ``[H, W, 3]`` float32. Directions are
    *not* normalized (matching the reference; `raw2outputs` multiplies sample
    distances by ``|d|``, volume_renderer.py:27).

    The Blender-synthetic case passes only ``focal`` (principal point at the
    image center, square pixels). Real captures carry calibrated
    ``fl_x/fl_y/cx/cy`` (colmap2nerf output) — pass them for off-center /
    anisotropic intrinsics.
    """
    c2w = np.asarray(c2w, dtype=np.float32)
    fl_y = focal if fl_y is None else fl_y
    cx = 0.5 * W if cx is None else cx
    cy = 0.5 * H if cy is None else cy
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy"
    )
    dirs = np.stack(
        [(i - cx) / focal, -(j - cy) / fl_y, -np.ones_like(i)], axis=-1
    )
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape).copy()
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def ndc_rays_np(
    H: int, W: int, focal: float, near: float,
    rays_o: np.ndarray, rays_d: np.ndarray,
    fl_y: float | None = None,
):
    """Shift rays into normalized device coordinates (forward-facing
    scenes, the original NeRF's LLFF treatment): origins moved to the
    z = -near plane, then the perspective projection maps the frustum to
    the [-1, 1] cube, so sampling t ∈ [0, 1] sweeps near → infinity. In
    float64, returned as float32; ``fl_y`` for anisotropic pixels."""
    fl_y = focal if fl_y is None else fl_y
    o, d = rays_o.astype(np.float64), rays_d.astype(np.float64)
    t = -(near + o[..., 2]) / d[..., 2]
    o = o + t[..., None] * d

    o0 = -focal / (0.5 * W) * o[..., 0] / o[..., 2]
    o1 = -fl_y / (0.5 * H) * o[..., 1] / o[..., 2]
    o2 = 1.0 + 2.0 * near / o[..., 2]
    d0 = -focal / (0.5 * W) * (d[..., 0] / d[..., 2] - o[..., 0] / o[..., 2])
    d1 = -fl_y / (0.5 * H) * (d[..., 1] / d[..., 2] - o[..., 1] / o[..., 2])
    d2 = -2.0 * near / o[..., 2]

    rays_o = np.stack([o0, o1, o2], axis=-1).astype(np.float32)
    rays_d = np.stack([d0, d1, d2], axis=-1).astype(np.float32)
    return rays_o, rays_d


def trans_t(t: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def rot_phi(phi: float) -> np.ndarray:
    c, s = np.cos(phi), np.sin(phi)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def rot_theta(th: float) -> np.ndarray:
    c, s = np.cos(th), np.sin(th)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2] = c, -s
    m[2, 0], m[2, 2] = s, c
    return m


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Camera-to-world for a camera on a sphere looking at the origin
    (render_video.py:10-19 semantics: translate, tilt phi, spin theta, flip x/z
    into the Blender world frame)."""
    c2w = trans_t(radius)
    c2w = rot_phi(phi_deg / 180.0 * np.pi) @ c2w
    c2w = rot_theta(theta_deg / 180.0 * np.pi) @ c2w
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32
    )
    return flip @ c2w


def focal_from_fov(W: int, camera_angle_x: float) -> float:
    """focal = 0.5 * W / tan(0.5 * fov_x)  (blender.py:71-75)."""
    return 0.5 * W / float(np.tan(0.5 * camera_angle_x))
