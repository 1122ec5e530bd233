"""Ray-bank builder (port of ``build_ray_bank`` in
``nerf_replication_tpu/native/__init__.py``).

The JAX package builds the bank with a multithreaded C++ library when it is
built and with numpy otherwise; the port carries the numpy builder
(``_build_ray_bank_numpy``) — the C++ one comes with a later slice. Same
math: pinhole rays of every pixel (``datasets/rays.get_rays_np``) and the
RGBA frames composited onto white.
"""

from __future__ import annotations

import numpy as np


def build_ray_bank(poses: np.ndarray, images: np.ndarray, focal: float):
    """(rays [n·H·W, 6] float32, rgbs [n·H·W, 3] float32) from poses [n,
    4, 4] and uint8 frames [n, H, W, 3|4]."""
    n, H, W, C = images.shape
    if C not in (3, 4):
        raise ValueError(
            f"build_ray_bank needs RGB or RGBA frames, got {C} channels"
        )
    return _build_ray_bank_numpy(poses, images, focal)


def _build_ray_bank_numpy(poses, images, focal):
    from ..datasets.rays import get_rays_np

    n, H, W, C = images.shape
    rays_list, rgb_list = [], []
    for f in range(n):
        rays_o, rays_d = get_rays_np(H, W, focal, poses[f])
        rays_list.append(
            np.concatenate([rays_o, rays_d], -1).reshape(-1, 6)
        )
        img = images[f].astype(np.float32) / 255.0
        if C == 4:
            img = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
        rgb_list.append(img[..., :3].reshape(-1, 3).astype(np.float32))
    return (
        np.concatenate(rays_list, 0).astype(np.float32),
        np.concatenate(rgb_list, 0),
    )
