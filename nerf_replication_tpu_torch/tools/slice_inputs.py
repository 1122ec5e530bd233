"""Fixed inputs shared by ``chip_smoke.py`` and the tools: the serving
slice's (lego.yaml with the fused-march serving opts, a 128³ ball grid, one
lego-style view; ``tools/profile_fused_march.py``), K4's edge rays (the DDA
tests) and the hash encoder's point sets (``tools/time_trees.py``, the card
tests): the NGP warm step's ray-ordered points and a set crowded into one
coarse cell."""

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


EDGE_KINDS = ("graze", "graze_tiny", "axis", "corner", "zero", "view")


def edge_rays(n: int, seed: int = 0, rc: int = 32, half: float = 1.5,
              radius: float = 4.0) -> np.ndarray:
    """[n, 6] float32 rays that stress the DDA's exactness, cycling over
    :data:`EDGE_KINDS`: ``graze``, through a point whose coordinate on one
    axis lies on a face of the rc³ coarse grid over the bbox [-half, half]³,
    with that direction component exactly 0 (the ray runs inside the face);
    ``graze_tiny``, the same with that component ±1e-7 (it crosses the face
    over thousands of steps); ``axis``, along one axis (two components 0,
    either sign); ``corner``, diagonal (±1, ±1, ±1) through a coarse-cell
    corner; ``zero``, a zero direction (bucket padding); ``view``, a
    random direction through the middle of the grid. Each ray starts
    ``radius`` back from its point."""
    rng = np.random.default_rng(seed)
    cell = 2.0 * half / rc
    out = np.zeros((n, 6), np.float64)
    for i in range(n):
        kind = EDGE_KINDS[i % len(EDGE_KINDS)]
        p = rng.uniform(-0.6, 0.6, 3)
        d = rng.normal(0.0, 1.0, 3)
        ax = int(rng.integers(3))
        if kind in ("graze", "graze_tiny", "corner"):
            axes = range(3) if kind == "corner" else (ax,)
            for a in axes:  # snap onto a coarse face
                p[a] = -half + np.round((p[a] + half) / cell) * cell
        if kind in ("graze", "graze_tiny"):
            d[ax] = 0.0 if kind == "graze" else rng.choice([-1e-7, 1e-7])
        elif kind == "axis":
            d = np.zeros(3)
            d[ax] = rng.choice([-1.0, 1.0])
        elif kind == "corner":
            d = rng.choice([-1.0, 1.0], 3)
        elif kind == "zero":
            d = np.zeros(3)
        norm = np.linalg.norm(d)
        if norm > 0:
            d = d / norm
            if kind == "graze_tiny":
                d[ax] = np.sign(d[ax]) * 1e-7
        out[i, :3] = p - radius * d
        if kind in ("graze", "axis"):  # exact zeros stay, the face exact
            for a in range(3):
                if d[a] == 0.0:
                    out[i, a] = p[a]
        out[i, 3:] = d
    return out.astype(np.float32)


LEGO_HASH_BBOX = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))  # lego_hash.yaml


def ngp_points(seed: int = 0, n_rays: int = 1024, n_samples: int = 128,
               hw: int = 200, near: float = 2.0, far: float = 6.0,
               bbox=LEGO_HASH_BBOX) -> np.ndarray:
    """[n_rays·n_samples, 3] float32 points in [0, 1]³: the encoder's input
    in the NGP warm step (``train/ngp.py``). ``n_rays`` pixels drawn without
    replacement from an hw×hw lego-camera view at a seeded angle; depths
    stratified from near to far with no jitter (``stratified_z_vals``); ``o
    + d·z`` as ``march_points`` forms it (one FMA); normalized by the bbox
    as ``HashGridEncoder.forward`` does (``normalize_bbox``: clipped, so
    samples outside land on its faces); flattened ray-major."""
    import torch

    from ..models.encoding.hashgrid import normalize_bbox
    from ..renderer.accelerated import march_points
    from ..renderer.volume import stratified_z_vals

    rng = np.random.default_rng(seed)
    rays = view_rays(float(rng.uniform(-180.0, 180.0)), hw)
    rays = torch.from_numpy(rays[rng.choice(rays.shape[0], n_rays,
                                            replace=False)])
    z = stratified_z_vals(None, near, far, n_rays, n_samples, 0.0)
    pts = march_points(rays[:, :3], rays[:, 3:6], z)
    return normalize_bbox(pts.reshape(-1, 3), bbox).numpy()


def cell_points(n: int, scale: float, d: int = 3,
                seed: int = 0) -> np.ndarray:
    """[n, d] float32 points inside one cell of a level of grid scale
    ``scale`` (``pos = x·scale + 0.5``; the cell that x = 0.5 falls in,
    kept 1e-3 of a cell off its faces): the contention set, every point's
    corners at that level the same 2^d rows."""
    k = np.floor(0.5 * scale + 0.5)
    lo, hi = (k - 0.5 + 1e-3) / scale, (k + 0.5 - 1e-3) / scale
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (n, d)).astype(np.float32)
