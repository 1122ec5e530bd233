"""The benchmark's scene, ray-traced on the device from the seed.

An analytic solid sphere (coloured by its normal) and an orange box,
Lambert-lit, on a transparent background composited onto white: the
procedural Blender-format scene the repository's tests train on, with the
same geometry, shading, camera convention and 8-bit quantisation. This copy
traces on the device, so the ray bank of a lego-sized training set (100
views of 800x800, 64,000,000 rays and colours, 2.30 GB) is made where it is
used and never crosses the host.

Also here: the scene's analytic occupancy at any grid resolution (a cell is
occupied where its box meets the sphere or the box), which stands in for a
baked grid, and the cameras of the serving orbit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CAMERA_ANGLE_X = 0.6911112070083618  # the Blender synthetic field of view
SPHERE_C = (0.35, 0.0, 0.25)
SPHERE_R = 0.55
BOX_LO = (-0.9, -0.5, -0.5)
BOX_HI = (-0.1, 0.3, 0.3)
BOX_ALBEDO = (0.9, 0.35, 0.2)
_LIGHT = np.array([0.4, 0.35, 0.85], np.float32)
LIGHT_DIR = tuple(float(v) for v in _LIGHT / np.linalg.norm([0.4, 0.35,
                                                                0.85]))


def focal_for(width: int, camera_angle_x: float = CAMERA_ANGLE_X) -> float:
    return 0.5 * width / float(np.tan(0.5 * camera_angle_x))


def pose_spherical(theta_deg: float, phi_deg: float,
                   radius: float) -> np.ndarray:
    """Camera-to-world [4, 4] float32 of a camera on a sphere looking at the
    origin (the original NeRF's render-path convention)."""
    def rot_phi(p):
        c, s = np.cos(p), np.sin(p)
        return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0],
                         [0, 0, 0, 1]], np.float32)

    def rot_theta(t):
        c, s = np.cos(t), np.sin(t)
        return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0],
                         [0, 0, 0, 1]], np.float32)

    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = radius
    c2w = rot_phi(phi_deg / 180.0 * np.pi) @ c2w
    c2w = rot_theta(theta_deg / 180.0 * np.pi) @ c2w
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1]], np.float32)
    return flip @ c2w


def train_poses(seed: int, n_views: int,
                phi_range=(-60.0, -10.0)) -> np.ndarray:
    """[n, 4, 4] training cameras at radius 4: azimuths evenly spaced over
    [-180, 180), elevations spread over ``phi_range`` by the golden ratio,
    in an order drawn from the seed. Every seed trains on the same views,
    so the seed changes the order and not the work."""
    k = np.arange(int(n_views))
    theta = -180.0 + 360.0 * (k + 0.5) / max(int(n_views), 1)
    frac = np.mod(k * 0.6180339887498949 + 0.5, 1.0)
    phi = phi_range[0] + (phi_range[1] - phi_range[0]) * frac
    order = np.random.default_rng(int(seed)).permutation(int(n_views))
    return np.stack([pose_spherical(float(theta[i]), float(phi[i]), 4.0)
                     for i in order])


def camera_rays(H: int, W: int, focal: float, c2w: torch.Tensor):
    """``(origins [H*W, 3], directions [H*W, 3])`` float32 on ``c2w``'s
    device; directions unnormalised, pixel (i, j) at ``((i - W/2)/f,
    -(j - H/2)/f, -1)`` in the camera frame."""
    dev = c2w.device
    f32 = torch.float32
    j, i = torch.meshgrid(torch.arange(H, dtype=f32, device=dev),
                          torch.arange(W, dtype=f32, device=dev),
                          indexing="ij")
    dirs = torch.stack([(i - 0.5 * W) / focal, -(j - 0.5 * H) / focal,
                        -torch.ones_like(i)], -1).reshape(-1, 3)
    rot = c2w[:3, :3].to(f32)
    d = (dirs[:, 0:1] * rot[:, 0] + dirs[:, 1:2] * rot[:, 1]
         + dirs[:, 2:3] * rot[:, 2])
    o = c2w[:3, 3].to(f32).expand(d.shape)
    return o.contiguous(), d.contiguous()


def camera_rays_host(H: int, W: int, focal: float, c2w: np.ndarray):
    """``(origins, directions)`` [H*W, 3] float32 numpy: the same camera
    model as :func:`camera_rays`, rotated by a float32 product with
    ``c2w``'s rotation, as a viewer's client forms a view's rays."""
    c2w = np.asarray(c2w, np.float32)
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i - 0.5 * W) / focal, -(j - 0.5 * H) / focal,
                     -np.ones_like(i)], -1)
    d = (dirs @ c2w[:3, :3].T).reshape(-1, 3)
    o = np.broadcast_to(c2w[:3, 3], d.shape)
    return np.ascontiguousarray(o, np.float32), d.astype(np.float32)


def _sphere_t(o, d, c, r):
    oc = o - c
    b = torch.sum(oc * d, -1)
    a = torch.sum(d * d, -1)
    cc = torch.sum(oc * oc, -1) - r * r
    disc = b * b - a * cc
    hit = disc > 0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = (-b - sq) / a
    t1 = (-b + sq) / a
    t = torch.where(t0 > 1e-3, t0, t1)
    return torch.where(hit & (t > 1e-3), t, torch.full_like(t, math.inf))


def _box_t(o, d, lo, hi):
    tiny = torch.full_like(d, 1e-9)
    inv = 1.0 / torch.where(d.abs() < 1e-9, tiny, d)
    t_lo = (lo - o) * inv
    t_hi = (hi - o) * inv
    t_near = torch.minimum(t_lo, t_hi).amax(-1)
    t_far = torch.maximum(t_lo, t_hi).amin(-1)
    hit = t_far > torch.clamp_min(t_near, 1e-3)
    t = torch.where(t_near > 1e-3, t_near, t_far)
    return torch.where(hit & (t > 1e-3), t, torch.full_like(t, math.inf))


def trace_rgba8(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The scene's RGBA at rays ``(o, d)`` as 8-bit levels ([N, 4] float32
    holding whole numbers 0..255, the PNG the test scene writes)."""
    dev, f32 = o.device, torch.float32
    c = torch.tensor(SPHERE_C, dtype=f32, device=dev)
    lo = torch.tensor(BOX_LO, dtype=f32, device=dev)
    hi = torch.tensor(BOX_HI, dtype=f32, device=dev)
    light = torch.tensor(LIGHT_DIR, dtype=f32, device=dev)
    t_s = _sphere_t(o, d, c, SPHERE_R)
    t_b = _box_t(o, d, lo, hi)
    t = torch.minimum(t_s, t_b)
    sphere = t_s <= t_b
    hit = torch.isfinite(t)
    p = o + torch.where(hit, t, torch.zeros_like(t))[:, None] * d
    n_sphere = (p - c) / SPHERE_R
    rel = (p - (lo + hi) / 2) / ((hi - lo) / 2)
    axis = torch.argmax(rel.abs(), -1)
    n_box = torch.zeros_like(p)
    n_box.scatter_(1, axis[:, None],
                   torch.sign(torch.gather(rel, 1, axis[:, None])))
    n = torch.where(sphere[:, None], n_sphere, n_box)
    lambert = torch.clamp(torch.sum(n * light, -1), 0.0, 1.0)[:, None]
    albedo = torch.where(sphere[:, None], 0.5 * (n_sphere + 1.0),
                         torch.tensor(BOX_ALBEDO, dtype=f32, device=dev))
    rgb = albedo * (0.25 + 0.75 * lambert)
    rgba = torch.cat([torch.where(hit[:, None], rgb, torch.zeros_like(rgb)),
                      hit[:, None].to(f32)], -1)
    return torch.floor(torch.clamp(rgba, 0.0, 1.0) * 255.0)


def composite_white(rgba8: torch.Tensor) -> torch.Tensor:
    """8-bit RGBA levels -> float rgb over a white background (the Blender
    loader's ``rgb * a + (1 - a)``)."""
    a = rgba8[:, 3:4] / 255.0
    return rgba8[:, :3] / 255.0 * a + (1.0 - a)


def make_bank(seed: int, n_views: int, H: int, W: int, device,
              camera_angle_x: float = CAMERA_ANGLE_X):
    """``(rays [n*H*W, 6], rgbs [n*H*W, 3])`` float32 on ``device``: every
    pixel of ``n_views`` training views of the scene, as the training
    set's ray bank holds them."""
    poses = torch.from_numpy(train_poses(seed, n_views)).to(device)
    focal = focal_for(W, camera_angle_x)
    n_pix = H * W
    rays = torch.empty((n_views * n_pix, 6), dtype=torch.float32,
                       device=device)
    rgbs = torch.empty((n_views * n_pix, 3), dtype=torch.float32,
                       device=device)
    for k in range(n_views):
        o, d = camera_rays(H, W, focal, poses[k])
        sl = slice(k * n_pix, (k + 1) * n_pix)
        rays[sl, :3] = o
        rays[sl, 3:] = d
        rgbs[sl] = composite_white(trace_rgba8(o, d))
    return rays, rgbs


def analytic_occupancy(resolution: int, bbox=((-1.5,) * 3, (1.5,) * 3),
                       device="cpu") -> torch.Tensor:
    """bool [R, R, R] (x, y, z order): a cell is occupied where its box
    meets the solid sphere or the solid box."""
    f32 = torch.float64
    lo = torch.tensor(bbox[0], dtype=f32, device=device)
    hi = torch.tensor(bbox[1], dtype=f32, device=device)
    h = (hi - lo) / resolution
    idx = torch.arange(resolution, dtype=f32, device=device)
    axes_lo = [lo[k] + idx * h[k] for k in range(3)]
    gx, gy, gz = torch.meshgrid(*axes_lo, indexing="ij")
    cell_lo = torch.stack([gx, gy, gz], -1)
    cell_hi = cell_lo + h
    c = torch.tensor(SPHERE_C, dtype=f32, device=device)
    nearest = torch.minimum(torch.maximum(c, cell_lo), cell_hi)
    in_sphere = torch.sum((nearest - c) ** 2, -1) <= SPHERE_R ** 2
    b_lo = torch.tensor(BOX_LO, dtype=f32, device=device)
    b_hi = torch.tensor(BOX_HI, dtype=f32, device=device)
    in_box = torch.all((cell_lo < b_hi) & (cell_hi > b_lo), -1)
    return in_sphere | in_box
