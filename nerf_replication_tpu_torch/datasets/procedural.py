"""Procedural Blender-format scene generator (port of
``nerf_replication_tpu/datasets/procedural.py``: ``render_view``,
``generate_scene``, ``ensure_scene``, ``generate_light_stage_capture``), and
:func:`write_real_capture`, which lays a generated scene out as one
real-capture ``transforms.json``.

It writes a *valid* Blender-format scene (transforms_{split}.json + RGBA
PNGs) by analytically ray-tracing a small solid scene — a normal-colored
sphere and an axis-aligned box on a transparent background — so training,
validation and serving have a learnable ground truth without any download.
The same seed gives the same scene as the JAX package; PNGs are written with
the port's codec (``utils/image.py``) instead of imageio.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..utils.image import png_size, write_png
from .rays import get_rays_np, pose_spherical

CAMERA_ANGLE_X = 0.6911112070083618  # Blender synthetic default fov


def _intersect_sphere(rays_o, rays_d, center, radius):
    """Smallest positive t of ray/sphere hit, inf where missed."""
    oc = rays_o - center
    b = np.sum(oc * rays_d, -1)
    a = np.sum(rays_d * rays_d, -1)
    c = np.sum(oc * oc, -1) - radius**2
    disc = b * b - a * c
    hit = disc > 0
    sq = np.sqrt(np.maximum(disc, 0.0))
    t0 = (-b - sq) / a
    t1 = (-b + sq) / a
    t = np.where(t0 > 1e-3, t0, t1)
    return np.where(hit & (t > 1e-3), t, np.inf)


def _intersect_box(rays_o, rays_d, lo, hi):
    """Slab-method ray/AABB intersection; inf where missed."""
    inv = 1.0 / np.where(np.abs(rays_d) < 1e-9, 1e-9, rays_d)
    t_lo = (lo - rays_o) * inv
    t_hi = (hi - rays_o) * inv
    t_near = np.max(np.minimum(t_lo, t_hi), -1)
    t_far = np.min(np.maximum(t_lo, t_hi), -1)
    hit = (t_far > np.maximum(t_near, 1e-3))
    t = np.where(t_near > 1e-3, t_near, t_far)
    return np.where(hit & (t > 1e-3), t, np.inf)


def _intersect_cylinder_z(rays_o, rays_d, cx, cy, radius, z0, z1):
    """Smallest positive t of a ray vs a z-aligned finite cylinder."""
    ox = rays_o[:, 0] - cx
    oy = rays_o[:, 1] - cy
    dx, dy = rays_d[:, 0], rays_d[:, 1]
    a = dx * dx + dy * dy
    b = ox * dx + oy * dy
    c = ox * ox + oy * oy - radius * radius
    disc = b * b - a * c
    hit = (disc > 0) & (a > 1e-12)
    sq = np.sqrt(np.maximum(disc, 0.0))
    a_safe = np.where(a > 1e-12, a, 1.0)
    best = np.full(len(rays_o), np.inf)
    for t in ((-b - sq) / a_safe, (-b + sq) / a_safe):
        z = rays_o[:, 2] + t * rays_d[:, 2]
        ok = hit & (t > 1e-3) & (z >= z0) & (z <= z1)
        best = np.where(ok & (t < best), t, best)
    return best


SPHERE_C = np.array([0.35, 0.0, 0.25], dtype=np.float32)
SPHERE_R = 0.55
BOX_LO = np.array([-0.9, -0.5, -0.5], dtype=np.float32)
BOX_HI = np.array([-0.1, 0.3, 0.3], dtype=np.float32)
LIGHT_DIR = np.array([0.4, 0.35, 0.85], dtype=np.float32) / np.linalg.norm(
    [0.4, 0.35, 0.85]
)

# "hard" variant: a fence of THIN vertical cylinders (diameter 0.03 —
# the width of ~1.3 cells of a 128³ grid over the ±1.5 bbox, the classic
# occupancy-carving failure shape) in FRONT of the textured solids, so
# carving the space between the bars without eating the bars is required
# to render the scene (cf. the lego grille, the reference's own scene).
HARD_FENCE_X = np.linspace(-0.9, 0.9, 7, dtype=np.float32)
HARD_FENCE_Y = 0.8
HARD_FENCE_R = 0.015
HARD_FENCE_Z = (-0.6, 0.6)
HARD_CHECKER_FREQ = 24.0  # albedo cycles/unit — sub-voxel color detail


def render_view(
    H: int, W: int, focal: float, c2w: np.ndarray, variant: str = "plain"
) -> np.ndarray:
    """Analytic RGBA render of the scene from one camera. [H, W, 4] uint8.

    ``variant="hard"`` adds the thin-cylinder fence and swaps the solid
    albedos for a high-frequency 3D checker — deliberately adversarial
    geometry for grid carving and encoder resolution (VERDICT r4 #6: show
    the 30 dB crossing is not an artifact of easy geometry).
    """
    rays_o, rays_d = get_rays_np(H, W, focal, c2w)
    o = rays_o.reshape(-1, 3)
    d = rays_d.reshape(-1, 3)
    hard = variant == "hard"

    t_s = _intersect_sphere(o, d, SPHERE_C, SPHERE_R)
    t_b = _intersect_box(o, d, BOX_LO, BOX_HI)
    t = np.minimum(t_s, t_b)
    which = np.where(t_s <= t_b, 0, 1)  # 0 sphere, 1 box
    if hard:
        for cx in HARD_FENCE_X:
            t_c = _intersect_cylinder_z(
                o, d, cx, HARD_FENCE_Y, HARD_FENCE_R, *HARD_FENCE_Z
            )
            which = np.where(t_c < t, 2, which)
            t = np.minimum(t, t_c)
    hit = np.isfinite(t)
    which = np.where(hit, which, -1)

    p = o + np.where(hit, t, 0.0)[:, None] * d
    # normals
    n_sphere = (p - SPHERE_C) / SPHERE_R
    center_box = (BOX_LO + BOX_HI) / 2
    half = (BOX_HI - BOX_LO) / 2
    rel = (p - center_box) / half
    axis = np.argmax(np.abs(rel), -1)
    n_box = np.zeros_like(p)
    n_box[np.arange(len(p)), axis] = np.sign(
        rel[np.arange(len(p)), axis]
    )
    n = np.where((which == 0)[:, None], n_sphere, n_box)
    if hard:
        # cylinder normal: radial in xy from the nearest fence bar
        dx = p[:, 0:1] - HARD_FENCE_X[None, :]
        nearest = np.argmin(np.abs(dx), axis=-1)
        cx = HARD_FENCE_X[nearest]
        n_cyl = np.stack(
            [p[:, 0] - cx, p[:, 1] - HARD_FENCE_Y, np.zeros(len(p))], -1
        )
        n_cyl /= np.maximum(
            np.linalg.norm(n_cyl, axis=-1, keepdims=True), 1e-9
        )
        n = np.where((which == 2)[:, None], n_cyl, n)

    lambert = np.clip(np.sum(n * LIGHT_DIR, -1), 0.0, 1.0)[:, None]
    albedo_sphere = 0.5 * (n_sphere + 1.0)
    albedo_box = np.broadcast_to(
        np.array([0.9, 0.35, 0.2], dtype=np.float32), p.shape
    )
    if hard:
        # 3D checker at sub-voxel frequency: the encoder must resolve
        # color flips every ~0.04 units (< one 128³ grid cell)
        checker = (
            np.floor(p[:, 0] * HARD_CHECKER_FREQ)
            + np.floor(p[:, 1] * HARD_CHECKER_FREQ)
            + np.floor(p[:, 2] * HARD_CHECKER_FREQ)
        ) % 2.0
        albedo_sphere = np.where(
            checker[:, None] > 0.5,
            np.array([0.95, 0.95, 0.1], np.float32),
            np.array([0.1, 0.2, 0.9], np.float32),
        )
        albedo_box = np.where(
            checker[:, None] > 0.5,
            np.array([0.9, 0.35, 0.2], np.float32),
            np.array([0.15, 0.8, 0.5], np.float32),
        )
    albedo = np.where((which == 0)[:, None], albedo_sphere, albedo_box)
    if hard:
        albedo = np.where(
            (which == 2)[:, None],
            np.array([0.85, 0.85, 0.9], np.float32),
            albedo,
        )
    rgb = albedo * (0.25 + 0.75 * lambert)

    rgba = np.zeros((H * W, 4), dtype=np.float32)
    rgba[:, :3] = np.where(hit[:, None], rgb, 0.0)
    rgba[:, 3] = hit.astype(np.float32)
    return (np.clip(rgba.reshape(H, W, 4), 0, 1) * 255).astype(np.uint8)


def generate_scene(
    root: str,
    scene: str = "procedural",
    H: int = 64,
    W: int = 64,
    n_train: int = 20,
    n_test: int = 4,
    radius: float = 4.0,
    seed: int = 0,
) -> str:
    """Write a Blender-format scene dir; returns its path."""
    rng = np.random.default_rng(seed)
    scene_dir = os.path.join(root, scene)
    focal = 0.5 * W / np.tan(0.5 * CAMERA_ANGLE_X)
    # scene names containing "hard" get the adversarial variant (thin
    # fence + sub-voxel checker albedo)
    variant = "hard" if "hard" in scene else "plain"

    for split, n in (("train", n_train), ("val", n_test), ("test", n_test)):
        frames = []
        img_dir = os.path.join(scene_dir, split)
        os.makedirs(img_dir, exist_ok=True)
        for k in range(n):
            if split == "train":
                theta = float(rng.uniform(-180, 180))
                phi = float(rng.uniform(-60, -10))
            else:
                theta = -180.0 + 360.0 * k / max(n, 1)
                phi = -30.0
            c2w = pose_spherical(theta, phi, radius)
            img = render_view(H, W, focal, c2w, variant=variant)
            rel = f"./{split}/r_{k}"
            write_png(os.path.join(scene_dir, rel + ".png"), img)
            frames.append(
                {"file_path": rel, "transform_matrix": c2w.tolist()}
            )
        with open(
            os.path.join(scene_dir, f"transforms_{split}.json"), "w"
        ) as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, f)
    return scene_dir


def generate_light_stage_capture(
    root: str,
    n_cams: int = 4,
    n_frames: int = 3,
    H: int = 48,
    W: int = 48,
    rig_radius: float = 3.0,
    seed: int = 0,
) -> str:
    """Write a synthetic light-stage capture (the JAX package's generator,
    ZJU-MoCap's ``annots.npy`` schema): per-camera K/D/R/T (T in
    millimetres), per-frame image lists, ``images/`` + ``mask/`` trees and
    per-frame ``new_vertices/{f}.npy`` samples of a sphere drifting over
    time. The frames are PNG (the JAX package writes JPEG through Pillow,
    which the card's machine lacks), so the pixels are exactly the arrays
    the JAX generator encodes. Returns ``root``."""
    del seed  # the capture is deterministic (the JAX signature keeps it)
    os.makedirs(os.path.join(root, "new_vertices"), exist_ok=True)

    focal = 1.2 * W
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float64)

    # ring of inward-looking cameras (world→camera R, T)
    cams = {"K": [], "D": [], "R": [], "T": []}
    exts = []
    for c in range(n_cams):
        ang = 2 * np.pi * c / n_cams
        center = np.array(
            [rig_radius * np.cos(ang), rig_radius * np.sin(ang), 0.3]
        )
        fwd = -center / np.linalg.norm(center)          # camera +z looks in
        right = np.cross(np.array([0.0, 0.0, 1.0]), fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd])                 # rows: cam axes
        T = (-R @ center).reshape(3, 1)
        cams["K"].append(K.tolist())
        cams["D"].append(np.zeros((5, 1)).tolist())
        cams["R"].append(R.tolist())
        cams["T"].append((T * 1000.0).tolist())          # millimetres
        exts.append((R, T.reshape(3)))

    sphere_r = 0.5
    ims = []
    for f in range(n_frames):
        center = np.array([0.3 * np.sin(f), 0.3 * np.cos(f), 0.1 * f])
        # fibonacci-sphere surface samples as the frame's "SMPL vertices"
        i = np.arange(256, dtype=np.float64)
        phi = np.arccos(1 - 2 * (i + 0.5) / 256)
        theta = np.pi * (1 + 5**0.5) * i
        verts = center + sphere_r * np.stack(
            [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
             np.cos(phi)], -1
        )
        np.save(os.path.join(root, "new_vertices", f"{f}.npy"), verts)

        frame_paths = []
        for c, (R, T) in enumerate(exts):
            ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
            d_cam = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K).T
            d = d_cam @ R        # R^T from the right
            d /= np.linalg.norm(d, axis=-1, keepdims=True)
            o = (-R.T @ T).reshape(1, 1, 3)
            t = _intersect_sphere(
                o.reshape(-1, 3).repeat(H * W, 0).reshape(H, W, 3), d,
                center, sphere_r,
            )
            hit = np.isfinite(t)
            p = o + np.where(hit, t, 0.0)[..., None] * d
            n = (p - center) / sphere_r
            rgb = np.where(hit[..., None], 0.5 * (n + 1.0), 0.0)
            img_rel = os.path.join("images", f"cam{c}", f"{f:04d}.png")
            msk_rel = os.path.join("mask", f"cam{c}", f"{f:04d}.png")
            write_png(os.path.join(root, img_rel),
                      (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
            write_png(os.path.join(root, msk_rel),
                      (hit * 255).astype(np.uint8))
            frame_paths.append(img_rel)
        ims.append({"ims": frame_paths})

    np.save(
        os.path.join(root, "annots.npy"),
        np.array({"cams": cams, "ims": ims}, dtype=object),
    )
    return root


def write_real_capture(scene_dir: str, out: str = "transforms.json") -> str:
    """Re-express a Blender-format scene (``generate_scene``'s) as one
    real-capture ``transforms.json`` (``datasets/real.py``): every train and
    test frame in one list, calibrated intrinsics ``fl_x/fl_y/cx/cy`` and
    ``w/h`` at the top level, file paths with their ``.png``. Returns the
    file's path."""
    frames = []
    for split in ("train", "test"):
        with open(os.path.join(scene_dir, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        for fr in meta["frames"]:
            rel = fr["file_path"]
            rel = rel[2:] if rel.startswith("./") else rel
            frames.append({"file_path": rel + ".png",
                           "transform_matrix": fr["transform_matrix"]})
    W, H = png_size(os.path.join(scene_dir, frames[0]["file_path"]))
    focal = 0.5 * W / float(np.tan(0.5 * meta["camera_angle_x"]))
    path = os.path.join(scene_dir, out)
    with open(path, "w") as f:
        json.dump({"w": W, "h": H, "fl_x": focal, "fl_y": focal,
                   "cx": 0.5 * W, "cy": 0.5 * H, "frames": frames}, f)
    return path


def ensure_scene(root: str, scene: str = "procedural", H: int = 64,
                 W: int = 64, n_train: int = 20, n_test: int = 4) -> str:
    """Generate the scene unless an up-to-date one already exists.

    A dir left by an earlier run at a different resolution or view count
    would silently train on the wrong scene (or trip the dataset's
    capture-size guard) — verify the first train image's size and both
    splits' frame counts, and regenerate on any mismatch.
    """
    scene_dir = os.path.join(root, scene)
    tjson = os.path.join(scene_dir, "transforms_train.json")
    stale = not os.path.exists(tjson)
    if not stale:
        def frames(split):
            p = os.path.join(scene_dir, f"transforms_{split}.json")
            if not os.path.exists(p):
                return -1
            with open(p) as f:
                return len(json.load(f).get("frames", []))

        first = os.path.join(scene_dir, "train", "r_0.png")
        if (not os.path.exists(first) or frames("train") != n_train
                or frames("test") != n_test):
            stale = True
        else:
            stale = png_size(first) != (W, H)
        if stale:
            import shutil

            shutil.rmtree(scene_dir)
            print(f"scene at {scene_dir} is stale; regenerating", flush=True)
    if stale:
        print(f"generating {n_train}-view {H}x{W} scene …", flush=True)
        generate_scene(root, scene=scene, H=H, W=W, n_train=n_train,
                       n_test=n_test)
    return scene_dir
