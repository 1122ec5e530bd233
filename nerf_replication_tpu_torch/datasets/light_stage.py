"""Light-stage / ZJU-MoCap multi-view capture dataset (port of
``nerf_replication_tpu/datasets/light_stage.py``).

A calibrated camera rig captured over time: ``annots.npy`` with per-camera
``K/D/R/T`` (T in millimetres) and per-frame image lists, foreground masks,
per-frame SMPL vertices that bound the subject, and rays ``[N, 7]`` whose
7th column is the frame's latent index (the time-conditioned encoders of
``models/encoding/dynamic.py`` read it as ``t``).

The training bank is built once, as in JAX: every interior foreground pixel
(a ``mask_border`` band around the silhouette excluded), then background
pixels inside the projected world-bbox hull resampled to the same count
(numpy ``default_rng(0)``), so a uniform draw is 50/50 fg/bg. Eval items load
lazily in :meth:`Dataset.image_batch`.

The JAX package reads images with Pillow and does its image work with
OpenCV; the card's machine has neither, so this module carries its own,
each held against OpenCV in ``tests/test_torch_light_stage.py``:

* frames and masks through ``utils.image.read_image``: PNG and baseline
  JPEG (sequential Huffman, 8-bit, 4:4:4 / 4:2:2 / 4:2:0) by the port's
  own codecs, as Pillow decodes them; a progressive or arithmetic-coded
  JPEG raises naming its marker; any other format through Pillow when it
  is importable, else an error naming the file;
* :func:`erode_dilate_band` (``cv2.erode`` / ``cv2.dilate`` with a square
  kernel, OpenCV's border rule: outside pixels never win), bitwise;
* :func:`fill_convex_poly` + :func:`convex_hull` (``cv2.convexHull`` +
  ``cv2.fillConvexPoly``: OpenCV's scan-line fill and 8-connected edge
  lines, in its fixed-point arithmetic), bitwise;
* ``utils.image.resize_nearest`` / ``resize_area`` (``INTER_NEAREST`` /
  ``INTER_AREA``), bitwise;
* :func:`undistort` (``cv2.undistort``): zero distortion returns the image
  unchanged, which is what OpenCV returns (bitwise); otherwise the
  5-coefficient model (k1, k2, p1, p2, k3) inverted per pixel as
  ``initUndistortRectifyMap`` does, then a bilinear remap in float64 —
  OpenCV's remap quantizes positions to 1/32 px, so the two differ by
  at most the stated ``UNDISTORT_TOL`` of the value range.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..utils.image import read_image, resize_area, resize_nearest

# |port − cv2| of undistort with non-zero D, as a fraction of the value
# range (a float image in [0, 1]; a uint8 image: 255)
UNDISTORT_TOL = 0.02


def _rgb(img: np.ndarray) -> np.ndarray:
    """Pillow's ``convert("RGB")`` of a decoded image: gray repeated,
    alpha dropped."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 4:
        return img[..., :3]
    return img


def _bbox_corners(wbbox: np.ndarray) -> np.ndarray:
    """[8, 3] corner points of a [lo(3), hi(3)] world bbox."""
    lo, hi = wbbox[:3], wbbox[3:6]
    return np.array(
        [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
         for z in (lo[2], hi[2])]
    )


# -- OpenCV's image operations ----------------------------------------------------


def _window(msk: np.ndarray, k: int, reduce) -> np.ndarray:
    """``reduce`` over the k x k window anchored at its centre (OpenCV's
    default anchor); edge replication never changes a min or a max, which
    is OpenCV's border rule for erode and dilate."""
    from numpy.lib.stride_tricks import sliding_window_view

    before, after = k // 2, k - 1 - k // 2
    pad = np.pad(msk, ((before, after), (before, after)), mode="edge")
    return reduce(sliding_window_view(pad, (k, k)), axis=(-2, -1))


def erode_dilate_band(msk: np.ndarray, border: int = 5) -> np.ndarray:
    """Mark the boundary band of a binary uint8 mask with 100: where the
    ``border`` x ``border`` dilation and erosion differ by one."""
    eroded = _window(msk, border, np.min)
    dilated = _window(msk, border, np.max)
    out = msk.copy()
    out[(dilated - eroded) == 1] = 100
    return out


def convex_hull(pts: np.ndarray) -> np.ndarray:
    """Integer points ``[n, 2]`` → their convex hull, collinear points
    dropped (Andrew's monotone chain)."""
    p = sorted(set(map(tuple, np.asarray(pts, np.int64).tolist())))
    if len(p) <= 2:
        return np.asarray(p, np.int64)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower, upper = [], []
    for q in p:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], q) <= 0:
            lower.pop()
        lower.append(q)
    for q in reversed(p):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], q) <= 0:
            upper.pop()
        upper.append(q)
    return np.asarray(lower[:-1] + upper[:-1], np.int64)


def _clip_line(w: int, h: int, p1, p2):
    """OpenCV's ``clipLine``: the segment clipped to the image, or None."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def _line8(img: np.ndarray, p1, p2, value) -> None:
    """OpenCV's 8-connected ``Line`` (its ``LineIterator``, left to right)."""
    h, w = img.shape[:2]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h
            and 0 <= p2[1] < h):
        clipped = _clip_line(w, h, p1, p2)
        if clipped is None:
            return
        p1, p2 = clipped
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:
        dx, dy, p1 = -dx, -dy, p2
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, plus, minus = dx - 2 * dy, 2 * dx, -2 * dy
    x, y = p1
    for _ in range(dx + 1):
        img[y, x] = value
        step = err < 0
        err += minus + (plus if step else 0)
        if vert:
            y += sy
            x += sx if step else 0
        else:
            x += sx
            y += sy if step else 0


def fill_convex_poly(img: np.ndarray, poly: np.ndarray, value) -> np.ndarray:
    """``cv2.fillConvexPoly(img, poly, value)`` (8-connected, no shift) in
    place: the edge lines, then OpenCV's scan-line fill in 16.16 fixed
    point between the two chains from the topmost vertex."""
    v = [tuple(int(c) for c in p) for p in np.asarray(poly).reshape(-1, 2)]
    n = len(v)
    h, w = img.shape[:2]
    shift, one = 16, 1 << 16
    half = one >> 1
    p0 = v[-1]
    for p in v:
        _line8(img, p0, p, value)
        p0 = p
    ys = [p[1] for p in v]
    xs = [p[0] for p in v]
    imin = int(np.argmin(ys))
    ymin, ymax, xmin, xmax = min(ys), max(ys), min(xs), max(xs)
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return img
    ymax = min(ymax, h - 1)
    edges = n
    edge = [{"idx": imin, "di": 1, "x": -one, "dx": 0, "ye": ymin},
            {"idx": imin, "di": n - 1, "x": -one, "dx": 0, "ye": ymin}]
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % n
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = v[idx][1]
                    if ty > y:
                        xs_, xe = v[idx0][0] << shift, v[idx][0] << shift
                        num, den = (xe - xs_) * 2 + (ty - y), 2 * (ty - y)
                        e["ye"] = ty
                        e["dx"] = int(num / den) if abs(num) < 2**52 else \
                            (abs(num) // den) * (1 if num >= 0 else -1)
                        e["x"] = xs_
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            x1 = (edge[left]["x"] + half) >> shift
            x2 = (edge[right]["x"] + half) >> shift
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = value
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break
    return img


def _project_bbox_hull_mask(wbbox: np.ndarray, K: np.ndarray,
                            ext: np.ndarray, H: int, W: int) -> np.ndarray:
    """Binary mask of the world bbox's projected convex hull."""
    corners = _bbox_corners(wbbox)
    cam = corners @ ext[:3, :3].T + ext[:3, 3]
    # guard: corners behind the camera would project nonsensically
    cam[:, 2] = np.maximum(cam[:, 2], 1e-6)
    pix = cam @ K.T
    pix = (pix[:, :2] / pix[:, 2:3]).astype(np.int32)
    mask = np.zeros((H, W), np.uint8)
    return fill_convex_poly(mask, convex_hull(pix), 1)


def _bilinear(img: np.ndarray, mx: np.ndarray, my: np.ndarray) -> np.ndarray:
    """Bilinear samples of ``img`` at float positions, zero outside."""
    h, w = img.shape[:2]
    src = img.astype(np.float64)
    if src.ndim == 2:
        src = src[..., None]
    x0, y0 = np.floor(mx).astype(np.int64), np.floor(my).astype(np.int64)
    fx, fy = (mx - x0)[..., None], (my - y0)[..., None]
    out = np.zeros(mx.shape + (src.shape[-1],), np.float64)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xx, yy = x0 + dx, y0 + dy
            ok = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
            val = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
            out += np.where(ok[..., None], val, 0.0) * wx * wy
    return out if img.ndim == 3 else out[..., 0]


def undistort(img: np.ndarray, K: np.ndarray, D: np.ndarray) -> np.ndarray:
    """``cv2.undistort(img, K, D)`` (the new camera matrix = K). Zero ``D``
    returns ``img`` unchanged (OpenCV's output then equals its input);
    otherwise each output pixel samples the input at its distorted
    position (k1, k2, p1, p2, k3) bilinearly, zero outside."""
    d = np.zeros(5)
    flat = np.asarray(D, np.float64).reshape(-1)
    d[:min(5, flat.size)] = flat[:5]
    if not np.any(d):
        return img.copy()
    k1, k2, p1, p2, k3 = d
    h, w = img.shape[:2]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    x, y = (xs - cx) / fx, (ys - cy) / fy
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    out = _bilinear(img, xd * fx + cx, yd * fy + cy)
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(img.dtype)


@dataclass
class Dataset:
    """One split of a light-stage capture rooted at ``data_root``."""

    data_root: str
    split: str = "train"
    cameras: tuple = (0, -1, 1)   # [start, end, skip] over the rig
    frames: tuple = (0, -1, 1)    # [start, end, skip] over time
    input_ratio: float = 1.0
    mask_border: int = 5
    scene: str = ""               # registry/catalog compatibility; unused

    H: int = field(init=False)
    W: int = field(init=False)
    near: float = field(init=False)
    far: float = field(init=False)
    wbbox: np.ndarray = field(init=False)

    def __post_init__(self):
        annots = np.load(
            os.path.join(self.data_root, "annots.npy"), allow_pickle=True
        ).item()
        self.cams = annots["cams"]
        n_cams = len(self.cams["K"])
        c0, c1, cs = self.cameras
        c1 = n_cams if c1 == -1 else c1
        self.camera_ids = list(range(n_cams))[c0:c1:cs]

        n_frames = len(annots["ims"])
        f0, f1, fs = self.frames
        f1 = n_frames if f1 == -1 else f1
        self.frame_ids = list(range(n_frames))[f0:f1:fs]
        # latent index = position within the selected frame range
        self._latent = {f: i for i, f in enumerate(self.frame_ids)}

        # per-frame SMPL-vertex bbox (±5 cm), world bbox over all frames
        bboxes = []
        for f in self.frame_ids:
            verts = np.load(
                os.path.join(self.data_root, "new_vertices", f"{f}.npy")
            )
            bboxes.append(
                np.concatenate([verts.min(0) - 0.05, verts.max(0) + 0.05])
            )
        bboxes = np.stack(bboxes)
        self.wbbox = np.concatenate(
            [bboxes[:, :3].min(0), bboxes[:, 3:6].max(0)]
        ).astype(np.float32)

        self.items = [
            {"frame": f, "camera": c, "path": annots["ims"][f]["ims"][c]}
            for f in self.frame_ids
            for c in self.camera_ids
        ]
        self._load_all()
        self._derive_bounds()

    # ---- image/mask loading ------------------------------------------------
    def _mask_path(self, rel: str) -> str:
        """mask_cihp > mask > images→mask substitution, all with .png."""
        stem = os.path.splitext(rel)[0] + ".png"
        for cand in (
            os.path.join(self.data_root, "mask_cihp", stem),
            os.path.join(self.data_root, "mask", stem),
            os.path.join(self.data_root, stem.replace("images", "mask")),
        ):
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(f"no mask found for {rel}")

    def _read_item(self, item):
        img = _rgb(read_image(os.path.join(self.data_root, item["path"])))
        img = img.astype(np.float32) / 255.0
        H, W = img.shape[:2]
        msk = read_image(self._mask_path(item["path"]))
        if msk.ndim == 3:
            msk = msk[..., 0]
        msk = resize_nearest((msk != 0).astype(np.uint8), W, H)

        K = np.array(self.cams["K"][item["camera"]], np.float64).copy()
        D = np.array(self.cams["D"][item["camera"]], np.float64)
        img = undistort(img, K, D)
        msk = undistort(msk, K, D)

        if self.input_ratio != 1.0:
            r = self.input_ratio
            w2, h2 = int(np.rint(W * r)), int(np.rint(H * r))
            img = resize_area(img, w2, h2, fx=r, fy=r)
            msk = resize_nearest(msk, w2, h2, fx=r, fy=r)
            K[:2] *= self.input_ratio

        img = img.copy()
        img[msk == 0] = 0.0
        msk = erode_dilate_band(msk, self.mask_border)

        R = np.array(self.cams["R"][item["camera"]], np.float64)
        T = np.array(self.cams["T"][item["camera"]], np.float64).reshape(3, 1)
        T = T / 1000.0  # ZJU annots store millimetres
        ext = np.concatenate([R, T], axis=1)  # world→camera [3,4]
        return img, msk, K, ext

    def _rays_for(self, K, ext, ys, xs, latent: int):
        """[len(ys), 7] world rays through pixel centers + latent column."""
        c2w = np.eye(4)
        c2w[:3] = ext
        c2w = np.linalg.inv(c2w)
        d_pix = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64)
        d = d_pix @ np.linalg.inv(K).T @ c2w[:3, :3].T
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.broadcast_to(c2w[:3, 3], d.shape)
        t = np.full((len(d_pix), 1), float(latent))
        return np.concatenate([o, d, t], -1).astype(np.float32)

    def _load_all(self):
        self.n_images = len(self.items)
        if self.split != "train":
            # eval items load lazily in image_batch; one read publishes H/W
            img, _, _, _ = self._read_item(self.items[0])
            self.H, self.W = img.shape[:2]
            return

        fg_rays, fg_rgbs, bg_rays, bg_rgbs = [], [], [], []
        rng = np.random.default_rng(0)
        for item in self.items:
            img, msk, K, ext = self._read_item(item)
            H, W = img.shape[:2]
            latent = self._latent[item["frame"]]

            ys, xs = np.nonzero(msk == 1)  # interior fg, band excluded
            fg_rays.append(self._rays_for(K, ext, ys, xs, latent))
            fg_rgbs.append(img[ys, xs])

            hull = _project_bbox_hull_mask(self.wbbox, K, ext, H, W)
            ys_b, xs_b = np.nonzero(hull == 1)
            bg_rays.append(self._rays_for(K, ext, ys_b, xs_b, latent))
            bg_rgbs.append(img[ys_b, xs_b])

        fg_r = np.concatenate(fg_rays)
        fg_c = np.concatenate(fg_rgbs)
        bg_r = np.concatenate(bg_rays)
        bg_c = np.concatenate(bg_rgbs)
        # two equal segments: a uniform draw is 50/50 fg/bg in expectation
        idx = rng.integers(0, len(bg_r), size=len(fg_r))
        self.rays = np.concatenate([fg_r, bg_r[idx]])
        self.rgbs = np.concatenate([fg_c, bg_c[idx]]).astype(np.float32)
        self.H, self.W = H, W

    def _derive_bounds(self):
        """Scalar near/far from camera-to-bbox-corner distances."""
        corners = _bbox_corners(self.wbbox)
        dists = []
        for c in self.camera_ids:
            R = np.array(self.cams["R"][c], np.float64)
            T = np.array(self.cams["T"][c], np.float64).reshape(3) / 1000.0
            center = -R.T @ T
            dists.append(np.linalg.norm(corners - center, axis=-1))
        dists = np.stack(dists)
        self.near = float(max(dists.min() * 0.8, 0.05))
        self.far = float(dists.max() * 1.2)

    # ---- framework contract ------------------------------------------------
    def ray_bank(self):
        return self.rays, self.rgbs

    def __len__(self) -> int:
        if self.split == "train":
            return 1_000_000
        return len(self.items)

    def image_batch(self, index: int) -> dict:
        """One whole eval image, loaded and ray-gridded on demand."""
        item = self.items[index]
        img, msk, K, ext = self._read_item(item)
        H, W = img.shape[:2]
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
        rays = self._rays_for(
            K, ext, ys.ravel(), xs.ravel(), self._latent[item["frame"]]
        )
        return {
            "rays": rays,
            "rgbs": img.reshape(-1, 3),
            "near": np.float32(self.near),
            "far": np.float32(self.far),
            "i": index,
            "meta": {"H": H, "W": W},
            "mask": msk,
            "wbounds": self.wbbox,
        }

    @classmethod
    def from_cfg(cls, cfg, split: str) -> "Dataset":
        node = cfg.train_dataset if split == "train" else cfg.test_dataset
        return cls(
            data_root=node.data_root,
            split=node.get("split", split),
            cameras=tuple(node.get("cameras", [0, -1, 1])),
            frames=tuple(node.get("frames", [0, -1, 1])),
            input_ratio=float(node.get("input_ratio", 1.0)),
            scene=cfg.get("scene", ""),
        )


def make_dataset(cfg, split: str) -> Dataset:
    return Dataset.from_cfg(cfg, split)
