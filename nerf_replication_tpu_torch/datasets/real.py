"""Real-capture dataset: one colmap2nerf ``transforms.json`` → ray bank
(port of ``nerf_replication_tpu/datasets/real.py``).

* ONE ``transforms.json`` for the whole capture: the split is a holdout —
  every ``test_hold``-th frame is test, the rest train (LLFF's
  ``llffhold=8``).
* Calibrated intrinsics ``fl_x/fl_y/cx/cy`` + ``w/h`` at the top level or
  per frame (per-frame keys win, each in its own pixel units), honoured in
  ray generation (``rays.get_rays_np``); frames of another size are resized
  to the bank's with ``utils.image.resize_area`` (OpenCV's INTER_AREA).
* ``file_path`` entries keep their extension; ``utils.image.read_image``
  decodes PNG and baseline JPEG (sequential Huffman, 8-bit, 4:4:4 / 4:2:2 /
  4:2:0, as Pillow decodes them) by the port's own codecs, whatever the
  extension says; a progressive or arithmetic-coded JPEG raises naming its
  marker, and other formats need Pillow.
* ``ndc: true`` for forward-facing captures: rays in normalized device
  coordinates (``rays.ndc_rays_np``) and ray-space bounds 0 / 1, which the
  config must state (``configs/real/capture_ndc.yaml``).
* A capture whose frames all share one focal and a centred principal point
  (no NDC) builds its bank with the bank builder (``native``: C++ where g++
  is present; ``bank_builder`` says which), bit for bit the per-frame
  rays and colours the JAX package makes; any other capture builds them
  frame by frame (``bank_builder == "per_frame"``).

Lens distortion recorded by the converter is not applied, as in JAX. Same
contract as ``datasets.blender.Dataset`` (``ray_bank()``, ``image_batch``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from ..utils.image import read_image, resize_area
from .bank import RayBankDataset
from .blender import _to_rgba_uint8
from .rays import get_rays_np, ndc_rays_np


@dataclass
class Dataset(RayBankDataset):
    data_root: str
    scene: str = ""
    split: str = "train"
    transforms: str = "transforms.json"
    test_hold: int = 8
    input_ratio: float = 1.0
    ndc: bool = False
    near: float = 2.0
    far: float = 6.0

    H: int = field(init=False)
    W: int = field(init=False)
    focal: float = field(init=False)
    rays: np.ndarray = field(init=False)
    rgbs: np.ndarray = field(init=False)
    poses: np.ndarray = field(init=False)
    n_images: int = field(init=False)
    bank_builder: str = field(init=False)  # native | numpy | per_frame

    def _transforms_path(self) -> str:
        cands = [
            os.path.join(self.data_root, self.scene, self.transforms),
            os.path.join(self.data_root, self.transforms),
        ]
        for c in cands:
            if os.path.exists(c):
                return c
        raise FileNotFoundError(
            f"no {self.transforms} under {self.data_root!r} "
            f"(scene={self.scene!r}); write it with the JAX package's "
            "scripts/colmap2nerf.py first"
        )

    def __post_init__(self):
        path = self._transforms_path()
        base = os.path.dirname(path)
        with open(path, "r") as f:
            meta = json.load(f)

        frames = meta["frames"]
        hold = max(int(self.test_hold), 1)
        test_idx = set(range(0, len(frames), hold))
        if self.split == "train":
            frames = [f for i, f in enumerate(frames) if i not in test_idx]
        else:
            frames = [f for i, f in enumerate(frames) if i in test_idx]
        if not frames:
            raise ValueError(
                f"split={self.split!r} with test_hold={hold} selected no "
                f"frames out of {len(meta['frames'])}"
            )

        W0 = int(meta.get("w", 0)) or None
        H0 = int(meta.get("h", 0)) or None

        images, pose_list, ray_o, ray_d = [], [], [], []
        bank_focal = None
        pinhole = []  # per frame: one focal, centred principal point
        for frame in frames:
            fp = frame["file_path"]
            root, ext = os.path.splitext(fp)
            if not ext:  # blender-style extensionless path
                fp = fp + ".png"
            img = _to_rgba_uint8(read_image(os.path.join(base, fp)))
            h, w = img.shape[:2]
            if H0 is None:
                H0, W0 = h, w
            H = int(H0 * self.input_ratio)
            W = int(W0 * self.input_ratio)

            # Intrinsics carry their provenance's pixel units: per-frame keys
            # are in THIS frame's native (h, w) pixels, capture-level keys in
            # the top-level (meta h/w) pixels. Each is scaled by its own
            # units→bank factor, so a second camera's frames (different
            # native size, per-frame intrinsics) and capture-level fallbacks
            # both land in bank pixels.
            sx_f, sy_f = W / w, H / h
            sx_c, sy_c = W / W0, H / H0

            def intr(key, s_frame, s_cap, default=None):
                if key in frame:
                    return float(frame[key]) * s_frame
                if key in meta:
                    return float(meta[key]) * s_cap
                if default is None:
                    raise KeyError(f"transforms.json lacks intrinsic {key!r}")
                return default  # already bank-scale

            fl_x = intr("fl_x", sx_f, sx_c)
            fl_y = intr("fl_y", sy_f, sy_c, default=fl_x)
            cx = intr("cx", sx_f, sx_c, default=0.5 * W)
            cy = intr("cy", sy_f, sy_c, default=0.5 * H)
            if bank_focal is None:
                bank_focal = fl_x

            if (h, w) != (H, W):
                img = resize_area(img, W, H)
            c2w = np.asarray(frame["transform_matrix"], dtype=np.float32)
            pinhole.append(fl_y == fl_x == bank_focal and cx == 0.5 * W
                           and cy == 0.5 * H)
            o, d = get_rays_np(H, W, fl_x, c2w, fl_y=fl_y, cx=cx, cy=cy)
            if self.ndc:
                # NDC wants the pre-projection focals of THIS capture
                o, d = ndc_rays_np(H, W, fl_x, 1.0, o, d, fl_y=fl_y)
            ray_o.append(o.reshape(-1, 3))
            ray_d.append(d.reshape(-1, 3))
            images.append(img)
            pose_list.append(c2w)

        self.H, self.W = int(H0 * self.input_ratio), int(W0 * self.input_ratio)
        # bank-scale focal of the first loaded frame (consistent with the
        # rays regardless of which camera that frame came from)
        self.focal = float(bank_focal)
        self.poses = np.stack(pose_list, 0)
        self.n_images = len(frames)
        if self.ndc:
            self.near, self.far = 0.0, 1.0

        if not self.ndc and all(pinhole):
            # the blender bank's camera: the bank builder (C++ where g++
            # built it) makes the same rays and colours bit for bit
            from ..native import build_ray_bank, native_available

            self.rays, self.rgbs = build_ray_bank(
                self.poses, np.stack(images, 0), self.focal)
            self.bank_builder = "native" if native_available() else "numpy"
            return
        self.bank_builder = "per_frame"
        rgba = np.stack(images, 0).astype(np.float32) / 255.0
        # white-background compositing, as the blender bank builder does
        rgb = rgba[..., :3] * rgba[..., 3:4] + (1.0 - rgba[..., 3:4])
        self.rays = np.concatenate(
            [np.concatenate(ray_o, 0), np.concatenate(ray_d, 0)], axis=-1
        ).astype(np.float32)
        self.rgbs = rgb.reshape(-1, 3).astype(np.float32)

    @classmethod
    def from_cfg(cls, cfg, split: str) -> "Dataset":
        node = cfg.train_dataset if split == "train" else cfg.test_dataset
        ndc = bool(node.get("ndc", cfg.task_arg.get("ndc", False)))
        if ndc:
            near = float(cfg.task_arg.get("near", 2.0))
            far = float(cfg.task_arg.get("far", 6.0))
            if near != 0.0 or far != 1.0:
                # the Trainer samples cfg.task_arg bounds — a mismatch would
                # silently place every sample outside the NDC [0,1] frustum
                raise ValueError(
                    "ndc=true requires task_arg.near: 0.0 and task_arg.far: "
                    f"1.0 (got near={near}, far={far}); see "
                    "configs/real/capture_ndc.yaml"
                )
        return cls(
            data_root=node.data_root,
            scene=cfg.scene,
            split=node.get("split", split),
            transforms=node.get("transforms", "transforms.json"),
            test_hold=int(node.get("test_hold", 8)),
            input_ratio=float(node.get("input_ratio", 1.0)),
            ndc=ndc,
            near=float(cfg.task_arg.get("near", 2.0)),
            far=float(cfg.task_arg.get("far", 6.0)),
        )

    # ray_bank/precrop_index_pool/__len__/image_batch/__getitem__: RayBankDataset
