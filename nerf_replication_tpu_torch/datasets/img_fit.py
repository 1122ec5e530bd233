"""img_fit dataset: the 2-D image-regression warm-up task (port of
``nerf_replication_tpu/datasets/img_fit.py``).

One view of a Blender-format scene, the ``(u, v)`` pixel grid normalized to
[0, 1] and its colours: :meth:`Dataset.ray_bank` hands the flat (uv, rgb)
arrays to the trainer, which samples batches on the device (the batch's
``rays`` slot carries uv). The frame is decoded by the port's PNG codec and
composited onto white; ``input_ratio`` resizes it with
``utils.image.resize_area`` (OpenCV's INTER_AREA, bitwise).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from ..utils.image import read_png, resize_area
from .blender import _to_rgba_uint8


def _uv_grid(h: int, w: int) -> np.ndarray:
    """[h·w, 2] normalized (u, v) pixel coordinates in [0, 1]."""
    X, Y = np.meshgrid(np.arange(w), np.arange(h))
    u = X.astype(np.float32) / max(w - 1, 1)
    v = Y.astype(np.float32) / max(h - 1, 1)
    return np.stack([u, v], -1).reshape(-1, 2)


@dataclass
class Dataset:
    data_root: str
    scene: str
    split: str = "train"
    view: int = 0
    input_ratio: float = 1.0

    img: np.ndarray = field(init=False)  # [H, W, 3]
    uv: np.ndarray = field(init=False)  # [H*W, 2]
    H: int = field(init=False)
    W: int = field(init=False)
    batch_size: int = 8192

    def __post_init__(self):
        scene_dir = os.path.join(self.data_root, self.scene)
        with open(os.path.join(scene_dir, "transforms_train.json")) as f:
            meta = json.load(f)
        rel = meta["frames"][self.view]["file_path"]
        rel = rel[2:] if rel.startswith("./") else rel
        img = _to_rgba_uint8(read_png(os.path.join(scene_dir, rel + ".png")))
        img = (img / 255.0).astype(np.float32)
        img = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
        if self.input_ratio != 1.0:
            r = self.input_ratio
            h, w = img.shape[:2]
            img = resize_area(img, int(np.rint(w * r)), int(np.rint(h * r)),
                              fx=r, fy=r)
        self.img = img.astype(np.float32)
        self.H, self.W = img.shape[:2]
        self.uv = _uv_grid(self.H, self.W)

    @classmethod
    def from_cfg(cls, cfg, split: str) -> "Dataset":
        node = cfg.train_dataset if split == "train" else cfg.test_dataset
        ds = cls(
            data_root=node.data_root,
            scene=cfg.scene,
            split=node.get("split", split),
            view=int(node.get("view", 0)),
            input_ratio=float(node.get("input_ratio", 1.0)),
        )
        ds.batch_size = int(cfg.task_arg.get("N_pixels", 8192))
        return ds

    def ray_bank(self):
        """(uv [N, 2], rgb [N, 3]) — the trainer's bank contract."""
        return self.uv, self.img.reshape(-1, 3)

    def __len__(self) -> int:
        return 1  # one image

    def image_batch(self, index: int = 0) -> dict:
        return {
            "uv": self.uv,
            "rays": self.uv,  # the trainer's name for the inputs
            "rgb": self.img.reshape(-1, 3),
            "rgbs": self.img.reshape(-1, 3),
            "near": np.float32(0.0),
            "far": np.float32(1.0),
            "i": index,
            "meta": {"H": self.H, "W": self.W},
        }

    def __getitem__(self, index) -> dict:
        if isinstance(index, tuple):
            # the image_size batch sampler's (index, h, w): a resized item,
            # pixels drawn from numpy's global RNG as in JAX
            index, h, w = index
            img = resize_area(self.img, w, h).reshape(-1, 3)
            uv = _uv_grid(h, w)
            ids = np.random.choice(
                h * w, min(self.batch_size, h * w), replace=False
            )
            return {"uv": uv[ids], "rgb": img[ids], "meta": {"H": h, "W": w}}
        if self.split == "train":
            ids = np.random.choice(len(self.uv), self.batch_size, replace=False)
            return {
                "uv": self.uv[ids],
                "rgb": self.img.reshape(-1, 3)[ids],
                "meta": {"H": self.H, "W": self.W},
            }
        return self.image_batch(index)
