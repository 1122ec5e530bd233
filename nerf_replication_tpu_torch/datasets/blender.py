"""Blender-synthetic (NeRF) dataset: transforms_{split}.json + PNG frames.

Port of ``nerf_replication_tpu/datasets/blender.py``. :class:`Dataset`
materializes the full ray bank of a split as flat numpy arrays — ``rays
[N, 6]`` and ``rgbs [N, 3]`` — which the trainer moves to the device once and
draws every batch from there, plus the test-time ``image_batch`` contract
(:class:`~.bank.RayBankDataset`). Frames are decoded by the port's PNG codec
(``utils/image.py``) and normalized to uint8 RGBA as the JAX package does;
``input_ratio != 1`` downscales each uint8 frame to ``int(H·ratio)`` x
``int(W·ratio)`` with ``utils.image.resize_area`` (OpenCV's INTER_AREA,
bitwise) and scales the focal by the ratio.

:class:`Camera` is the camera metadata alone (H/W/focal/near/far from the
config and ``camera_angle_x``), which serving needs and which reads no image.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from ..utils.image import read_png, resize_area
from .bank import RayBankDataset
from .rays import focal_from_fov


def _to_rgba_uint8(img: np.ndarray) -> np.ndarray:
    """Normalize decoded frames to uint8 RGBA: gray expanded, RGB given
    opaque alpha, so frames with mixed channel counts stack uniformly."""
    if img.dtype != np.uint8:
        raise ValueError(f"unsupported image dtype {img.dtype}")
    if img.ndim == 2:  # grayscale
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 2:  # luminance + alpha
        img = np.concatenate([np.repeat(img[..., :1], 3, axis=-1),
                              img[..., 1:]], axis=-1)
    if img.shape[-1] == 3:  # opaque alpha: composite is then a no-op
        img = np.concatenate(
            [img, np.full_like(img[..., :1], 255)], axis=-1
        )
    if img.shape[-1] != 4:
        raise ValueError(f"unsupported channel count {img.shape[-1]}")
    return img


def _split_node(cfg, split: str):
    return cfg.train_dataset if split == "train" else cfg.test_dataset


@dataclass
class Camera:
    """Camera metadata of one split of a Blender-format scene."""

    data_root: str
    scene: str
    split: str = "test"
    input_ratio: float = 1.0
    H: int = 800
    W: int = 800
    near: float = 2.0
    far: float = 6.0

    focal: float = field(init=False)

    def __post_init__(self):
        path = os.path.join(
            self.data_root, self.scene, f"transforms_{self.split}.json"
        )
        with open(path, "r") as f:
            meta = json.load(f)
        H_orig, W_orig = self.H, self.W
        self.H = int(H_orig * self.input_ratio)
        self.W = int(W_orig * self.input_ratio)
        self.focal = focal_from_fov(W_orig, float(meta["camera_angle_x"])) * (
            self.input_ratio
        )

    @classmethod
    def from_cfg(cls, cfg, split: str) -> "Camera":
        node = _split_node(cfg, split)
        return cls(
            data_root=node.data_root,
            scene=cfg.scene,
            split=node.get("split", split),
            input_ratio=float(node.get("input_ratio", 1.0)),
            H=int(node.get("H", 800)),
            W=int(node.get("W", 800)),
            near=float(cfg.task_arg.near),
            far=float(cfg.task_arg.far),
        )


@dataclass
class Dataset(RayBankDataset):
    """One split of a Blender-format scene, fully materialized in host RAM."""

    data_root: str
    scene: str
    split: str = "train"
    input_ratio: float = 1.0
    cams: tuple | list | None = None
    H: int = 800
    W: int = 800
    near: float = 2.0
    far: float = 6.0

    # populated by __post_init__
    focal: float = field(init=False)
    rays: np.ndarray = field(init=False)  # [N_total, 6]
    rgbs: np.ndarray = field(init=False)  # [N_total, 3]
    poses: np.ndarray = field(init=False)  # [n_images, 4, 4]
    n_images: int = field(init=False)

    def __post_init__(self):
        path = os.path.join(self.data_root, self.scene,
                            f"transforms_{self.split}.json")
        with open(path, "r") as f:
            meta = json.load(f)

        frames = meta["frames"]
        if self.cams is not None:
            start, stop, step = self.cams
            if stop == -1:
                stop = len(frames)
            frames = frames[start:stop:step]
        if not frames:
            raise ValueError(f"cams={self.cams} selected no frames from {path}")

        H_orig, W_orig = self.H, self.W
        self.H = int(H_orig * self.input_ratio)
        self.W = int(W_orig * self.input_ratio)
        self.focal = focal_from_fov(W_orig, float(meta["camera_angle_x"])) * (
            self.input_ratio
        )
        raw_images, pose_list = [], []
        for frame in frames:
            img_path = os.path.join(
                self.data_root, self.scene, frame["file_path"] + ".png"
            )
            img = _to_rgba_uint8(read_png(img_path))
            if img.shape[:2] != (H_orig, W_orig):
                # a mismatched capture would build rays with the wrong focal
                # and slicing: fail loudly, as the JAX package does
                raise ValueError(
                    f"{img_path}: image is {img.shape[1]}x{img.shape[0]} but "
                    f"the config expects {W_orig}x{H_orig} "
                    f"(train/test_dataset.H/W) — set H/W to the capture "
                    "resolution"
                )
            if self.input_ratio != 1.0:
                # a uint8 INTER_AREA downscale before the float conversion
                img = resize_area(img, self.W, self.H)
            raw_images.append(img)
            pose_list.append(
                np.asarray(frame["transform_matrix"], dtype=np.float32)
            )
        self.poses = np.stack(pose_list, axis=0)
        self.n_images = len(pose_list)

        from ..native import build_ray_bank

        self.rays, self.rgbs = build_ray_bank(
            self.poses, np.stack(raw_images, 0), self.focal
        )

    @classmethod
    def from_cfg(cls, cfg, split: str) -> "Dataset":
        """Build from the reference-schema config (train_dataset/test_dataset)."""
        node = _split_node(cfg, split)
        return cls(
            data_root=node.data_root,
            scene=cfg.scene,
            split=node.get("split", split),
            input_ratio=float(node.get("input_ratio", 1.0)),
            cams=node.get("cams", None),
            H=int(node.get("H", 800)),
            W=int(node.get("W", 800)),
            near=float(cfg.task_arg.near),
            far=float(cfg.task_arg.far),
        )

    # ray_bank/precrop_index_pool/__len__/image_batch/__getitem__: RayBankDataset
