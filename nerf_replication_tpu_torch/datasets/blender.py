"""Blender-synthetic camera metadata (the serving subset of
``nerf_replication_tpu/datasets/blender.py``).

Serving renders novel views, so it needs the test split's camera and the
march bounds but no images and no ray bank: near/far come from ``task_arg``,
H/W from the config, and the focal length from ``transforms_test.json``'s
``camera_angle_x`` (scaled by ``input_ratio``, as the JAX dataset does). No
image decoder is imported.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from .rays import focal_from_fov


@dataclass
class Dataset:
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
    def from_cfg(cls, cfg, split: str) -> "Dataset":
        node = cfg.train_dataset if split == "train" else cfg.test_dataset
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
