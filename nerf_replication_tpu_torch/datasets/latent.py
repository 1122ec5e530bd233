"""Latent-vector dataset: (x, y) feature pairs from a single ``.npy`` (port
of ``nerf_replication_tpu/datasets/latent.py``).

The scene's ``.npy`` holds rows of concatenated features split as x = [:1]
⊕ [1:32], y = [32:160] ⊕ [160:].
"""

from __future__ import annotations

import os

import numpy as np


class Dataset:
    def __init__(self, data_root: str, scene: str, split: str = "train",
                 batch_size: int = 1024):
        self.data = np.load(os.path.join(data_root, scene + ".npy"))
        self.split = split
        self.batch_size = batch_size

    @classmethod
    def from_cfg(cls, cfg, split: str) -> "Dataset":
        node = cfg.train_dataset if split == "train" else cfg.test_dataset
        return cls(
            data_root=node.data_root,
            scene=cfg.scene,
            split=node.get("split", split),
            batch_size=int(cfg.task_arg.get("N_rays", 1024)),
        )

    def ray_bank(self):
        """(x [N, 32], y [N, rest]) — the trainer's bank contract."""
        return (
            self.data[:, :32].astype(np.float32),
            self.data[:, 32:].astype(np.float32),
        )

    def __getitem__(self, index: int):
        x_1, x_2 = self.data[:, :1], self.data[:, 1:32]
        y_1, y_2 = self.data[:, 32:32 + 128], self.data[:, 32 + 128:]
        return x_1, x_2, y_1, y_2

    def __len__(self) -> int:
        return len(self.data)
