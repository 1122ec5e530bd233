"""Dataset factory: resolves the ``*_dataset_module`` plugin key."""

from __future__ import annotations

from ..registry import load_attr


def make_dataset(cfg, split: str = "train"):
    key = "train_dataset_module" if split == "train" else "test_dataset_module"
    dataset_cls = load_attr(cfg[key], "Dataset")
    return dataset_cls.from_cfg(cfg, split)
