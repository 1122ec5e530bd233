"""Dataset factory: resolves the ``*_dataset_module`` plugin key."""

from __future__ import annotations

from ..registry import load_attr


def _module_key(split: str) -> str:
    return "train_dataset_module" if split == "train" else "test_dataset_module"


def make_dataset(cfg, split: str = "train"):
    """The split's full dataset (images and ray bank)."""
    dataset_cls = load_attr(cfg[_module_key(split)], "Dataset")
    return dataset_cls.from_cfg(cfg, split)


def make_camera(cfg, split: str = "test"):
    """The split's camera metadata alone (H/W/focal/near/far), which
    serving needs; no image is read."""
    camera_cls = load_attr(cfg[_module_key(split)], "Camera")
    return camera_cls.from_cfg(cfg, split)
