"""Shared ray-bank dataset contract (port of
``nerf_replication_tpu/datasets/bank.py``).

Every image-collection dataset here (blender, real captures) materializes the
same four host arrays — ``rays [N,6]``, ``rgbs [N,3]``, ``poses``, and the
``H/W/focal/near/far`` scalars — and then exposes one identical surface:
``ray_bank()`` for on-device sampling, ``precrop_index_pool()`` for the
center-crop warm-up, the reference's test ``__getitem__`` contract
(blender.py:124-139 in the reference), and the nominal 1M-epoch train length
(reference blender.py:163). That surface lives here once so task datasets
only implement loading.
"""

from __future__ import annotations

import numpy as np


class RayBankDataset:
    """Mixin over (rays, rgbs, H, W, focal, near, far, n_images, split)."""

    # subclasses populate these in __post_init__
    rays: np.ndarray
    rgbs: np.ndarray
    H: int
    W: int
    focal: float
    near: float
    far: float
    n_images: int
    split: str

    # ---- device data path ----------------------------------------------------
    def ray_bank(self):
        """Flat ``(rays, rgbs)`` host arrays; the trainer moves them to the
        device once and draws every batch there."""
        return self.rays, self.rgbs

    def precrop_index_pool(self, precrop_frac: float) -> np.ndarray:
        """Flat ray indices inside the center crop of every image
        (precrop_frac of H and W, as in the original NeRF's warm-up)."""
        H, W, n = self.H, self.W, self.n_images
        dH = int(H // 2 * precrop_frac)
        dW = int(W // 2 * precrop_frac)
        rows = np.arange(H // 2 - dH, H // 2 + dH)
        cols = np.arange(W // 2 - dW, W // 2 + dW)
        rr, cc = np.meshgrid(rows, cols, indexing="ij")
        per_image = (rr * W + cc).reshape(-1)
        offsets = np.arange(n, dtype=np.int64)[:, None] * (H * W)
        return (offsets + per_image[None, :]).reshape(-1)

    # ---- test-split contract ----------------------------------------------
    def __len__(self) -> int:
        if self.split == "train":
            return 1_000_000  # nominal epoch length (reference blender.py:163)
        return self.n_images

    def image_batch(self, index: int) -> dict:
        """One whole image's rays (the reference's test ``__getitem__``)."""
        n_pix = self.H * self.W
        sl = slice(index * n_pix, (index + 1) * n_pix)
        return {
            "rays": self.rays[sl],
            "rgbs": self.rgbs[sl],
            "near": np.float32(self.near),
            "far": np.float32(self.far),
            "i": index,
            "meta": {"H": self.H, "W": self.W, "focal": self.focal},
        }

    def __getitem__(self, index: int) -> dict:
        if self.split == "train":
            # a host-side random batch (the loader of ``run --type
            # dataset``; the trainer samples on the device instead), drawn
            # from numpy's global RNG as the JAX package does
            idx = np.random.randint(0, self.rays.shape[0], size=(1024,))
            return {
                "rays": self.rays[idx],
                "rgbs": self.rgbs[idx],
                "near": np.float32(self.near),
                "far": np.float32(self.far),
                "i": index,
            }
        return self.image_batch(index)
