"""NeRF evaluator: per-image PSNR/SSIM, pred/gt PNG dumps, summary.json.

Port of ``nerf_replication_tpu/evaluators/nerf.py`` (PNGs through the port's
codec, ``utils/image.py``). Parity with the reference's `Evaluator`: a
stateful accumulator whose ``evaluate(output, batch)`` scores one rendered
view (writing ``pred_{i}.png`` / ``gt_{i}.png`` into the result dir) and whose
``summarize()`` persists mean PSNR/SSIM to ``summary.json`` and returns them.
SSIM is computed on float images with data_range=1 (the reference's
uint8/minmax data_range is a quirk we do not replicate, SURVEY.md §2.5).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

from ..utils.image import psnr, ssim, write_png


class Evaluator:
    def __init__(self, cfg):
        self.result_dir = cfg.result_dir
        self.save_images = bool(cfg.get("save_result", True))
        if cfg.get("clear_result", False):
            # wipe stale per-view artifacts from a previous run so the dir
            # holds exactly this evaluation's outputs
            shutil.rmtree(self.result_dir, ignore_errors=True)
        self.psnrs: list[float] = []
        self.ssims: list[float] = []

    def evaluate(self, output: dict, batch: dict):
        meta = batch.get("meta", {})
        H, W = int(meta.get("H")), int(meta.get("W"))
        key = "rgb_map_f" if "rgb_map_f" in output else "rgb_map_c"
        pred = np.clip(np.asarray(output[key]).reshape(H, W, 3), 0.0, 1.0)
        gt = np.asarray(batch["rgbs"]).reshape(H, W, 3)

        self.psnrs.append(psnr(pred, gt))
        self.ssims.append(ssim(pred, gt))

        if self.save_images:
            i = int(batch.get("i", len(self.psnrs) - 1))
            write_png(os.path.join(self.result_dir, f"pred_{i:04d}.png"), pred)
            write_png(os.path.join(self.result_dir, f"gt_{i:04d}.png"), gt)

    def summarize(self) -> dict:
        if not self.psnrs:
            return {}
        result = {
            "psnr": float(np.mean(self.psnrs)),
            "ssim": float(np.mean(self.ssims)),
        }
        os.makedirs(self.result_dir, exist_ok=True)
        with open(os.path.join(self.result_dir, "summary.json"), "w") as f:
            json.dump(
                {**result, "per_image_psnr": self.psnrs,
                 "per_image_ssim": self.ssims}, f, indent=2,
            )
        self.psnrs, self.ssims = [], []
        return result


def make_evaluator(cfg) -> Evaluator:
    return Evaluator(cfg)
