"""img_fit evaluator: PSNR, a gt | pred side-by-side image and
``metrics.json`` (port of ``nerf_replication_tpu/evaluators/img_fit.py``)."""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

from ..utils.image import psnr, write_png


class Evaluator:
    def __init__(self, cfg):
        self.result_dir = cfg.result_dir
        if cfg.get("clear_result", False):
            shutil.rmtree(self.result_dir, ignore_errors=True)
        self.psnrs: list[float] = []

    def evaluate(self, output: dict, batch: dict):
        meta = batch.get("meta", {})
        H, W = int(meta.get("H")), int(meta.get("W"))
        key = "rgb" if "rgb" in output else "rgb_map_f"
        pred = np.clip(np.asarray(output[key]).reshape(H, W, 3), 0.0, 1.0)
        gt = np.asarray(batch.get("rgb", batch.get("rgbs"))).reshape(H, W, 3)
        self.psnrs.append(psnr(pred, gt))
        write_png(
            os.path.join(self.result_dir, "vis", "res.png"),
            np.concatenate([gt, pred], axis=1),  # gt | pred side by side
        )

    def summarize(self) -> dict:
        if not self.psnrs:
            return {}
        result = {"psnr": float(np.mean(self.psnrs))}
        os.makedirs(self.result_dir, exist_ok=True)
        with open(os.path.join(self.result_dir, "metrics.json"), "w") as f:
            json.dump(result, f)
        self.psnrs = []
        return result


def make_evaluator(cfg) -> Evaluator:
    return Evaluator(cfg)
