"""Metrics recorder: windowed smoothing, scalar log, console lines.

Port of ``nerf_replication_tpu/train/recorder.py``: ``SmoothedValue``
(median/avg over a sliding window plus a global average), ``Recorder``
(loss stats, scalar records, checkpointable state, the record dir wiped when
a run starts fresh) and the reference trainer's console line. One process
writes (the port trains on one card).

The scalar writer is made on first use, as in the JAX package: a TensorBoard
``SummaryWriter`` from ``tensorboardX`` or ``torch.utils.tensorboard``, and
where neither imports, ``scalars.jsonl`` in ``record_dir`` with one
``{"tag", "value", "step"}`` object per line. A record other than ``train``
(validation, test) is also one ``eval`` telemetry row.
"""

from __future__ import annotations

import json
import os
import shutil
from collections import defaultdict, deque

import numpy as np


class SmoothedValue:
    """Track a window of values with median/avg plus a global average
    (recorder.py:10-37)."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        v = float(value)
        self.deque.append(v)
        self.count += 1
        self.total += v

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    def __str__(self):
        return f"{self.median:.4f} ({self.global_avg:.4f})"

    # -- checkpointable state -----------------------------------------------
    # total/count feed global_avg, which drives the eta: column — without
    # them a resumed run's eta restarts from zero.
    def state_dict(self) -> dict:
        return {
            "total": self.total,
            "count": self.count,
            "window": [float(v) for v in self.deque],
        }

    def load_state_dict(self, state: dict):
        self.total = float(state.get("total", 0.0))
        self.count = int(state.get("count", 0))
        self.deque.clear()
        for v in state.get("window", []):
            self.deque.append(float(v))


class JsonlScalarWriter:
    """``add_scalar`` rows as JSON lines (``<log_dir>/scalars.jsonl``)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "scalars.jsonl")

    def add_scalar(self, tag: str, value: float, step: int):
        with open(self.path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value),
                                "step": int(step)}) + "\n")


def _summary_writer(log_dir: str):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return JsonlScalarWriter(log_dir)
    return SummaryWriter(log_dir=log_dir)


class Recorder:
    def __init__(self, cfg, window_size: int = 20):
        self.record_dir = cfg.record_dir
        self.step = 0
        self.epoch = 0
        self.loss_stats = defaultdict(lambda: SmoothedValue(window_size))
        self.batch_time = SmoothedValue(window_size)
        self.data_time = SmoothedValue(window_size)
        self._writer = None
        if not cfg.get("resume", True) and os.path.exists(self.record_dir):
            shutil.rmtree(self.record_dir, ignore_errors=True)
        os.makedirs(self.record_dir, exist_ok=True)

    @property
    def writer(self):
        if self._writer is None:
            self._writer = _summary_writer(self.record_dir)
        return self._writer

    def update_loss_stats(self, stats: dict):
        for k, v in stats.items():
            self.loss_stats[k].update(float(v))

    def record(self, prefix: str, step: int | None = None,
               stats: dict | None = None):
        """Write window-median scalars (or the given stats)."""
        step = self.step if step is None else step
        pattern = prefix + "/{}"
        if stats is None:
            for k, sv in self.loss_stats.items():
                self.writer.add_scalar(pattern.format(k), sv.median, step)
        else:
            for k, v in stats.items():
                v = v.median if isinstance(v, SmoothedValue) else float(v)
                self.writer.add_scalar(pattern.format(k), v, step)
        # eval-cadence summaries are one typed row each; the train cadence's
        # rows come from the trainer's loop, which has the timings
        if stats is not None and prefix != "train":
            from ..obs import get_emitter

            get_emitter().emit(
                "eval", prefix=prefix, step=int(step),
                metrics={k: float(v.median if isinstance(v, SmoothedValue)
                                  else v) for k, v in stats.items()})

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "epoch": self.epoch,
            "smoothed": {
                "batch_time": self.batch_time.state_dict(),
                "data_time": self.data_time.state_dict(),
                "loss_stats": {
                    k: sv.state_dict() for k, sv in self.loss_stats.items()
                },
            },
        }

    def load_state_dict(self, state: dict):
        self.step = int(state.get("step", 0))
        self.epoch = int(state.get("epoch", 0))
        smoothed = state.get("smoothed") or {}
        if "batch_time" in smoothed:
            self.batch_time.load_state_dict(smoothed["batch_time"])
        if "data_time" in smoothed:
            self.data_time.load_state_dict(smoothed["data_time"])
        for k, sv_state in (smoothed.get("loss_stats") or {}).items():
            self.loss_stats[k].load_state_dict(sv_state)

    def console_line(self, epoch: int, it: int, max_iter: int, lr: float,
                     max_mem_mb: float | None = None) -> str:
        eta_sec = self.batch_time.global_avg * (max_iter - it)
        h, rem = divmod(int(eta_sec), 3600)
        m, s = divmod(rem, 60)
        parts = [
            f"eta: {h}:{m:02d}:{s:02d}",
            f"epoch: {epoch}",
            f"step: {self.step}",
            *[f"{k}: {v}" for k, v in self.loss_stats.items()],
            f"lr: {lr:.6f}",
            f"data: {self.data_time.avg:.4f}",
            f"batch: {self.batch_time.avg:.4f}",
        ]
        if max_mem_mb is not None:
            parts.append(f"max_mem: {max_mem_mb:.0f}")
        return "  ".join(parts)


def make_recorder(cfg) -> Recorder:
    return Recorder(cfg, window_size=20)
