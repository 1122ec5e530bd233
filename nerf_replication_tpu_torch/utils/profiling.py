"""Profiling and timing hooks (port of
``nerf_replication_tpu/utils/profiling.py``): ``perf_timer`` wall clocks
that drain the card first (``torch.cuda.synchronize``), a
``torch.profiler`` trace around a block, named annotations and a mean
per-call timer."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

from ..obs.profiling import sync_devices as _sync_devices

_records: dict[str, list[float]] = defaultdict(list)


@contextlib.contextmanager
def perf_timer(name: str, sync: bool = True, log=None):
    """Wall-clock a block; with ``sync``, drains all in-flight device work
    before and after so the block's device time is actually measured."""
    if sync:
        _sync_devices()
    t0 = time.perf_counter()
    yield
    if sync:
        _sync_devices()
    dt = time.perf_counter() - t0
    _records[name].append(dt)
    if log is not None:
        log(f"[perf] {name}: {dt:.4f}s")


def timings(name: str | None = None):
    """Recorded durations: one list, or all of them."""
    if name is not None:
        return list(_records[name])
    return {k: list(v) for k, v in _records.items()}


def reset_timings():
    _records.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (CPU, and the card when there
    is one), written as a Chrome trace into ``log_dir``."""
    from ..obs.profiling import profiler_activities

    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=profiler_activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region on the profiler's timeline."""
    from ..obs.profiling import annotate as _annotate

    return _annotate(name)


def time_fn(fn, *args, iters: int = 10, warmup: int = 2, **kwargs) -> float:
    """Mean seconds per call, the first calls (builds, captures) excluded,
    device-synced."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync_devices()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    _sync_devices()
    return (time.perf_counter() - t0) / iters
