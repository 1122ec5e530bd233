"""Instrumentation hooks (port of ``nerf_replication_tpu/obs/hooks.py``):
compile counting, memory sampling, and the host/device step-time split.

* **Compiles** — on the port a "compile" is a CUDA-graph capture
  (``compile/registry.py``) or a kernel library's build or load
  (``ops/kernels.py``). :class:`CompileTracker` gives each one a
  ``compile`` row with its wall time; a capture in the steady state shows
  up as a row, which is what the JAX package's retrace rows catch.
* **Memory creep** — :func:`sample_memory` snapshots each card's caching
  allocator (``torch.cuda.memory_stats``: in use, peak, and the card's
  total as the limit) plus host RSS into a ``memory`` row on the epoch
  cadence; on the CPU the row holds host RSS only.
* **Host-dispatch stalls** — :func:`timed_call` splits a step's wall time
  into dispatch (host time to enqueue or replay) and block (time waited
  at the sync point), so a latency-bound regression (dispatch grows) is
  distinguishable from a compute-bound one (block grows).
"""

from __future__ import annotations

import time

from .emit import get_emitter
from .profiling import sync_devices


class CompileTracker:
    """Compile counts of one trainer or run, by name. ``note_compile``
    accounts one capture or build and emits its ``compile`` row."""

    def __init__(self):
        self._counts: dict[str, int] = {}

    def note_compile(self, name: str, wall_s: float,
                     phase: str | None = None) -> None:
        n = self._counts[name] = self._counts.get(name, 0) + 1
        fields = {"phase": phase} if phase else {}
        get_emitter().emit("compile", name=name, n_compiles=n,
                           wall_s=float(wall_s), **fields)

    def counts(self) -> dict[str, int]:
        return dict(self._counts)

    def total_compiles(self) -> int:
        return sum(self._counts.values())


def timed_call(fn, *args, block: bool = False, **kwargs):
    """``(out, dispatch_s, block_s)`` — block_s is None unless ``block``.

    With ``block=False`` this adds only two clock reads to the call, so
    the loop stays asynchronous between logging points; at the logging
    cadence the caller passes ``block=True`` and pays the one sync it was
    about to pay anyway for host-side stats.
    """
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    dispatch_s = time.perf_counter() - t0
    block_s = None
    if block:
        t1 = time.perf_counter()
        sync_devices()
        block_s = time.perf_counter() - t1
    return out, dispatch_s, block_s


def device_memory() -> tuple[list[dict], int | None]:
    """``(devices, host_rss_bytes)`` snapshot for a ``memory`` row: one
    entry per card this process has touched (none on the CPU)."""
    import resource

    import torch

    devices = []
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            devices.append({
                "id": i,
                "platform": "gpu",
                "bytes_in_use": stats.get("allocated_bytes.all.current"),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
                "bytes_limit": torch.cuda.get_device_properties(
                    i).total_memory,
            })
    # linux reports ru_maxrss in KiB
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return devices, rss


def sample_memory(step: int | None = None, epoch: int | None = None) -> None:
    """Emit one ``memory`` row (per-card allocator stats + host RSS)."""
    emitter = get_emitter()
    if not emitter.chief:
        return
    devices, rss = device_memory()
    fields = {"devices": devices, "host_rss_bytes": rss}
    if step is not None:
        fields["step"] = int(step)
    if epoch is not None:
        fields["epoch"] = int(epoch)
    emitter.emit("memory", **fields)
