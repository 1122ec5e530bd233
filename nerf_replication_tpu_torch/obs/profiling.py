"""Config-driven ``torch.profiler`` windows + trace annotations (port of
``nerf_replication_tpu/obs/profiling.py``).

``train.profile: {start_step, num_steps, dir}`` traces exactly those steps
of the hot loop — the profiler runs for a bounded window instead of the
whole run — and writes a Chrome trace (``trace.json``, CPU and CUDA
activities) into ``dir`` (default ``<record_dir>/profile``). The window
ticks with the HOST step counter before every burst: it opens before the
burst that holds ``start_step`` and closes at the first burst boundary at
or past ``start_step + num_steps`` (a burst is the host's seam). It
drains the card at both edges, so the trace holds the windowed steps'
kernels and no other's, and keeps ``EDGE_S`` of host time between each
edge and the windowed kernels: the profiler drops device events whose
timestamps, mapped onto the host's clock, fall outside its window.

The trainers replay captured CUDA graphs; the trace holds the kernels
inside each replay as kernel events of their own, though the profiler
starts after the capture (``chip_smoke.py``'s ops phase counts them).

``annotate(name)`` is ``torch.profiler.record_function`` (a named range on
the CPU timeline) plus an NVTX range on the card.
"""

from __future__ import annotations

import contextlib
import os
import time

EDGE_S = 0.005  # host time between a window's edge and its kernels


def profiler_activities() -> list:
    """CPU, and CUDA when there is a card."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def sync_devices() -> None:
    """Wait for every card's queued work (nothing to wait for on the CPU
    or before CUDA is initialised)."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


@contextlib.contextmanager
def annotate(name: str):
    """Named host-side region on the profiler timeline (and NVTX)."""
    import torch

    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class ProfileWindow:
    """Start/stop a ``torch.profiler`` trace around a configured step span."""

    def __init__(self, start_step: int = -1, num_steps: int = 0,
                 trace_dir: str = "", chief: bool | None = None):
        if chief is None:
            from .emit import is_chief

            chief = is_chief()
        self.start_step = int(start_step)
        self.num_steps = int(num_steps)
        self.trace_dir = trace_dir
        self.enabled = chief and self.start_step >= 0 and self.num_steps > 0
        self.active = False
        self.done = False
        self.trace_path: str | None = None
        self._prof = None

    @classmethod
    def from_cfg(cls, cfg):
        prof = cfg.get("train", {}).get("profile", None)
        if not prof:
            return cls()  # disabled
        trace_dir = str(prof.get("dir", "")) or os.path.join(
            str(cfg.get("record_dir", ".")), "profile"
        )
        return cls(
            start_step=int(prof.get("start_step", -1)),
            num_steps=int(prof.get("num_steps", 0)),
            trace_dir=trace_dir,
        )

    def tick(self, host_step: int) -> None:
        """Advance the window; call with the host step counter before each
        burst and once after the epoch's last.

        Starts capture when the NEXT dispatch would overlap the window,
        stops once the window's last step has executed.
        """
        if not self.enabled or self.done:
            return
        if self.active and host_step >= self.start_step + self.num_steps:
            self.stop()
            return
        if not self.active and host_step >= self.start_step:
            import torch

            os.makedirs(self.trace_dir, exist_ok=True)
            sync_devices()
            self._prof = torch.profiler.profile(
                activities=profiler_activities())
            self._prof.start()
            time.sleep(EDGE_S)
            self.active = True

    def stop(self) -> None:
        """Close an open window and write its trace (also the safety stop
        at the end of training or on an exception's unwind)."""
        if not self.active:
            return
        sync_devices()
        time.sleep(EDGE_S)
        self._prof.stop()
        self.trace_path = os.path.join(self.trace_dir, "trace.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        self.active = False
        self.done = True
