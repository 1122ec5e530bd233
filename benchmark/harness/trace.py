"""The device trace of a traced run: ``torch.profiler`` over a stretch of
the window, reduced to kernel time by name, the device's busy time (the
union of its operations' intervals), the longest idle gaps labelled by
what the host was doing, and the ``breakdown`` of the result line."""

from __future__ import annotations

import time


class DeviceTracer:
    """Start / stop a profiler window of about ``seconds``; after
    :meth:`stop`, :meth:`reading` holds what the metrics read. ``host``:
    also record the host's operations (they label the idle gaps); a
    serving run records the device alone, as recording every client
    thread's operations would slow the loop it measures."""

    def __init__(self, torch, seconds: float, host: bool = True):
        self.torch = torch
        self.host = host
        self.seconds = float(seconds)
        self.done = False
        self._prof = None
        self._t0 = None
        self.window_s = 0.0
        self._reading = None

    def start(self) -> None:
        acts = [self.torch.profiler.ProfilerActivity.CUDA]
        if self.host or not self.torch.cuda.is_available():
            acts.append(self.torch.profiler.ProfilerActivity.CPU)
        self._prof = self.torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    @property
    def started(self) -> bool:
        return self._t0 is not None

    def elapsed(self) -> float:
        return 0.0 if self._t0 is None else time.perf_counter() - self._t0

    def stop(self) -> None:
        if self.done or self._prof is None:
            return
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        self.done = True

    def reading(self) -> dict:
        """``{"kernel_s": {name: s}, "busy_s", "window_s", "device_ops",
        "idle_gaps"}``; computed once."""
        if self._reading is None:
            events = [] if self._prof is None else self._prof.events()
            self._reading = reduce_events(self.torch, events, self.window_s)
            self._prof = None
        return self._reading


def short_name(name: str) -> str:
    """A kernel's or host operation's name without its return type,
    anonymous namespace and template or argument lists."""
    n = name[5:] if name.startswith("void ") else name
    n = n.replace("(anonymous namespace)::", "")
    for stop in ("<", "("):
        i = n.find(stop)
        if i > 0:
            n = n[:i]
    return n.strip()[:120] or name[:120]


def _union(intervals):
    """Merged, sorted intervals of ``[(start, end)]``."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _host_label(host, t: float) -> str:
    """The innermost host operation running at ``t`` (``host`` sorted by
    start), or ``"host idle"``."""
    best = None
    for s, e, name in host:
        if s > t:
            break
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return "host idle" if best is None else best[2]


def reduce_events(torch, events, window_s: float) -> dict:
    cuda = torch.autograd.DeviceType.CUDA
    kernel_us: dict = {}
    dev_iv = []
    host = []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            kernel_us[e.name] = kernel_us.get(e.name, 0.0) + (t - s)
            dev_iv.append((s, t))
        else:
            host.append((s, t, e.name))
    busy = _union(dev_iv)
    busy_us = sum(e - s for s, e in busy)
    host.sort()
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1])
                   for i in range(len(busy) - 1)), reverse=True)[:10]
    idle = [[short_name(_host_label(host, at + g / 2)), g / 1e6]
            for g, at in gaps]
    by_short: dict = {}
    for name, us in kernel_us.items():
        key = short_name(name)
        by_short[key] = by_short.get(key, 0.0) + us
    top = sorted(by_short.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {
        "kernel_s": {k: v / 1e6 for k, v in kernel_us.items()},
        "busy_s": busy_us / 1e6,
        "window_s": window_s,
        "device_ops": [[k, v / 1e6] for k, v in top],
        "idle_gaps": idle,
    }


def kernel_seconds(reading: dict, *fragments: str) -> float:
    """Device seconds of the kernels whose name holds any of
    ``fragments``."""
    return sum(s for name, s in reading["kernel_s"].items()
               if any(f in name for f in fragments))
