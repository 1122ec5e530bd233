"""The measured window of a closed loop, and the traced part of it.

:func:`closed_loop` calls ``unit()`` (one burst of device work, enqueued
asynchronously) back to back until ``seconds`` have passed, keeping at most
two units in flight so the host never runs far ahead, and ends in a full
synchronisation: the window's time covers all the work it enqueued. With a
``tracer``, the profiler records a stretch of whole units in the middle of
the window (synchronised at both ends), whose kernels and idle gaps the
per-layer metrics read.
"""

from __future__ import annotations

import time
from collections import deque


def device_sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(torch, device, unit, seconds: float, tracer=None) -> dict:
    """``{"units": n, "elapsed_s": s, "traced_units": k}``."""
    cuda = device.type == "cuda"
    device_sync(torch, device)
    t0 = time.perf_counter()
    n = traced = 0
    in_flight: deque = deque()
    trace_from = seconds / 3.0
    tracing = False
    while True:
        if tracer is not None and not tracing and not tracer.done \
                and time.perf_counter() - t0 >= trace_from:
            device_sync(torch, device)
            in_flight.clear()
            tracer.start()
            tracing = True
        unit()
        n += 1
        if tracing:
            traced += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            in_flight.append(ev)
            if len(in_flight) > 2:
                in_flight.popleft().synchronize()
        if tracing and tracer.elapsed() >= tracer.seconds:
            device_sync(torch, device)
            in_flight.clear()
            tracer.stop()
            tracing = False
        if time.perf_counter() - t0 >= seconds:
            break
    if tracer is not None and not tracer.done and not tracing:
        # a window too short to reach its traced stretch traces one unit
        device_sync(torch, device)
        tracer.start()
        unit()
        n += 1
        traced += 1
        tracing = True
    device_sync(torch, device)
    if tracing:
        tracer.stop()
    return {"units": n, "elapsed_s": time.perf_counter() - t0,
            "traced_units": traced}
