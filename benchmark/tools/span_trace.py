"""The program's spans in a traced window, on the device trace's clock:
what the benchmark's traced runs do not read yet.

    python3 benchmark/tools/span_trace.py --workload lego.serve --seed 7 \
        --seconds 51 --out build/spans.jsonl
    python3 benchmark/tools/span_trace.py --workload lego.train --seed 7 \
        --seconds 51
    python3 benchmark/tools/span_trace.py --clock-probe

A serving cell: one set-up, then the cell's window with the program's
tracer on and the device profiled (as a traced run does), with clock
probes at both ends of the profile (outside the window), the span rows
placed on the trace's clock and the device's intervals moved by the
probes' lag (``harness/spans.py``). One JSON line: the
serving span metrics, ``serve_idle_in_request_pct`` (the stretch's share
with no device operation while a view was open), ``idle_by_span`` (idle
seconds by the innermost program span open at the time, else ``no
request``), the ten longest idle gaps so labelled, each span's median and
p95 over the requests, the views' self time, and whether every answered
request is one trace rooted at ``serve.view``.

A training cell: set-up, then the window with the tracer on and the
cell's traced stretch profiled; ``train_host_ms`` is the median of the
``train.step`` spans inside the stretch, beside the median of what of each
span no CUDA runtime call covers (the host's own work; a full launch
queue makes the host wait inside the launch).

``--clock-probe``: under one profile with host and device activity, sets
of spans around ``torch.cuda._sleep`` and a synchronisation at several
times over ~20 s; per set, the bounds of the device clock's lag behind the
host's and where the launch calls lie in their spans once mapped.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for _p in (BENCH_DIR, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# the spans one served view holds (serve.batch and the engine's
# dispatch / device spans belong to the batch's first request)
REQUEST_SPANS = ("serve.view", "serve.rays", "serve.queue", "serve.render",
                 "serve.scatter", "serve.handoff", "serve.image",
                 "serve.batch", "serve.dispatch", "serve.device")


def _pct(values, q):
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), q)) \
        if values else None


def _ms(values):
    if not values:
        return {"n": 0, "p50_ms": None, "p95_ms": None, "mean_ms": None}
    return {"n": len(values), "p50_ms": _pct(values, 50) * 1e3,
            "p95_ms": _pct(values, 95) * 1e3,
            "mean_ms": sum(values) / len(values) * 1e3}


PROBE_REPS = 5
PROBE_CYCLES = 200_000  # ~0.1 ms of the sleep kernel on an H100
PROBE_GAP_S = 0.002  # between probes, so each kernel matches one span
PROBE_MATCH_US = 1000.0


class Probes:
    """Sets of spans, each around a sleep kernel and a synchronisation, on
    a tracer of their own; :meth:`probes` matches them with the trace's
    kernels once the profile is over."""

    def __init__(self, torch):
        from nerf_replication_tpu_torch.obs.trace import Tracer

        self.torch = torch
        self.tracer = Tracer(enabled=True)
        self.rows: list = []
        self.tracer.add_sink(self.rows.append)
        self.sets: list = []

    def run(self, reps: int = PROBE_REPS) -> None:
        first = len(self.rows)
        for _ in range(reps):
            with self.tracer.span("probe"):
                self.torch.cuda._sleep(PROBE_CYCLES)
                self.torch.cuda.synchronize()
            time.sleep(PROBE_GAP_S)
        self.sets.append((first, len(self.rows)))

    def probes(self, events, offset_ns: int, start_ns: int) -> list:
        """Per set, ``[(s, e, ks, ke)]`` on the trace's µs: each span with
        the sleep kernel that starts within :data:`PROBE_MATCH_US` of it
        (a profile that records the device alone can miss its first
        kernels; their spans drop out)."""
        from harness import spans as S

        cuda = self.torch.autograd.DeviceType.CUDA
        kernels = sorted((e.time_range.start, e.time_range.end)
                         for e in events if e.device_type == cuda
                         and "spin_kernel" in e.name)
        placed = S.place(self.rows, offset_ns, start_ns)
        out = []
        for a, b in self.sets:
            got = []
            for s, e, _ in placed[a:b]:
                near = [k for k in kernels if s - PROBE_MATCH_US <= k[0]
                        <= e + PROBE_MATCH_US]
                if len(near) == 1:
                    got.append((s, e, *near[0]))
            if got:
                out.append(got)
        return out


def _lag_summary(sets) -> list:
    from harness import spans as S

    out = []
    for probes in sets:
        t, lag = S.lag_at(probes)
        out.append({"t_s": t / 1e6, "lag_us": lag,
                    "bounds_us": [list(S.lag_bounds(p)) for p in probes]})
    return out


def _device_intervals(torch, events) -> list:
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.time_range.start, e.time_range.end) for e in events
            if e.device_type == cuda]


def _trace_start_ns(prof) -> int:
    return int(prof.profiler.kineto_results.trace_start_ns())


def _trees(rows) -> dict:
    """The root ``serve.view`` spans, the traces that hold exactly one
    view, and the spans whose parent is not among the rows."""
    from harness.spans import named

    ids = {r["span_id"] for r in rows}
    views: dict = {}
    for r in named(rows, "serve.view"):
        views[r["trace_id"]] = views.get(r["trace_id"], 0) + 1
    return {"views": sum(1 for r in named(rows, "serve.view")
                         if r.get("parent_id") is None),
            "traces_with_one_view": sum(1 for v in views.values() if v == 1),
            "orphan_spans": sum(1 for r in rows
                                if r.get("parent_id") not in ids | {None})}


def _probed_tracer(torch, seconds: float):
    """The serving run's device tracer with probe sets at both ends of the
    profile, outside the stretch the metrics read."""
    from harness.trace import DeviceTracer

    class ProbedTracer(DeviceTracer):
        def start(self):
            super().start()
            self.probes = Probes(torch)
            self.probes.run()
            self._t0 = time.perf_counter()

        def stop(self):
            if self.done or self._prof is None:
                return
            end = time.perf_counter()
            self.probes.run()
            super().stop()
            self.window_s = end - self._t0

    return ProbedTracer(torch, seconds, host=False)


def serve_readings(torch, device, cell, seed: int, seconds: float) -> dict:
    from harness import spans as S
    from harness.cell import SpanSink
    from harness.serve_cell import ServeRun
    from nerf_replication_tpu_torch.obs.trace import get_tracer, wall_offset_ns

    run = ServeRun(torch, device, cell, seed, time.perf_counter())
    run.setup()
    dt = _probed_tracer(torch, seconds)
    sink = SpanSink()
    tr = get_tracer()
    tr.enabled = True
    tr.add_sink(sink)
    off0 = wall_offset_ns()
    w = run.window(seconds, dt)
    off1 = wall_offset_ns()
    tr.enabled = False
    prof = dt._prof
    t_start = _trace_start_ns(prof)
    events = prof.events()
    run.close()
    offset = (off0 + off1) // 2
    sets = dt.probes.probes(events, offset, t_start)
    lags = [S.lag_at(p) for p in sets]
    raw = _device_intervals(torch, events)
    busy = raw
    if lags and all(lag is not None for _, lag in lags):
        busy = S.shift(raw, S.lag_fit(lags))
    lo = (dt._t0 * 1e9 + offset - t_start) / 1e3
    stretch = (lo, lo + dt.window_s * 1e6)
    rows = sink.rows
    placed = S.place(rows, offset, t_start)
    width = stretch[1] - stretch[0]
    idle = S.complement(busy, *stretch)
    gaps = sorted(idle, key=lambda g: g[1] - g[0], reverse=True)[:10]
    by_span = S.idle_by_span(stretch, busy, placed)
    behind = S.behind_s(rows)
    host = S.view_host_s(rows)
    selfs = S.view_self_s(rows)
    done = w["completed"]
    return {
        "workload": cell.name, "seed": seed, "seconds": seconds,
        "requests": len(w["schedule"]), "answered": len(done),
        "failed": w["failed"], "fail_kinds": w["fail_kinds"],
        "serve_p50_ms": _pct(done, 50) * 1e3 if done else None,
        "serve_p95_ms": _pct(done, 95) * 1e3 if done else None,
        "serve_view_host_ms": statistics.median(host) * 1e3 if host
        else None,
        "serve_handoff_ms": _ms(S.durations(rows, "serve.handoff"))[
            "p50_ms"],
        "serve_queue_behind_p95_ms": _pct(behind, 95) * 1e3 if behind
        else None,
        "serve_queue_ms": _ms(S.durations(rows, "serve.queue"))[
            "p50_ms"],
        "serve_dispatch_ms": _ms(S.durations(rows, "serve.dispatch"))[
            "p50_ms"],
        "serve_idle_in_request_pct":
            100.0 * S.idle_in_views_us(stretch, busy, placed) / width,
        "serve_idle_in_request_pct_unshifted":
            100.0 * S.idle_in_views_us(stretch, raw, placed) / width,
        "lag": _lag_summary(sets),
        "device_idle_pct": 100.0 * sum(e - s for s, e in idle) / width,
        "idle_by_span_s": {k: v / 1e6 for k, v in sorted(
            by_span.items(), key=lambda kv: -kv[1])},
        "idle_gaps": S.label_gaps(gaps, placed),
        "split": {n: _ms(S.durations(rows, n)) for n in REQUEST_SPANS},
        "behind": _ms(behind),
        "view_self": _ms(selfs),
        "view_self_p50_share_of_p50": (_pct(selfs, 50) / _pct(done, 50)
                                       if selfs and done else None),
        "trees": _trees(rows),
        "offset_drift_us": (off1 - off0) / 1e3,
        "window_s": dt.window_s,
    }


def train_readings(torch, device, cell, seed: int, seconds: float) -> dict:
    from harness import spans as S
    from harness.cell import SpanSink
    from harness.train_cell import TrainRun
    from harness.trace import DeviceTracer
    from nerf_replication_tpu_torch.obs.trace import get_tracer, wall_offset_ns

    run = TrainRun(torch, device, cell, seed, time.perf_counter())
    run.setup()
    dt = DeviceTracer(torch, cell.traffic["trace_seconds"])
    sink = SpanSink()
    tr = get_tracer()
    tr.enabled = True
    tr.add_sink(sink)
    off0 = wall_offset_ns()
    w = run.window(seconds, dt)
    off1 = wall_offset_ns()
    tr.enabled = False
    lo, hi = dt._t0, dt._t0 + dt.window_s
    rows = [r for r in S.named(sink.rows, "train.step")
            if r["start_s"] >= lo and r["start_s"] + r["dur_s"] <= hi]
    steps = [r["dur_s"] for r in rows]
    # the CUDA runtime calls inside each step span (host events, which
    # the offset places within µs)
    events = dt._prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    calls: dict = {}
    for e in events:
        if e.device_type != cuda and e.name.startswith("cuda"):
            calls.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    placed = S.place(rows, (off0 + off1) // 2, _trace_start_ns(dt._prof))
    own, in_calls = [], {}
    every = [iv for ivs in calls.values() for iv in ivs]
    for s_us, e_us, _ in placed:
        own.append((e_us - s_us - S.overlap([(s_us, e_us)], every)) / 1e6)
        for name, ivs in calls.items():
            in_calls[name] = in_calls.get(name, 0.0) + S.overlap(
                [(s_us, e_us)], ivs) / 1e6
    reading = dt.reading()
    run.free_program()
    return {
        "workload": cell.name, "seed": seed, "seconds": seconds,
        "train_rays_per_s": w["rays_per_s"],
        "train_host_ms": statistics.median(steps) * 1e3 if steps else None,
        "train_step": _ms(steps),
        "train_step_outside_cuda_calls": _ms(own),
        "train_step_in_cuda_calls_s": {k: v for k, v in sorted(
            in_calls.items(), key=lambda kv: -kv[1]) if v > 0},
        "train_steps_in_window": len(S.named(sink.rows, "train.step")),
        "traced_steps": w["traced_steps"],
        "device_idle_pct": 100.0 * (1.0 - reading["busy_s"]
                                    / reading["window_s"]),
        "idle_gaps": reading["idle_gaps"],
    }


def clock_probe(torch, at_s=(0.0, 0.05, 0.2, 1.0, 2.0, 5.0, 10.0, 20.0)):
    """Probe sets at ``at_s`` seconds into one profile (host and device
    activity); the lag per set and where each launch call lies."""
    from harness import spans as S
    from nerf_replication_tpu_torch.obs.trace import wall_offset_ns

    probes = Probes(torch)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    off0 = wall_offset_ns()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for at in at_s:
            time.sleep(max(0.0, t0 + at - time.perf_counter()))
            probes.run()
    off1 = wall_offset_ns()
    events = prof.events()
    sets = probes.probes(events, (off0 + off1) // 2, _trace_start_ns(prof))
    launches = sorted(e.time_range.start for e in events
                      if e.name in ("cudaLaunchKernel",
                                    "cudaLaunchKernelExC"))
    spans = [p for ps in sets for p in ps]
    first = [min((la - s for la in launches if s <= la <= e), default=None)
             for s, e, _, _ in spans]
    return {"clock_probe": _lag_summary(sets),
            "launch_after_span_start_us": first,
            "offset_drift_us": (off1 - off0) / 1e3}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--clock-probe", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from harness.result import card_line
    from harness.spec import resolve

    rows = []
    if args.clock_probe:
        rows.append(clock_probe(torch))
    if args.workload:
        cell = resolve(args.workload)
        device = torch.device("cuda", 0)
        kind = cell.traffic["kind"]
        fn = serve_readings if kind == "viewer_open" else train_readings
        rows.append(fn(torch, device, cell, args.seed, args.seconds))
    card = card_line()
    for row in rows:
        line = json.dumps({"card": card, **row})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
