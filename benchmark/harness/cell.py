"""One run of one cell: set-up, the window (traced or not), the device's
peak, the comparison with the reference, and the metrics. The run is
chosen by the traffic's kind; what depends on the model comes from the
cell's family (``families/<model>.py``)."""

from __future__ import annotations

from types import SimpleNamespace

from reference.compare import judge

from .result import device_block
from .spec import metric_reader
from .trace import DeviceTracer


def _metrics(cell, values: dict) -> dict:
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    return {k: {"value": v, "unit": units[k]} for k, v in values.items()}


def _per_layer(cell, ctx) -> dict:
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], cell.root)(ctx)
        if value is not None:
            out[m["name"]] = value
    return out


def _reset_peak(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)


def _peak(torch, device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def run_cell(torch, device, cell, seed: int, seconds: float, trace: bool,
             t_start: float) -> dict:
    kind = cell.traffic["kind"]
    if kind == "train_loop":
        return run_train(torch, device, cell, seed, seconds, trace, t_start)
    if kind == "viewer_open":
        return run_serve(torch, device, cell, seed, seconds, trace, t_start)
    raise ValueError(f"unknown traffic kind {kind!r}")


def run_train(torch, device, cell, seed: int, seconds: float, trace: bool,
              t_start: float) -> dict:
    from .train_cell import TrainRun

    _reset_peak(torch, device)
    run = TrainRun(torch, device, cell, seed, t_start)
    run.mark("imports")
    run.setup()
    tracer = (DeviceTracer(torch, cell.traffic["trace_seconds"])
              if trace else None)
    w = run.window(seconds, tracer)
    peak = _peak(torch, device)
    run.free_program()
    ref = run.reference()
    judged = run.numbers(ref)
    ok, rows = judge(judged["numbers"], cell.config["limits"]["train"])
    ok = ok and w["finite"]
    if trace:
        ctx = SimpleNamespace(cell=cell, spec=run.spec,
                              trace=tracer.reading(),
                              steps=w["traced_steps"])
        values = _per_layer(cell, ctx)
    else:
        # a training cell's one end-to-end metric besides setup_s is its rate
        rate = next(m["name"] for m in cell.end_to_end
                    if m["name"] != "setup_s")
        values = {rate: w["rays_per_s"], "setup_s": run.setup_s}
    result = {
        "correct": bool(ok),
        "attempted": int(w["steps"]),
        "failed": 0 if w["finite"] else int(w["steps"]),
        "metrics": _metrics(cell, values),
        "device": device_block(torch, device, cell.chips, peak, tracer),
    }
    if trace:
        r = tracer.reading()
        result["breakdown"] = {"device_ops": r["device_ops"],
                               "idle_gaps": r["idle_gaps"]}
    result["where"] = {**judged["where"], "setup_phases": run.setup_phases,
                       "numbers": judged["numbers"]}
    result["checks"] = {name: [value, limit] for name, value, limit in rows}
    return result


def _percentile_ms(values, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), q)) * 1e3


class SpanSink:
    """Collects the program's finished span rows during the window."""

    def __init__(self):
        self.rows = []

    def __call__(self, row: dict) -> None:
        self.rows.append(row)

    def durations_ms(self, name: str) -> list:
        return [r["dur_s"] * 1e3 for r in self.rows if r["name"] == name]


def serve_numbers(run, w: dict, sample) -> tuple[dict, dict]:
    """The widest gaps of the sampled replies' maps from the reference's.
    A sampled request that got no reply is a wrong answer (it reads the
    widest gap there is, 1: the maps and depth / far lie in [0, 1]); one
    served below ``full`` counts as failed, not compared."""
    import numpy as np

    gaps = {"rgb_gap": 0.0, "acc_gap": 0.0, "depth_gap": 0.0}
    compared = missing = 0
    for i in sample:
        got = w["kept"].get(i)
        if got is None:
            missing += 1
            continue
        if got["tier"] != "full":
            continue
        ref = run.reference_maps(w["schedule"][i])
        pairs = {"rgb_gap": (got["rgb_map_f"], ref["rgb"]),
                 "acc_gap": (got["acc_map_f"], ref["acc"]),
                 "depth_gap": (got["depth_map_f"] / run.spec["far"],
                               ref["depth"] / run.spec["far"])}
        for k, (a, b) in pairs.items():
            b = b.detach().cpu().numpy()
            gap = float(np.max(np.abs(np.asarray(a, np.float64) - b)))
            gaps[k] = max(gaps[k], gap if gap == gap else 1.0)
        compared += 1
    if missing:
        gaps = {k: 1.0 for k in gaps}
    return gaps, {"requests_compared": compared, "replies_missing": missing}


def run_serve(torch, device, cell, seed: int, seconds: float, trace: bool,
              t_start: float) -> dict:
    from nerf_replication_tpu_torch.obs.trace import get_tracer

    from .serve_cell import ServeRun
    from .traffic import sample_indices, viewer_schedule

    _reset_peak(torch, device)
    run = ServeRun(torch, device, cell, seed, t_start)
    run.setup()
    sched = viewer_schedule(cell.traffic, seed, seconds)
    largest = max(range(len(sched)), key=lambda i: sched[i].side)
    sample = sample_indices(len(sched), int(cell.traffic["compared_requests"]),
                            seed, always=(largest,))
    tracer = sink = None
    if trace:
        tracer = DeviceTracer(torch, seconds, host=False)
        sink = SpanSink()
        tr = get_tracer()
        tr.enabled = True
        tr.add_sink(sink)
    w = run.window(seconds, tracer, keep_indices=sample)
    peak = _peak(torch, device)
    run.free_program()
    gaps, where = serve_numbers(run, w, sample)
    ok, rows = judge(gaps, cell.config["limits"]["serve"])
    where.update({"fail_kinds": w["fail_kinds"],
                  "compiles_in_window": w["counters"]["compiles"],
                  "pose_cache_hits": w["counters"]["cache_hits"],
                  "generator_lag_max_ms": w["lag_max_s"] * 1e3,
                  "requests": len(sched)})
    done = w["completed"]
    if trace:
        traced = [r for r, t in zip(w["schedule"], w["replied_s"])
                  if t is not None]
        ctx = SimpleNamespace(
            cell=cell, spec=run.spec, serve=run.serve,
            trace=tracer.reading(), spans=sink,
            counters=w["counters"], traced=traced,
            samples=run.count_samples(traced) if traced else 0)
        values = _per_layer(cell, ctx)
    else:
        tails = {"serve_p50_ms": 50, "serve_p95_ms": 95}
        values = {m["name"]: _percentile_ms(done, tails[m["name"]])
                  for m in cell.end_to_end if m["name"] in tails}
        values["setup_s"] = run.setup_s
    result = {
        "correct": bool(ok),
        "attempted": len(sched),
        "failed": int(w["failed"]),
        "metrics": _metrics(cell, values),
        "device": device_block(torch, device, cell.chips, peak, tracer),
    }
    if trace:
        r = tracer.reading()
        result["breakdown"] = {"device_ops": r["device_ops"],
                               "idle_gaps": r["idle_gaps"]}
    result["where"] = where
    result["checks"] = {name: [value, limit] for name, value, limit in rows}
    return result
