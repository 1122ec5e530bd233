"""The highest rate a serving cell sustains: one set-up, then the cell's
traffic offered at each rate in turn.

    python3 benchmark/tools/knee_sweep.py --workload lego.serve \
        --rates 20 30 40 50 --seconds 15 --out chiprun_out/knee.jsonl

One JSON line a rate: requests, failed (and why), p50 / p95 / max
latency, the completed views a second, and how the latency of the last
quarter of the schedule compares with the first quarter's (a backlog that
grows through the run shows as a ratio well over 1). The knee is the
highest rate with no failure, no shed tier and no growing backlog; a cell
offers about four fifths of it.
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


def rate_row(w: dict, rate: float, seconds: float) -> dict:
    import numpy as np

    lat = w["latencies_s"]
    done = [v for v in lat if v is not None]
    n = len(lat)
    q = max(1, n // 4)
    head = [v for v in lat[:q] if v is not None]
    tail = [v for v in lat[-q:] if v is not None]
    pct = (lambda p: float(np.percentile(done, p)) * 1e3) if done else (
        lambda p: None)
    return {
        "rate_per_s": rate, "seconds": seconds, "requests": n,
        "failed": w["failed"], "fail_kinds": w["fail_kinds"],
        "p50_ms": pct(50), "p95_ms": pct(95),
        "max_ms": max(done) * 1e3 if done else None,
        "completed_per_s": len(done) / w["elapsed_s"],
        "tail_over_head": (statistics.median(tail) / statistics.median(head)
                           if head and tail else None),
        "batch_fill": (w["counters"]["n_rays_rendered"]
                       / max(1, w["counters"]["n_rays_rendered"]
                             + w["counters"]["n_pad_rays"])),
        "compiles": w["counters"]["compiles"],
        "lag_max_ms": w["lag_max_s"] * 1e3,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from harness.result import card_line
    from harness.serve_cell import ServeRun
    from harness.spec import resolve

    cell = resolve(args.workload)
    run = ServeRun(torch, torch.device("cuda", 0), cell, args.seed,
                   time.perf_counter())
    run.setup()
    card = card_line()
    out = open(args.out, "a") if args.out else None
    try:
        for i, rate in enumerate(args.rates):
            # a seed a rate: every rate's poses are new to the pose cache
            run.seed = args.seed * 1000 + i + 1
            w = run.window(args.seconds, rate=rate)
            row = {"workload": cell.name, "card": card,
                   **rate_row(w, rate, args.seconds)}
            print(json.dumps(row), flush=True)
            if out:
                out.write(json.dumps(row) + "\n")
                out.flush()
    finally:
        run.close()
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
