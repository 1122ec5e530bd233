"""The two readings each limit of a cell is set from, on the card.

    python3 benchmark/tools/readings.py --workload lego.train \
        --seeds 101 102 ... --out chiprun_out/readings.jsonl

For each seed, in one process: the cell's set-up and compared steps as a
run makes them (the program), then the reference (in the configuration's
precision, as a run's); the numbers the program reads against the
reference (the lower readings), then the control's (the reference in the
precision below the configuration's) and each planted fault's, against
the same reference (the upper readings), and the float32 reference's
beside them. One JSON line a seed and side. No measured window: the training readings need none.

For a serving cell it reads the control's gaps (the reference in the
precision below the served one) on the replies a run of ``--seconds``
would compare; the program's side of a serving limit is read by the
benchmark's runs themselves (each prints its gaps). ``--cpu-check`` also
holds the reference on the card against the reference on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for _p in (BENCH_DIR, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# the precision below each stated compute precision (the control)
CONTROL = {"bfloat16": "fp8_e4m3", "float32": "tf32"}
TRAIN_FAULTS = ("half_batch",)


def train_readings(torch, device, cell, seed: int, dump: bool = False,
                   ref_precision: str | None = None):
    from harness.train_cell import TrainRun
    from reference import compare

    run = TrainRun(torch, device, cell, seed, time.perf_counter())
    run.setup()
    run.free_program()
    ref_precision = ref_precision or run.spec["compute_dtype"]
    ref = run.reference(ref_precision)
    rows = []
    if dump:
        rows.append({"side": "reference", "raw": _raw(ref)})
    rows.append({"side": "program", **run.numbers(ref),
                 **({"raw": _raw(run.readings)} if dump else {})})
    ctl = CONTROL[run.spec["compute_dtype"]]
    variants = [(ctl, None)] + [(ref_precision, f) for f in TRAIN_FAULTS]
    if ref_precision != "float32":
        variants.append(("float32", None))
    for precision, fault in variants:
        other = run.reference(precision, fault)
        judged = compare.train_numbers(other, ref)
        if dump:
            judged["raw"] = _raw(other)
        rows.append({"side": fault or f"control_{precision}", **judged})
    del run
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rows


def serve_readings(torch, device, cell, seed: int, seconds: float,
                   cpu_check: bool = False):
    """The control's gaps (the reference in the precision below the
    served one, against the reference) on the replies a run of ``seconds``
    would compare; ``cpu_check``: also the reference on the card against
    the reference on the CPU, on the smallest of them."""
    from harness.serve_cell import ServeRun
    from harness.traffic import sample_indices, viewer_schedule

    run = ServeRun(torch, device, cell, seed, time.perf_counter())
    run.make_inputs()
    sched = viewer_schedule(cell.traffic, seed, seconds)
    largest = max(range(len(sched)), key=lambda i: sched[i].side)
    sample = sample_indices(len(sched), int(cell.traffic["compared_requests"]),
                            seed, always=(largest,))
    ctl = CONTROL[run.serve["compute_dtype"]]
    gaps = {"rgb_gap": 0.0, "acc_gap": 0.0, "depth_gap": 0.0}
    for i in sample:
        ref = run.reference_maps(sched[i])
        other = run.reference_maps(sched[i], ctl)
        for k, key in (("rgb_gap", "rgb"), ("acc_gap", "acc"),
                       ("depth_gap", "depth")):
            scale = run.spec["far"] if k == "depth_gap" else 1.0
            gaps[k] = max(gaps[k], float((other[key] - ref[key]).abs().max())
                          / scale)
    rows = [{"side": f"control_{ctl}", "numbers": gaps,
             "requests": len(sample)}]
    if cpu_check:
        small = min(sample, key=lambda i: sched[i].side)
        ref = run.reference_maps(sched[small])
        cpu = ServeRun(torch, torch.device("cpu"), cell, seed,
                       time.perf_counter())
        cpu.make_inputs()
        cpu.w0 = {k: v.cpu() for k, v in run.w0.items()}
        ref_cpu = cpu.reference_maps(sched[small])
        rows.append({"side": "reference_card_vs_cpu", "numbers": {
            k: float((ref[k].cpu() - ref_cpu[k]).abs().max())
            for k in ("rgb", "acc", "depth")}, "side_px": sched[small].side})
    return rows


def _raw(readings: dict) -> dict:
    from reference.compare import norms

    return {"losses": readings["losses"],
            "grad1_norms": norms(readings["grad1"]),
            "delta_norms": norms(readings["delta"])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--seconds", type=float, default=None,
                   help="serving: the window whose replies are compared "
                   "(default: BENCHMARK.json's run_seconds)")
    p.add_argument("--cpu-check", action="store_true")
    p.add_argument("--ref-precision", default=None,
                   help="training: the precision of the reference every "
                   "side is held against (default: the configuration's)")
    p.add_argument("--dump", action="store_true",
                   help="also each side's losses and per-leaf norms")
    args = p.parse_args(argv)
    import torch

    from harness.result import card_line
    from harness.spec import resolve

    cell = resolve(args.workload)
    dev = torch.device("cuda", 0)
    card = card_line()
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            if cell.traffic["kind"] == "viewer_open":
                from harness.spec import load_benchmark

                seconds = args.seconds or load_benchmark()["run_seconds"]
                rows = serve_readings(torch, dev, cell, seed, seconds,
                                      args.cpu_check)
            else:
                rows = train_readings(torch, dev, cell, seed, args.dump,
                                      args.ref_precision)
            for r in rows:
                line = json.dumps({"workload": cell.name, "seed": seed,
                                   "card": card,
                                   "s": time.perf_counter() - t0, **r})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
