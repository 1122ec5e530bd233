"""The fused-MLP backward (K2 / K3b) of several checkouts of the port, timed
in turns on one card.

    python nerf_replication_tpu_torch/tools/time_trees.py TREE [TREE ...] \
        [--cases k2_f32,k2_bf16,k3b_f32,k3b_bf16] [--iters 5] [--out PATH]

Run it as a file, not with ``-m``. Each TREE is a directory that holds a
``nerf_replication_tpu_torch`` package: this checkout, an earlier commit
unpacked with ``git archive`` under ``build/``, or such a copy with a
kernel source edited (a phase compiled out, another product). A child
process per tree puts the tree first on ``sys.path``, so that the tree's
kernels build into its own ``build/``, and calls that tree's
``ops.fused_mlp.mlp_backward``, the wrapper every checkout of the port has:
this tool knows no kernel's C interface. Inputs are those of
``profile_fused_mlp.py`` (``case_inputs``: the same seeds and shapes).

The children first build their kernels, all at once. Then they run in
turns, the trees in order and then in reverse (A B .. B A), so that a drift
of the card's clock shows. For each case it prints one JSON line: each
tree's device ms per call by kernel name from torch.profiler (its first
turn) and its total in each turn. ``--out PATH`` also writes the lines,
each with the nvidia-smi name/power line, to a JSONL file.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _short(name: str) -> str:
    """A kernel's identifier without namespace, template or arguments."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0]
    head = re.sub(r"<.*>", "", head)
    return head.split("::")[-1].split()[-1]


def child(tree: str, cases: list[str], iters: int, warm: bool) -> int:
    """In the child: time ``tree``'s mlp_backward on every case and print
    ``{case: {kernel: ms}}``; with ``warm``, only build its kernels through
    one small call."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp
    from profile_fused_mlp import case_inputs, device_ms, lego_case

    if not fmlp.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"{fmlp.__file__} is not of {tree}")
    dev = torch.device("cuda")
    out = {}
    with torch.no_grad():
        if warm:
            spec, x, v, draw, flat = lego_case(torch, np, torch.float32, 333,
                                               0, dev)
            fmlp.mlp_backward(spec, x, v, draw, flat, 333)
            torch.cuda.synchronize()
            cases = []
        for case in cases:
            spec, x, v, draw, flat, m, valid = case_inputs(torch, np, case,
                                                           dev)
            out[case] = device_ms(
                torch, lambda: fmlp.mlp_backward(spec, x, v, draw, flat, m,
                                                 valid=valid), iters,
                key=_short)
    print(json.dumps(out))
    return 0


def _run(tree: str, args, warm: bool):
    cmd = [sys.executable, os.path.abspath(__file__), "--child", tree,
           "--cases", args.cases, "--iters", str(args.iters)]
    return subprocess.Popen(cmd + (["--warm"] if warm else []), cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(proc, tree: str) -> dict:
    out, err = proc.communicate(timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("trees", nargs="*")
    parser.add_argument("--cases", default="k2_f32,k2_bf16,k3b_f32,k3b_bf16")
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--out", default="")
    parser.add_argument("--child", default="")
    parser.add_argument("--warm", action="store_true")
    args = parser.parse_args(argv)
    cases = args.cases.split(",")
    if args.child:
        return child(args.child, cases, args.iters, args.warm)
    import torch

    if not torch.cuda.is_available():
        print("time_trees: no CUDA device", file=sys.stderr)
        return 2
    if not args.trees:
        parser.error("name at least one tree")
    builds = {t: _run(t, args, warm=True) for t in args.trees}
    for t, proc in builds.items():
        _result(proc, t)
    turns = {t: [] for t in args.trees}
    for t in args.trees + args.trees[::-1]:
        turns[t].append(_result(_run(t, args, warm=False), t))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    rows = []
    for case in cases:
        row = {"case": case, "trees": {
            t: {"total_ms": [sum(r[case].values()) for r in turns[t]],
                "kernel_ms": turns[t][0][case]} for t in args.trees}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps({**row, "smi": smi}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
