"""The fused-MLP kernels (K1 / K3a forward, K2 / K3b backward) and the fused
march K5 of several checkouts of the port, timed in turns on one card.

    python nerf_replication_tpu_torch/tools/time_trees.py TREE [TREE ...] \
        [--cases k1_f32,k1_bf16,k3a_f32,k3a_bf16,k5_f32,k5_bf16] \
        [--iters 5] [--out PATH]

Run it as a file, not with ``-m``. Each TREE is a directory that holds a
``nerf_replication_tpu_torch`` package (and ``configs/``): this checkout, an
earlier commit unpacked with ``git archive`` under ``build/``, or such a
copy with a kernel source edited (a phase compiled out, another product).
A child process per tree puts the tree first on ``sys.path``, so that the
tree's kernels build into its own ``build/``, and calls that tree's
wrappers, which every checkout of the port has: ``ops.fused_mlp.
mlp_forward`` (cases ``k1_*``, ``k3a_*``), ``mlp_backward`` (``k2_*``,
``k3b_*``) and ``ops.fused_march.march_full_block`` (``k5_*``); this tool
knows no kernel's C interface. The MLP inputs are those of
``profile_fused_mlp.py`` (``case_inputs``: the same seeds and shapes: M =
65,573 at lego width; the packed stream's 786,432 rows, 5% valid); K5's are
chip_smoke.py's serving inputs (16,384 rays of one view, a 128³ ball grid,
lego width, seed 0).

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


def _march_call(torch, tree: str, family: str, dev):
    """``march_full_block`` of ``tree`` on chip_smoke.py's serving inputs,
    as a callable."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.models.nerf.network import init_params
    from nerf_replication_tpu_torch.ops import fused_march as fm
    from nerf_replication_tpu_torch.ops.fused_mlp import fused_spec_for
    from nerf_replication_tpu_torch.renderer.accelerated import MarchOptions
    from nerf_replication_tpu_torch.tools.slice_inputs import (
        SLICE_OPTS,
        ball_grid,
        view_rays,
    )

    cfg = make_cfg(os.path.join(tree, "configs", "nerf", "lego.yaml"),
                   SLICE_OPTS)
    opts = MarchOptions.eval_from_cfg(cfg)
    net = make_network(cfg)
    init_params(net, torch.Generator().manual_seed(0))
    net = net.to(dev).eval()
    bbox = torch.tensor(cfg.train_dataset.scene_bbox, dtype=torch.float32,
                        device=dev)
    rays = torch.from_numpy(view_rays(30.0, 128)).to(dev)
    st, rays, grid, coarse, bbox = fm._prepare(
        rays, 2.0, 6.0, torch.from_numpy(ball_grid()).to(dev), bbox, opts)
    kt = fm.compositing_tile(opts, opts.chunk_size)
    spec = fused_spec_for(net if family == "f32" else
                          net.clone(torch.bfloat16))
    weights = fm.FusedWeights(spec, net.fine)
    return lambda: fm.march_full_block(st, weights, net.xyz_encoder,
                                       net.dir_encoder, kt, rays, grid,
                                       coarse, bbox)


def child(tree: str, cases: list[str], iters: int, warm: bool) -> int:
    """In the child: time ``tree``'s wrappers on every case and print
    ``{case: {kernel: ms}}``; with ``warm``, only build its kernels."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp
    from nerf_replication_tpu_torch.ops import kernels
    from profile_fused_mlp import case_inputs, device_ms

    if not fmlp.__file__.startswith(tree):
        raise RuntimeError(f"{fmlp.__file__} is not of {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {}
    if warm:
        kernels.build_all()
        cases = []
    with torch.no_grad():
        for case in cases:
            kind, family = case.split("_")
            if kind == "k5":
                call = _march_call(torch, tree, family, dev)
            else:
                spec, x, v, draw, flat, m, valid = case_inputs(
                    torch, np, case, dev)
                if kind in ("k1", "k3a"):
                    def call():
                        return fmlp.mlp_forward(spec, x, v, flat, m,
                                                valid=valid)
                else:
                    def call():
                        return fmlp.mlp_backward(spec, x, v, draw, flat, m,
                                                 valid=valid)
            out[case] = device_ms(torch, call, iters, key=_short)
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
    parser.add_argument(
        "--cases", default="k1_f32,k1_bf16,k3a_f32,k3a_bf16,k5_f32,k5_bf16")
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
