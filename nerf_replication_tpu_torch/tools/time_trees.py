"""The fused-MLP kernels (K1 / K3a forward, K2 / K3b backward), the fused
march K4 and K5 and the hash encoder (K6 forward, K6b backward) of several
checkouts of the port, timed in turns on one card.

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
``k3b_*``), ``ops.fused_march.dda_block`` (``k4``, ``k4_chunk``, on a 38%
occupied grid ``k4_dense`` and with lego_hash's eval march ``k4_ngp``;
``k4_gather`` runs the engine's gather route around it:
``renderer.volume.map_chunks`` of ``staged_march_fn``; ``k4_request`` one
200x200 request through ``serve.engine_from_cfg``'s gather route),
``ops.fused_march.march_full_block`` (``k5_*``) and
``ops.hash_encode.hash_encode_fwd`` / ``hash_encode_bwd`` (``k6_*``,
``k6b_*``; the backward without dx, as the train step calls it); this tool
knows no kernel's C interface. The MLP inputs are those of
``profile_fused_mlp.py`` (``case_inputs``: the same seeds and shapes: M =
65,573 at lego width; the packed stream's 786,432 rows, 5% valid); K4's
and K5's are chip_smoke.py's serving inputs (16,384 rays of one view, a 128³ ball grid,
lego width, seed 0). K6/K6b run at lego_hash's full geometry (16 levels x
2, a 5,738,832-row table, uniform in [-1, 1] from seed 11) on point sets
that this checkout makes once and hands to every tree (``POINT_SETS``):
``ray``, the NGP warm step's 131,072 ray-ordered points
(``slice_inputs.ngp_points``, seed 0); ``ray4k``, the bf16 packed warm
step's 524,288 (4096 rays); ``uniform``, 131,072 uniform points;
``uniform16k``, 16,384 (the grid refresh's count); ``cell``, 16,384 points
inside one level-0 cell (the contention set).

The children first build their kernels, all at once. Then they run in
turns, the trees in order and then in reverse (A B .. B A), so that a drift
of the card's clock shows. For each case it prints one JSON line: each
tree's device ms per call by kernel name from torch.profiler (its first
turn), its total in each turn, each turn's device ms by kernel name and
each turn's ms per call on the host's clock.
``--out PATH`` also writes the lines, each with the nvidia-smi name/power
line, to a JSONL file.
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
POINTS = os.path.join(REPO, "build", "time_trees_points.npz")
POINT_SETS = ("ray", "ray4k", "uniform", "uniform16k", "cell")


def write_point_sets(path: str = POINTS) -> None:
    """The K6/K6b cases' point sets (float32 [N, 3] in [0, 1]), made by
    this checkout, into one npz file."""
    import numpy as np

    sys.path.insert(0, REPO)
    from nerf_replication_tpu_torch.tools.slice_inputs import (
        cell_points,
        ngp_points,
    )

    rng = np.random.default_rng(1)
    sets = {"ray": ngp_points(0), "ray4k": ngp_points(0, n_rays=4096),
            "uniform": rng.random((131072, 3), dtype=np.float32),
            "uniform16k": rng.random((16384, 3), dtype=np.float32),
            "cell": cell_points(16384, 15.0)}  # lego_hash level 0: scale 15
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **sets)


def _hash_call(torch, np, tree: str, kind: str, family: str, dev):
    """``tree``'s K6 (``kind`` k6) or K6b (k6b) wrapper on point set
    ``family``, as a callable."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.models.encoding import get_encoder
    from nerf_replication_tpu_torch.ops import hash_encode as he

    cfg = make_cfg(os.path.join(tree, "configs", "nerf", "lego_hash.yaml"))
    enc, out_dim = get_encoder(cfg.network.xyz_encoder)
    geo = enc.geometry
    gen = torch.Generator(device=dev).manual_seed(11)
    table = torch.rand((enc.n_entries, enc.level_dim), generator=gen,
                       device=dev) * 2 - 1
    x = torch.from_numpy(np.load(POINTS)[family]).to(dev)
    g = torch.randn((x.shape[0], out_dim), generator=gen, device=dev)
    if kind == "k6":
        return lambda: he.hash_encode_fwd(x, table, geo)
    return lambda: he.hash_encode_bwd(x, g, table, geo)


def _short(name: str) -> str:
    """A kernel's identifier without namespace, template or arguments."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0]
    head = re.sub(r"<.*>", "", head)
    return head.split("::")[-1].split()[-1]


def _serving_inputs(torch, tree: str, dev, fused: str = "full",
                    cfg_name: str = "lego", radius: float = 0.46):
    """``(cfg, options, _prepare'd inputs)`` of chip_smoke.py's serving
    slice, with ``march_fused`` = ``fused``, the eval march of
    ``configs/nerf/<cfg_name>.yaml`` and a ball grid of ``radius``."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.ops import fused_march as fm
    from nerf_replication_tpu_torch.renderer.accelerated import MarchOptions
    from nerf_replication_tpu_torch.tools.slice_inputs import (
        SLICE_OPTS,
        ball_grid,
        view_rays,
    )

    cfg = make_cfg(os.path.join(tree, "configs", "nerf", f"{cfg_name}.yaml"),
                   SLICE_OPTS[:2] + ["task_arg.march_fused", fused])
    opts = MarchOptions.eval_from_cfg(cfg)
    bbox = torch.tensor(cfg.train_dataset.scene_bbox, dtype=torch.float32,
                        device=dev)
    rays = torch.from_numpy(view_rays(30.0, 128)).to(dev)
    return cfg, opts, fm._prepare(
        rays, 2.0, 6.0, torch.from_numpy(ball_grid(128, radius)).to(dev),
        bbox, opts)


def _march_call(torch, tree: str, family: str, dev):
    """``march_full_block`` of ``tree`` on chip_smoke.py's serving inputs,
    as a callable."""
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.models.nerf.network import init_params
    from nerf_replication_tpu_torch.ops import fused_march as fm
    from nerf_replication_tpu_torch.ops.fused_mlp import fused_spec_for

    cfg, opts, (st, rays, grid, coarse, bbox) = _serving_inputs(
        torch, tree, dev)
    net = make_network(cfg)
    init_params(net, torch.Generator().manual_seed(0))
    net = net.to(dev).eval()
    kt = fm.compositing_tile(opts, opts.chunk_size)
    spec = fused_spec_for(net if family == "f32" else
                          net.clone(torch.bfloat16))
    weights = fm.FusedWeights(spec, net.fine)
    return lambda: fm.march_full_block(st, weights, net.xyz_encoder,
                                       net.dir_encoder, kt, rays, grid,
                                       coarse, bbox)


# K4's inputs other than the serving slice's: (config, ball radius). The
# 0.9 ball fills 38% of the grid, the density of a grid baked after a short
# training run (tools/profile_eval.py); lego_hash's eval march (the NGP
# trainer's gather route, step 0.005, K = 256) on it
K4_VARIANTS = {"dense": ("lego", 0.9), "ngp": ("lego_hash", 0.9)}


def _request_call(torch, np, tree: str, dev):
    """One 200x200 request through the serving engine's gather route, as
    chip_smoke.py's serving phase sends it: ``engine_from_cfg`` of
    ``tree`` on lego.yaml (``march_fused gather``, the 128³ ball grid, the
    seeded weights) in a temporary directory, which stays the working
    directory of this child."""
    import tempfile

    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.datasets.rays import (
        focal_from_fov,
        get_rays_np,
        pose_spherical,
    )
    from nerf_replication_tpu_torch.renderer.occupancy import (
        save_occupancy_grid,
    )
    from nerf_replication_tpu_torch.serve import engine_from_cfg
    from nerf_replication_tpu_torch.tools.slice_inputs import (
        LEGO_CAMERA_ANGLE_X,
        SLICE_OPTS,
        ball_grid,
    )

    tmp = tempfile.mkdtemp(prefix="time_trees_", dir=os.path.join(
        tree, "build"))
    os.makedirs(os.path.join(tmp, "data", "lego"))
    with open(os.path.join(tmp, "data", "lego", "transforms_test.json"),
              "w") as f:
        json.dump({"camera_angle_x": LEGO_CAMERA_ANGLE_X, "frames": []}, f)
    lego = os.path.join(tree, "configs", "nerf", "lego.yaml")
    cfg = make_cfg(lego, SLICE_OPTS[:2] + [
        "task_arg.march_fused", "gather", "test_dataset.data_root",
        os.path.join(tmp, "data")], default_task="run")
    os.chdir(tmp)  # default_grid_path is relative: logs/lego/...
    save_occupancy_grid(os.path.join("logs", "lego", "occupancy_grid.npz"),
                        ball_grid(), cfg.train_dataset.scene_bbox, 1.0)
    engine = engine_from_cfg(cfg, cfg_file=lego, device=str(dev))
    focal = focal_from_fov(200, LEGO_CAMERA_ANGLE_X)
    o, d = get_rays_np(200, 200, focal, pose_spherical(10.0, -30.0, 4.0))
    rays = np.concatenate([o, d], -1).reshape(-1, 6)
    return lambda: engine.render_request(rays, engine.near, engine.far)


def _dda_call(torch, np, tree: str, family: str, dev):
    """``dda_block`` (K4) of ``tree`` on chip_smoke.py's serving inputs
    (family ``""``: all 16,384 rays; ``chunk``: the middle 4,096, one
    launch of the serving engine's gather route; ``dense`` / ``ngp``: the
    16,384 rays on :data:`K4_VARIANTS`' grid and statics), or (``gather``)
    that route itself on the 16,384 rays: K4 and the plain lego network in
    ``march_chunk_size`` chunks, as the engine maps a bucket; or
    (``request``) one 200x200 request through the serving engine."""
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.models.nerf.network import init_params
    from nerf_replication_tpu_torch.ops import fused_march as fm
    from nerf_replication_tpu_torch.renderer.volume import (
        map_chunks,
        staged_march_fn,
    )

    if family == "request":
        return _request_call(torch, np, tree, dev)
    cfg_name, radius = K4_VARIANTS.get(family, ("lego", 0.46))
    cfg, opts, (st, rays, grid, coarse, bbox) = _serving_inputs(
        torch, tree, dev, "gather", cfg_name, radius)
    if family == "chunk":
        rays = rays[6144:10240].contiguous()
    if family != "gather":
        return lambda: fm.dda_block(st, rays, grid, coarse, bbox)
    net = make_network(cfg)
    init_params(net, torch.Generator().manual_seed(0))
    net = net.to(dev).eval()
    march = staged_march_fn(
        lambda pts, viewdirs, _m: net(pts, viewdirs, model="fine"),
        2.0, 6.0, grid.reshape((st.resolution,) * 3) > 0, bbox, opts, 0)
    return lambda: map_chunks(march, rays, opts.chunk_size)


# the one kernel source a case family needs (the rest build them all)
CASE_SOURCES = {"k4": "fused_dda", "k6": "hash_encode", "k6b": "hash_encode"}


def host_ms(torch, fn, iters: int) -> float:
    """Milliseconds per call of ``fn`` on the host's clock, the card
    synchronized before and after the ``iters`` calls."""
    import time

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def child(tree: str, cases: list[str], iters: int, warm: bool) -> int:
    """In the child: time ``tree``'s wrappers on every case and print
    ``{"device": {case: {kernel: ms}}, "host": {case: ms}}``; with
    ``warm``, only build its kernels."""
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
    out, host = {}, {}
    if warm:
        kinds = {c.partition("_")[0] for c in cases}
        if kinds <= set(CASE_SOURCES):
            for kind in kinds:
                # graftlint: ok(retrace: one load per distinct source)
                kernels.load(CASE_SOURCES[kind])
        else:
            kernels.build_all()
        cases = []
    with torch.no_grad():
        for case in cases:
            kind, _, family = case.partition("_")
            if kind == "k4":
                call = _dda_call(torch, np, tree, family, dev)
            elif kind == "k5":
                call = _march_call(torch, tree, family, dev)
            elif kind in ("k6", "k6b"):
                call = _hash_call(torch, np, tree, kind, family, dev)
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
            host[case] = host_ms(torch, call, iters)
    print(json.dumps({"device": out, "host": host}))
    return 0


def _run(tree: str, args, warm: bool):
    # the child runs in this checkout: a relative TREE is the caller's
    cmd = [sys.executable, os.path.abspath(__file__), "--child",
           os.path.abspath(tree), "--cases", args.cases, "--iters",
           str(args.iters)]
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
    if any(c.split("_")[0] in ("k6", "k6b") for c in cases):
        write_point_sets()
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
            t: {"total_ms": [sum(r["device"][case].values())
                             for r in turns[t]],
                "host_ms": [r["host"][case] for r in turns[t]],
                "kernel_ms": turns[t][0]["device"][case],
                "turn_kernel_ms": [r["device"][case] for r in turns[t]]}
            for t in args.trees}}
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
