"""Where an occupancy-accelerated eval view's time goes, on the card.

    python -m nerf_replication_tpu_torch.tools.profile_eval [--hw 200] \
        [--graphed]

Needs the card and ``nvcc``. Renders one lego-camera view (``--hw`` square,
4096-ray march chunks) of lego.yaml's network at full width, random weights
from seed 0, through ``Renderer.render_accelerated`` on four routes — the
per-ray march and the hierarchical packed march (``march_coarse_block 8``)
with ``fused_trunk true`` (K1 / K3a), the clipped packed march
(``march_clip_bbox``, K3a), and the hierarchical packed march with the plain
Network (cuBLAS) — over two ball grids of 128³: radius 0.46 (5.1% occupied,
a carved lego-class grid) and 0.9 (38%, the density of a grid baked after a
short training run). For each it prints one JSON line:

* ``view_ms``: CUDA events around ``--iters`` renders after one warm-up,
  with no host sync between them;
* ``kernel_ms`` by kind under ``torch.profiler`` (one more render): K1, K3a,
  cuBLAS/CUTLASS products, sort / scan / segmented-reduce kernels of the
  packed compaction (``sort_scan``) and everything else (``other``: the
  sweep's gathers, encoding, compositing);
* ``idle_share`` = 1 − kernel time / ``view_ms``, and the kernels per view;
* the stream's rows and occupied rows (``march_candidates``,
  ``march_samples_out``), so K3a's skipped-tile share can be read off;
* ``peak_mb``: ``max_memory_allocated`` from the renderer's build to the
  last render (with ``--graphed``, the capture's pool included).

``--graphed`` adds a second pass per route and grid (``mode: graphed``):
the view's march registered with ``Renderer.aot_register_eval``, captured
as a CUDA graph and replayed on every render, its maps held bitwise to the
eager pass's.

Then the nvidia-smi name/power line; ``--out PATH`` also writes the lines.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ROUTES = {
    "per_ray_fused": ["network.nerf.fused_trunk", "true"],
    "packed_hier_fused": ["network.nerf.fused_trunk", "true",
                          "task_arg.march_coarse_block", "8"],
    "packed_clip_fused": ["network.nerf.fused_trunk", "true",
                          "task_arg.march_clip_bbox", "true"],
    "packed_hier_plain": ["network.nerf.fused_trunk", "false",
                          "task_arg.march_coarse_block", "8"],
}
GRIDS = {"ball_0.46": 0.46, "ball_0.9": 0.9}


def _category(name: str) -> str:
    if "fused_mlp_fwd" in name:
        return "k3a" if "true" in name else "k1"
    low = name.lower()
    if "gemm" in low or "sm90_xmma" in low or "cutlass" in low \
            or "cublas" in low:
        return "matmul"
    if "sort" in low or "scan" in low or "segment" in low:
        return "sort_scan"
    return "other"


def profile(torch, np, cfg, grid_np, rays, iters, graphed=False):
    from ..compile import AOTRegistry
    from ..models import init_params_for, make_network
    from ..renderer.volume import make_renderer

    dev = torch.device("cuda")
    network = make_network(cfg)
    init_params_for(cfg)(network, torch.Generator().manual_seed(0))
    network = network.to(dev).eval()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    renderer = make_renderer(cfg, network)
    renderer.occupancy_grid = torch.from_numpy(grid_np).to(dev)
    renderer.grid_bbox = torch.tensor(
        np.asarray(cfg.train_dataset.scene_bbox, np.float32), device=dev)
    batch = {"rays": torch.from_numpy(rays).to(dev),
             "near": float(cfg.task_arg.near), "far": float(cfg.task_arg.far)}
    if graphed:
        registry = AOTRegistry(device=dev)
        renderer.aot_register_eval(registry, rays.shape[0], batch["near"],
                                   batch["far"], chunked=False)
        registry.compile_all()
        if renderer.aot_install(registry) != 1:
            raise RuntimeError(f"the view was not captured: "
                               f"{registry.status()}")

    def view():
        with torch.no_grad():
            return renderer.render_accelerated(batch)

    out = {k: v.clone() for k, v in view().items()}
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        view()
    end.record()
    torch.cuda.synchronize()
    view_ms = start.elapsed_time(end) / iters
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        view()
        torch.cuda.synchronize()
    kernels = {"k1": 0.0, "k3a": 0.0, "matmul": 0.0, "sort_scan": 0.0,
               "other": 0.0}
    n_kernels = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels[_category(e.name)] += e.time_range.elapsed_us() / 1e3
        n_kernels += 1
    busy = sum(kernels.values())
    stats = {k: float(v.sum()) for k, v in renderer.last_march_stats.items()
             if k in ("march_candidates", "march_samples_out")}
    renderer.report_truncation(log=lambda _msg: None)
    return {
        "mode": "graphed" if graphed else "eager",
        "view_ms": view_ms, "kernel_ms": kernels, "kernel_busy_ms": busy,
        "idle_share": max(0.0, 1.0 - busy / view_ms) if busy else None,
        "kernels_per_view": n_kernels,
        "peak_mb": torch.cuda.max_memory_allocated() / 2**20,
        "mean_acc": float(out["acc_map_f"].mean()), **stats,
    }, out


def main(argv=None) -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--hw", type=int, default=200)
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--out", default="")
    parser.add_argument("--graphed", action="store_true",
                        help="add a pass replaying each view's CUDA graph")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_eval: no CUDA device", file=sys.stderr)
        return 2
    from ..config import make_cfg
    from ..ops import kernels
    from ..utils.platform import resolve_device
    from .slice_inputs import ball_grid, view_rays

    resolve_device("cuda")
    kernels.build_all()
    lego = os.path.join(REPO, "configs", "nerf", "lego.yaml")
    rays = view_rays(30.0, args.hw)
    rows = []
    for gname, radius in GRIDS.items():
        grid = ball_grid(128, radius)
        for route, opts in ROUTES.items():
            cfg = make_cfg(lego, opts)
            maps = None
            for graphed in (False, True)[:1 + args.graphed]:
                res, out = profile(torch, np, cfg, grid, rays, args.iters,
                                   graphed)
                if maps is None:
                    maps = out
                elif any(not torch.equal(maps[k], out[k]) for k in maps):
                    raise RuntimeError(f"{route}: graphed maps differ")
                row = {"grid": gname, "occupancy": float(grid.mean()),
                       "route": route, "hw": args.hw, **res,
                       "device": torch.cuda.get_device_name(0)}
                rows.append(row)
                print(json.dumps(row), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps({**row, "smi": smi}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
