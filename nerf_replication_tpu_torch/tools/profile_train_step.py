"""Where a train step's time goes, on the card.

    python -m nerf_replication_tpu_torch.tools.profile_train_step [--steps 8]

Needs the card and ``nvcc``. Generates the 200×200 procedural scene of
chip_smoke.py's training phase (20 train views) in a temporary directory
and, for three configurations of lego.yaml — ``fused_trunk true
fused_tile 512`` in float32 at 1024 rays per step, the same in bfloat16 at
4096 rays (BENCH_DEFAULTS.json), and ``fused_trunk false`` in float32 at
1024 rays — runs warm-up steps and then ``--steps`` measured steps that
repeat the trainer's step (``Trainer.step``) phase by phase:

* CUDA events split each step into the batch draw + coarse/fine render +
  loss (``forward``), ``backward`` and the optimizer (clip + Adam);
* ``torch.profiler`` over the same steps sums device time by kernel: K1
  (``fused_mlp_fwd_kernel``), K2 (``fused_mlp_bwd_kernel``), K2's reduce,
  cuBLAS/CUTLASS products (the plain network) and everything else
  (encoding, sampling, sort, compositing, autograd's elementwise work,
  Adam's kernels);
* the device's idle share is 1 − (kernel time / the steps' device
  timeline), both under the profiler and for the same number of steps run
  before it without the profiler (``step_ms_unprofiled``), where the host's
  own overhead is not inflated.

Prints one JSON line per configuration and the nvidia-smi name/power line;
``--out PATH`` also writes the lines (each with that line) to a JSONL file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIGS = {
    "f32_fused": ["precision.compute_dtype", "float32", "task_arg.N_rays",
                  "1024", "network.nerf.fused_trunk", "true"],
    "bf16_fused": ["precision.compute_dtype", "bfloat16", "task_arg.N_rays",
                   "4096", "network.nerf.fused_trunk", "true"],
    "f32_plain": ["precision.compute_dtype", "float32", "task_arg.N_rays",
                  "1024", "network.nerf.fused_trunk", "false"],
}


def _category(name: str) -> str:
    if "fused_mlp_fwd" in name:
        return "k1"
    if "fused_mlp_bwd" in name:
        return "k2"
    if "fused_mlp_reduce" in name:
        return "k2_reduce"
    low = name.lower()
    if "gemm" in low or "sm90_xmma" in low or "cutlass" in low \
            or "cublas" in low:
        return "matmul"
    return "other"


def profile(torch, label, cfg, steps, warmup):
    from ..datasets import make_dataset
    from ..datasets.sampling import sample_rays, step_generator
    from ..models import make_network
    from ..registry import load_attr
    from ..train.optim import apply_update
    from ..train.trainer import make_train_state

    dev = torch.device("cuda")
    network = make_network(cfg)
    loss = load_attr(cfg.loss_module, "make_loss")(cfg, network)
    state = make_train_state(cfg, network, dev)
    bank = [torch.from_numpy(a).to(dev)
            for a in make_dataset(cfg, "train").ray_bank()]
    n_rays = int(cfg.task_arg.N_rays)
    near, far = float(cfg.task_arg.near), float(cfg.task_arg.far)
    params = list(network.parameters())

    def step(events=None):
        gen = step_generator(0, state.step, dev)
        if events:
            events[0].record()
        for p in params:
            p.grad = None
        rays, rgbs = sample_rays(gen, bank[0], bank[1], n_rays)
        _, value, _ = loss({"rays": rays, "rgbs": rgbs, "near": near,
                            "far": far}, gen=gen, train=True)
        if events:
            events[1].record()
        value.backward()
        if events:
            events[2].record()
        apply_update(state.optimizer, state.schedule, state.step)
        if events:
            events[3].record()
        state.step += 1

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    # the same steps without the profiler and without a host sync between
    # them: the device timeline a long run sees
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        step()
    end.record()
    torch.cuda.synchronize()
    unprofiled_ms = start.elapsed_time(end) / steps
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
              for _ in range(steps)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for ev in events:
            step(ev)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    phases = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    for ev in events:
        phases["forward"] += ev[0].elapsed_time(ev[1]) / steps
        phases["backward"] += ev[1].elapsed_time(ev[2]) / steps
        phases["optimizer"] += ev[2].elapsed_time(ev[3]) / steps
    device_ms = sum(phases.values())
    kernels = {"k1": 0.0, "k2": 0.0, "k2_reduce": 0.0, "matmul": 0.0,
               "other": 0.0}
    n_kernels = 0
    for e in prof.events():  # one event per kernel launch on the card
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels[_category(e.name)] += e.time_range.elapsed_us() / 1e3 / steps
        n_kernels += 1
    busy = sum(kernels.values())
    row = {
        "config": label, "n_rays": n_rays,
        "dtype": str(cfg.precision.compute_dtype),
        "fused_trunk": bool(cfg.network.nerf.get("fused_trunk", False)),
        "steps": steps, "step_ms_events": device_ms,
        "step_ms_wall_profiled": wall_ms, "rays_per_s": n_rays / device_ms
        * 1e3, "phase_ms": phases, "kernel_ms": kernels,
        "kernel_share": {k: v / busy for k, v in kernels.items()}
        if busy else {},
        "kernel_busy_ms": busy,
        "idle_share": max(0.0, 1.0 - busy / device_ms) if busy else None,
        "step_ms_unprofiled": unprofiled_ms,
        "idle_share_unprofiled": max(0.0, 1.0 - busy / unprofiled_ms)
        if busy else None,
        "kernels_per_step": n_kernels / steps,
        "device": torch.cuda.get_device_name(0),
    }
    return row


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--warmup", type=int, default=4)
    parser.add_argument("--configs", default=",".join(CONFIGS))
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 2
    from ..config import make_cfg
    from ..datasets.procedural import generate_scene
    from ..ops import kernels
    from ..utils.platform import resolve_device

    resolve_device("cuda")
    kernels.build_all()
    lego = os.path.join(REPO, "configs", "nerf", "lego.yaml")
    rows = []
    with tempfile.TemporaryDirectory(prefix="profile_train_") as tmp:
        data = os.path.join(tmp, "data")
        generate_scene(data, "procedural", H=200, W=200, n_train=20,
                       n_test=2)
        for label in args.configs.split(","):
            opts = ["scene", "procedural", "train_dataset.data_root", data,
                    "test_dataset.data_root", data, "train_dataset.H", "200",
                    "train_dataset.W", "200", "test_dataset.H", "200",
                    "test_dataset.W", "200", "network.nerf.fused_tile",
                    "512", "task_arg.precrop_iters", "0",
                    "trained_model_dir", os.path.join(tmp, "m"),
                    "record_dir", os.path.join(tmp, "r"),
                    *CONFIGS[label]]
            row = profile(torch, label, make_cfg(lego, opts), args.steps,
                          args.warmup)
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
