"""Where a train step's time goes, on the card.

    python -m nerf_replication_tpu_torch.tools.profile_train_step [--steps 8]

Needs the card and ``nvcc``. Generates the 200×200 procedural scene of
chip_smoke.py's training phase (20 train views) in a temporary directory
and, for three configurations of lego.yaml — ``fused_trunk true
fused_tile 512`` in float32 at 1024 rays per step, the same in bfloat16 at
4096 rays (BENCH_DEFAULTS.json), and ``fused_trunk false`` in float32 at
1024 rays — and for lego_proposal.yaml's proposal-sampling path with the
fused trunk (``proposal_f32_fused`` at 1024 rays, ``proposal_bf16_fused``
at 4096) — runs warm-up steps and then ``--steps`` measured steps that
repeat the trainer's step (``Trainer.step``) phase by phase:

* CUDA events split each step into the batch draw + coarse/fine (or
  proposal + fine) render + loss (``forward``), ``backward`` and the optimizer (clip + Adam);
* ``torch.profiler`` over the same steps sums device time by kernel: K1
  (``fused_mlp_fwd_kernel``), K2's two kernels K2a
  (``fused_mlp_bwd_rows_kernel``) and K2b (``fused_mlp_bwd_dw_kernel``),
  K2's reduce,
  cuBLAS/CUTLASS products (the plain network) and everything else
  (encoding, sampling, sort, compositing, autograd's elementwise work,
  Adam's kernels);
* the device's idle share is 1 − (kernel time / the steps' device
  timeline), both under the profiler and for the same number of steps run
  before it without the profiler (``step_ms_unprofiled``), where the host's
  own overhead is not inflated.

The NGP configurations (``task_arg.ngp_training``, the instant-ngp trainer
with a live grid) run ``NGPTrainer._one_step`` in one phase each, split by
CUDA events into render + loss, backward, optimizer and the grid update:
``ngp_f32_warm`` / ``ngp_f32_march`` (lego_hash, 1024 rays, the per-ray
march), ``ngp_bf16_packed_warm`` / ``_march`` (4096 rays, the packed march)
and ``ngp_cellpacked_march`` (lego_hash_packed.yaml, the packed march). The
march phase runs over a 64³ ball grid that fills ~5% of the volume, the
occupancy of a carved lego grid (random weights). Kernel time adds K6
(``hash_fwd_kernel``) and K6b (``hash_bwd_table_kernel``) categories.

Each configuration runs twice (``"mode"``): ``eager``, split by parts as
above, and ``graphed``, the step captured as a CUDA graph
(``compile/registry.py``; ``Trainer.step`` / ``NGPTrainer._one_step``
replaying it after their host part), timed as one part, since a replay
cannot be split. Both rows carry the step ms, the idle share, the kernels a
step and the peak memory (``torch.cuda.max_memory_allocated`` from a reset
before the configuration's state is made).

Prints one JSON line per configuration and mode and the nvidia-smi
name/power line; ``--out PATH`` also writes the lines (each with that line)
to a JSONL file.
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
    "proposal_f32_fused": ["precision.compute_dtype", "float32",
                           "task_arg.N_rays", "1024",
                           "network.nerf.fused_trunk", "true"],
    "proposal_bf16_fused": ["precision.compute_dtype", "bfloat16",
                            "task_arg.N_rays", "4096",
                            "network.nerf.fused_trunk", "true"],
}

HASH_NGP = ["network.nerf.fused_trunk", "false", "task_arg.ngp_training",
            "true"]
NGP_CONFIGS = {
    "ngp_f32_warm": ("lego_hash.yaml", "warm", HASH_NGP + [
        "task_arg.N_rays", "1024"]),
    "ngp_f32_march": ("lego_hash.yaml", "march", HASH_NGP + [
        "task_arg.N_rays", "1024"]),
    "ngp_bf16_packed_warm": ("lego_hash.yaml", "warm", HASH_NGP + [
        "task_arg.N_rays", "4096", "precision.compute_dtype", "bfloat16",
        "task_arg.ngp_packed_march", "true"]),
    "ngp_bf16_packed_march": ("lego_hash.yaml", "march", HASH_NGP + [
        "task_arg.N_rays", "4096", "precision.compute_dtype", "bfloat16",
        "task_arg.ngp_packed_march", "true"]),
    "ngp_cellpacked_march": ("lego_hash_packed.yaml", "march", HASH_NGP + [
        "task_arg.N_rays", "1024", "task_arg.ngp_packed_march", "true"]),
}


def _category(name: str) -> str:
    if "hash_fwd" in name:
        return "k6"
    if "hash_bwd" in name:
        return "k6b"
    if "fused_mlp_fwd" in name:
        return "k1"
    if "fused_mlp_bwd_rows" in name:
        return "k2a"
    if "fused_mlp_bwd_dw" in name:
        return "k2b"
    if "fused_mlp_reduce" in name:
        return "k2_reduce"
    low = name.lower()
    if "gemm" in low or "sm90_xmma" in low or "cutlass" in low \
            or "cublas" in low:
        return "matmul"
    return "other"


def _device_profile(torch, step, steps, n_parts):
    """CUDA-event part times, kernel time by category and the idle share of
    ``steps`` calls of ``step(events)`` (after the caller's warm-up)."""
    torch.cuda.synchronize()
    # the same steps without the profiler and without a host sync between
    # them: the device timeline a long run sees
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        step(None)
    end.record()
    torch.cuda.synchronize()
    unprofiled_ms = start.elapsed_time(end) / steps
    events = [[torch.cuda.Event(enable_timing=True)
               for _ in range(n_parts + 1)] for _ in range(steps)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for ev in events:
            step(ev)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    parts = [sum(ev[i].elapsed_time(ev[i + 1]) for ev in events) / steps
             for i in range(n_parts)]
    device_ms = sum(parts)
    kernels = {"k6": 0.0, "k6b": 0.0, "k1": 0.0, "k2a": 0.0, "k2b": 0.0,
               "k2_reduce": 0.0, "matmul": 0.0, "other": 0.0}
    n_kernels = 0
    for e in prof.events():  # one event per kernel launch on the card
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels[_category(e.name)] += e.time_range.elapsed_us() / 1e3 / steps
        n_kernels += 1
    busy = sum(kernels.values())
    return {
        "steps": steps, "step_ms_events": device_ms,
        "step_ms_wall_profiled": wall_ms, "parts_ms": parts,
        "kernel_ms": kernels,
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


def _graphs(torch, trainer, state, bank):
    """Install a registry on ``trainer`` and capture its steps; raises on
    a capture error."""
    from ..compile import AOTRegistry

    trainer.aot = AOTRegistry(device=bank[0].device)
    trainer.aot_register_steps(state, bank)
    status = trainer.aot.status()
    if status["errors"] or not status["captures"]:
        raise RuntimeError(f"step capture failed: {status}")
    return status


def profile_ngp(torch, label, cfg, phase, steps, warmup, graphed=False):
    """One NGP configuration in one phase (``warm`` or ``march``), eager
    (split by parts) or ``graphed``; ``occupancy`` is the grid's after the
    measured steps."""
    from ..datasets import make_dataset
    from ..models import make_network
    from ..train.ngp import NGPTrainer
    from .slice_inputs import ball_grid

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = NGPTrainer(cfg, make_network(cfg))
    state = trainer.make_state(dev)
    bank = [torch.from_numpy(a).to(dev)
            for a in make_dataset(cfg, "train").ray_bank()]
    warm = phase == "warm"
    if not warm:
        ball = torch.from_numpy(ball_grid(trainer.grid_res)).to(dev)
        state.grid_ema.copy_(ball.to(torch.float32) * (
            trainer.warm_factor * trainer.threshold))
    if graphed:
        _graphs(torch, trainer, state, bank)

    def step(events):
        if graphed:
            if events:
                events[0].record()
            trainer._one_step(state, bank[0], bank[1], warm)
            if events:
                events[1].record()
            return
        mark = (lambda i: events[i].record()) if events else None
        trainer._one_step(state, bank[0], bank[1], warm, mark=mark)

    for _ in range(warmup):
        step(None)
    row = _device_profile(torch, step, steps, 1 if graphed else 4)
    names = ("step",) if graphed else ("forward", "backward", "optimizer",
                                       "grid_update")
    parts = dict(zip(names, row.pop("parts_ms")))
    n_rays = int(cfg.task_arg.N_rays)
    return {"config": label, "mode": "graphed" if graphed else "eager",
            "phase": phase, "n_rays": n_rays,
            "dtype": str(cfg.precision.compute_dtype),
            "occupancy": float((state.grid_ema > trainer.threshold).float()
                               .mean()),
            "grid_res": trainer.grid_res,
            "rays_per_s": n_rays / row["step_ms_events"] * 1e3,
            "max_memory_allocated_mb":
                torch.cuda.max_memory_allocated(dev) / 2**20,
            "phase_ms": parts, **row}


def profile_graphed(torch, label, cfg, steps, warmup):
    """``Trainer.step`` replaying its captured step, timed as one part."""
    from ..datasets import make_dataset
    from ..models import make_network
    from ..registry import load_attr
    from ..train.trainer import Trainer, make_train_state

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    network = make_network(cfg)
    trainer = Trainer(cfg, network,
                      load_attr(cfg.loss_module, "make_loss")(cfg, network))
    state = make_train_state(cfg, network, dev)
    bank = [torch.from_numpy(a).to(dev)
            for a in make_dataset(cfg, "train").ray_bank()]
    _graphs(torch, trainer, state, bank)

    def step(events=None):
        if events:
            events[0].record()
        trainer.step(state, bank[0], bank[1])
        if events:
            events[1].record()

    for _ in range(warmup):
        step()
    row = _device_profile(torch, step, steps, 1)
    n_rays = int(cfg.task_arg.N_rays)
    return {"config": label, "mode": "graphed", "n_rays": n_rays,
            "dtype": str(cfg.precision.compute_dtype),
            "fused_trunk": bool(cfg.network.nerf.get("fused_trunk", False)),
            "rays_per_s": n_rays / row["step_ms_events"] * 1e3,
            "max_memory_allocated_mb":
                torch.cuda.max_memory_allocated(dev) / 2**20,
            "phase_ms": {"step": row.pop("parts_ms")[0]}, **row}


def profile(torch, label, cfg, steps, warmup):
    from ..datasets import make_dataset
    from ..datasets.sampling import sample_rays, step_generator
    from ..models import make_network
    from ..registry import load_attr
    from ..train.optim import apply_update
    from ..train.trainer import make_train_state

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
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
        # the step rides the batch, as in Trainer.step (the proposal
        # sampler's anneal reads it)
        _, value, _ = loss({"rays": rays, "rgbs": rgbs, "near": near,
                            "far": far, "step": state.step}, gen=gen,
                           train=True)
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
    row = _device_profile(torch, step, steps, 3)
    phases = dict(zip(("forward", "backward", "optimizer"),
                      row.pop("parts_ms")))
    return {"config": label, "mode": "eager", "n_rays": n_rays,
            "dtype": str(cfg.precision.compute_dtype),
            "fused_trunk": bool(cfg.network.nerf.get("fused_trunk", False)),
            "rays_per_s": n_rays / row["step_ms_events"] * 1e3,
            "max_memory_allocated_mb":
                torch.cuda.max_memory_allocated(dev) / 2**20,
            "phase_ms": phases, **row}


def profile_config(torch, label, data, tmp, graphed, steps, warmup):
    """The row of configuration ``label`` (``CONFIGS``, ``NGP_CONFIGS``)
    on the 200x200 procedural scene in ``data``, eager or ``graphed``."""
    from ..config import make_cfg

    opts = ["scene", "procedural", "train_dataset.data_root", data,
            "test_dataset.data_root", data, "train_dataset.H", "200",
            "train_dataset.W", "200", "test_dataset.H", "200",
            "test_dataset.W", "200", "network.nerf.fused_tile", "512",
            "task_arg.precrop_iters", "0",
            "trained_model_dir", os.path.join(tmp, "m"),
            "record_dir", os.path.join(tmp, "r")]
    if label in NGP_CONFIGS:
        name, phase, extra = NGP_CONFIGS[label]
        cfg = make_cfg(os.path.join(REPO, "configs", "nerf", name),
                       opts + extra)
        return profile_ngp(torch, label, cfg, phase, steps, warmup, graphed)
    name = ("lego_proposal.yaml" if label.startswith("proposal_")
            else "lego.yaml")
    cfg = make_cfg(os.path.join(REPO, "configs", "nerf", name),
                   opts + CONFIGS[label])
    return (profile_graphed if graphed else profile)(torch, label, cfg,
                                                     steps, warmup)


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--warmup", type=int, default=4)
    parser.add_argument("--configs",
                        default=",".join([*CONFIGS, *NGP_CONFIGS]))
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 2
    from ..datasets.procedural import generate_scene
    from ..ops import kernels
    from ..utils.platform import resolve_device

    resolve_device("cuda")
    kernels.build_all()
    rows = []
    with tempfile.TemporaryDirectory(prefix="profile_train_") as tmp:
        data = os.path.join(tmp, "data")
        generate_scene(data, "procedural", H=200, W=200, n_train=20,
                       n_test=2)
        for label in args.configs.split(","):
            for graphed in (False, True):
                row = profile_config(torch, label, data, tmp, graphed,
                                     args.steps, args.warmup)
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
