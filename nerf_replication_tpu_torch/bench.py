"""Headline benchmark of the port: training ray throughput on lego.

    python -m nerf_replication_tpu_torch.bench [--device cuda|cpu]

The counterpart of the root ``bench.py``: it reads ``BENCH_DEFAULTS.json``
(config, compute dtype, rays a step, ``scan_steps``, ``grad_accum`` and the
free-form ``opts``, e.g. ``network.nerf.fused_trunk true
network.nerf.fused_tile 512``), honours the same ``BENCH_*`` environment
overrides (``BENCH_N_RAYS``, ``BENCH_STEPS``, ``BENCH_CONFIG``,
``BENCH_OPTS``, ``BENCH_DTYPE``, ``BENCH_REMAT``, ``BENCH_SCAN_STEPS``,
``BENCH_GRAD_ACCUM``, ``BENCH_TAG``), builds the port's trainer from the
port's config and trains on a synthetic ray bank of 2^20 rays drawn on the
device from a seeded generator (throughput does not depend on the
content).

It runs 1 + 3 bursts of ``scan_steps`` steps as warm-up (the kernels build
on the first), then times three windows of ``BENCH_STEPS`` steps rounded up
to whole bursts, each ending in a device synchronisation, and reports the
median window. It prints ONE JSON line: ``{"metric": "train_rays_per_sec",
"value", "unit": "rays/s", "vs_baseline", ...}`` against the reference's
1024 rays per 0.222 s. A failure exits non-zero with no result line: there
is no fallback number.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_RAYS_PER_SEC = 1024 / 0.222  # the reference's mean iter time
N_BANK = 1 << 20
N_WINDOWS = 3


def bench_defaults() -> dict:
    """The root bench's defaults, updated from ``BENCH_DEFAULTS.json``."""
    defaults = {"n_rays": 4096, "steps": 50, "config": "lego.yaml",
                "dtype": "bfloat16", "remat": "false", "grad_accum": 1}
    with open(os.path.join(_REPO, "BENCH_DEFAULTS.json")) as f:
        defaults.update(json.load(f))
    return defaults


def bench_cfg(defaults: dict):
    """The bench's config: the defaults, the ``BENCH_*`` overrides on top
    (``opts`` of the defaults only apply to the defaults' config)."""
    from .config import make_cfg

    env = os.environ
    config = env.get("BENCH_CONFIG", defaults["config"])
    opts = env.get("BENCH_OPTS")
    if opts is None:
        opts = defaults.get("opts", "") if config == defaults.get(
            "config") else ""
    return make_cfg(os.path.join(_REPO, "configs", "nerf", config), [
        "task_arg.N_rays", env.get("BENCH_N_RAYS", str(defaults["n_rays"])),
        "task_arg.precrop_iters", "0",
        "precision.compute_dtype", env.get("BENCH_DTYPE", defaults["dtype"]),
        "task_arg.remat", env.get("BENCH_REMAT",
                                  str(defaults["remat"]).lower()),
        "task_arg.scan_steps", env.get(
            "BENCH_SCAN_STEPS", str(defaults.get("scan_steps", 1))),
        "task_arg.grad_accum", env.get(
            "BENCH_GRAD_ACCUM", str(defaults.get("grad_accum", 1))),
        *opts.split(),
    ]), config


def synthetic_bank(torch, dev, n: int = N_BANK, seed: int = 0):
    """``(rays [n, 6], rgbs [n, 3])`` on ``dev`` from a seeded generator:
    origins around (0, 0, -4), unit directions, uniform colours."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32 = torch.float32
    origins = torch.randn((n, 3), generator=gen, dtype=f32, device=dev) * 0.5
    origins = origins + torch.tensor([0.0, 0.0, -4.0], device=dev)
    dirs = torch.randn((n, 3), generator=gen, dtype=f32, device=dev)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    rgbs = torch.rand((n, 3), generator=gen, dtype=f32, device=dev)
    return torch.cat([origins, dirs], -1), rgbs


def card_line() -> str | None:
    """``name, power.limit`` of the first card as nvidia-smi reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def run(device: str = "cuda") -> dict:
    """Build, warm up and time the train step; the result record."""
    import numpy as np
    import torch

    from .models import make_network
    from .train.loss import make_loss
    from .train.trainer import Trainer, make_train_state
    from .utils.platform import resolve_device

    dev = resolve_device(device)
    defaults = bench_defaults()
    cfg, config = bench_cfg(defaults)
    env = os.environ
    n_steps = int(env.get("BENCH_STEPS", defaults["steps"]))

    network = make_network(cfg)
    trainer = Trainer(cfg, network, make_loss(cfg, network))
    state = make_train_state(cfg, network, dev)
    bank_rays, bank_rgbs = synthetic_bank(torch, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    scan_k = trainer.scan_steps
    n_bursts = max(1, -(-n_steps // scan_k))
    for _ in range(4):  # the first burst builds the kernels
        state, stats = trainer.multi_step(state, bank_rays, bank_rgbs)
    loss = float(stats["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss} after warm-up")
    n_rays = int(cfg.task_arg.N_rays)
    rates = []
    for _ in range(N_WINDOWS):
        sync()
        t0 = time.perf_counter()
        for _ in range(n_bursts):
            state, stats = trainer.multi_step(state, bank_rays, bank_rgbs)
        sync()
        rates.append(n_rays * n_bursts * scan_k / (time.perf_counter() - t0))
    loss = float(stats["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss} in the timed windows")
    value = float(np.median(rates))
    record = {
        "metric": "train_rays_per_sec",
        "value": round(value, 1),
        "unit": "rays/s",
        "vs_baseline": round(value / BASELINE_RAYS_PER_SEC, 2),
        "n_rays": n_rays,
        "dtype": str(cfg.precision.compute_dtype),
        "scan_steps": scan_k,
        "grad_accum": int(cfg.task_arg.get("grad_accum", 1)),
        "steps_per_window": n_bursts * scan_k,
        "windows": [round(r, 1) for r in rates],
        "config": config,
        "device": str(dev),
        "ts": round(time.time(), 1),
    }
    if dev.type == "cuda":
        record["card"] = card_line()
    if env.get("BENCH_TAG"):
        record["tag"] = env["BENCH_TAG"]
    return record


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print(json.dumps(run(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
