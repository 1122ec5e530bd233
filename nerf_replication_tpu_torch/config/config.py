"""Config construction: defaults, YAML inheritance, CLI overrides, dir layout.

The PyTorch port's copy of ``nerf_replication_tpu/config/config.py``: the same
schema, the same defaults, ``parent_cfg`` recursive inheritance and trailing
``key value`` opts, so one YAML file configures either package. It is kept as
a copy (not an import) because the port never imports the JAX package. Keys
that only the JAX package reads (compile, scale, fleet, ...) stay in the
defaults so ``make_cfg`` yields the same tree on both sides.
"""

from __future__ import annotations

import argparse
import os
import subprocess
from typing import Sequence

import yaml

from .node import ConfigNode


def default_cfg() -> ConfigNode:
    """Template defaults covering the live capability surface (SURVEY.md §2.1)."""
    cfg = ConfigNode()

    # experiment identity / layout
    cfg.task = ""
    cfg.scene = "default"
    cfg.exp_name = "default"
    cfg.exp_name_tag = ""
    cfg.save_tag = "default"
    # accepted for config parity; the port takes its device as an argument
    cfg.gpus = [0]  # graftlint: ok(config-key: parity-only, never read)
    cfg.resume = True
    cfg.pretrain = ""
    # one seed feeds every stream: param init (utils/setup.py), the train
    # base key (train/trainer.py, train/ngp.py), host RNG pinning
    # (fix_random), and dataset generation (datasets/__init__.py)
    cfg.seed = 0
    # fix_random pins the host-side RNGs (random/np.random — dataset
    # generation, procedural scenes); the device path is already
    # deterministic via explicit key threading. ≙ reference train.py:25-28.
    cfg.fix_random = False
    # NaN-anomaly switch (≙ reference train.py:23's set_detect_anomaly)
    cfg.debug_nans = False
    cfg.skip_eval = False
    # the reference evaluator always dumps per-view pred/gt PNGs
    # (src/evaluators/nerf.py:29-38)
    cfg.save_result = True
    cfg.clear_result = False

    # plugin registry keys — resolved through nerf_replication_tpu.registry
    # (the dataset pair is read via a computed f"{split}_dataset_module"
    # key in datasets/__init__.py, invisible to static key tracking)
    cfg.train_dataset_module = "nerf_replication_tpu.datasets.blender"  # graftlint: ok(config-key: read via computed key)
    cfg.test_dataset_module = "nerf_replication_tpu.datasets.blender"  # graftlint: ok(config-key: read via computed key)
    cfg.network_module = "nerf_replication_tpu.models.nerf.network"
    cfg.renderer_module = "nerf_replication_tpu.renderer.volume"
    cfg.loss_module = "nerf_replication_tpu.train.loss"
    cfg.evaluator_module = "nerf_replication_tpu.evaluators.nerf"

    # epoch cadence (reference config.py:77-81; log_interval only via YAML there)
    cfg.ep_iter = -1
    cfg.save_ep = 100000
    cfg.save_latest_ep = 1
    cfg.eval_ep = 1
    cfg.log_interval = 20

    cfg.task_arg = ConfigNode()

    cfg.train = ConfigNode(
        {
            "epoch": 10000,
            "batch_size": 4,
            "num_workers": 0,
            "collator": "default",
            "batch_sampler": "default",
            "sampler_meta": {},
            "shuffle": True,
            "optim": "adam",
            "lr": 5e-4,
            "eps": 1e-8,
            "weight_decay": 0.0,
            "scheduler": {
                "type": "multi_step",
                "milestones": [80, 120, 200, 240],
                "gamma": 0.5,
            },
            # profiler window [start_step, start_step + num_steps) of the
            # training loop; start_step -1 = disabled
            "profile": {"start_step": -1, "num_steps": 0, "dir": ""},
        }
    )
    cfg.test = ConfigNode(
        {
            "batch_size": 1,
            "epoch": -1,
            "collator": "default",
            "batch_sampler": "default",
            "sampler_meta": {},
        }
    )
    # eval-render routing (renderer/gate.py, render_video.py): sharded
    # sends full-image renders sequence-parallel over the mesh's data axis
    # (a pod must not render 800² images on the chief chip alone);
    # whole_img is the evaluator's full-image-metrics switch
    cfg.eval = ConfigNode({"sharded": False, "whole_img": False})

    # output roots (specialized by parse_cfg into per-experiment dirs)
    cfg.trained_model_dir = "data/trained_model"
    cfg.trained_config_dir = "data/trained_config"
    cfg.record_dir = "data/record"
    cfg.result_dir = "data/result"

    # mesh extraction (reference config.py:11-12)
    cfg.level = 32.0
    cfg.resolution = 256

    # parallelism: axis sizes for the device mesh (-1 on the data axis
    # means "all remaining devices")
    cfg.parallel = ConfigNode(
        {
            "data_axis": -1,
            "model_axis": 1,
            "mesh_axes": ["data", "model"],
            "multihost": False,
        }
    )

    # precision knobs: compute dtype of the matmul chain, parameter dtype
    cfg.precision = ConfigNode({"compute_dtype": "float32", "param_dtype": "float32"})

    # learned sampling (renderer/sampling.py, models/proposal.py,
    # docs/sampling.md): mode "proposal" replaces the coarse pass with a
    # small density-only MLP — S_p = n_proposal stratified proposal-net
    # samples resampled (inverse-CDF over the proposal weight histogram)
    # into S_f = n_fine fine-network points, the proposal supervised by
    # the interlevel weight-bound loss (loss_mult) next to the photometric
    # loss. anneal_iters blends the resampling PDF from uniform to the
    # proposal histogram over early training; net sizes the proposal MLP.
    cfg.sampling = ConfigNode(
        {
            "mode": "coarse_fine",   # "proposal" enables the resampler
            "n_proposal": 64,        # S_p proposal-MLP samples per ray
            "n_fine": 32,            # S_f fine-MLP samples per ray
            "anneal_iters": 1000,    # uniform->sharp PDF anneal horizon
            "loss_mult": 1.0,        # interlevel loss weight
            "net": {"D": 2, "W": 64, "freq": 5},  # proposal MLP size
        }
    )

    # render-serving engine (nerf_replication_tpu/serve, docs/serving.md):
    # shape buckets are ray-chunk sizes arbitrary request shapes pad into
    # (each rounded up to a multiple of the render chunk size), so a mixed
    # request stream never retraces; the micro-batcher coalesces pending
    # requests until max_batch_rays or max_delay_ms, whichever first; under
    # backlog, shed_queue_depths are the queue depths (requests still
    # waiting) that activate degradation tiers 1..4
    # (bf16 / reduced_k / coarse / half_res)
    cfg.serve = ConfigNode(
        {
            "buckets": [4096, 16384],
            "max_batch_rays": 16384,
            "max_delay_ms": 5.0,
            "request_timeout_s": 30.0,
            "cache_entries": 64,     # pose->image LRU slots (0 disables)
            "pose_decimals": 3,      # camera-pose quantization for cache keys
            "warmup": True,          # pre-compile every (bucket, tier) pair
            "shed_queue_depths": [4, 8, 16, 32],
        }
    )

    # multi-scene serving fleet (nerf_replication_tpu/fleet, docs/fleet.md):
    # a manifest (or scan_dir) names the scenes; the residency manager
    # keeps an LRU of device-resident scenes under hbm_budget_mb — sized
    # from real leaf nbytes — with pinned leases for in-flight batches and
    # async host->device prefetch. Both discovery knobs empty = classic
    # single-scene serving; default_scene is the request alias for the
    # engine's own checkpoint.
    cfg.fleet = ConfigNode(
        {
            "manifest": "",             # scene manifest JSON (docs/fleet.md)
            "scan_dir": "",             # or: discover scenes by directory scan
            "store_dir": "",            # or: sharded SceneStore root (index.json)
            "hbm_budget_mb": 256.0,     # resident-scene byte budget
            "prefetch": True,           # background h2d on first sight
            "verify_checksums": True,   # tree-sha256 gate on scene checkpoints
            "default_scene": "default",  # alias for the engine's own scene
            # tiered residency ladder (fleet/ladder.py): > 0 keeps a
            # host-RAM staging tier so HBM eviction demotes instead of
            # dropping (re-promotion = device_put, no disk/checksum walk);
            # TTLs expire idle bytes at each tier (0 = never)
            "staging_mb": 0.0,          # host-RAM staging budget (0 = off)
            "staging_ttl_s": 0.0,       # staged-copy expiry
            "resident_ttl_s": 0.0,      # idle HBM-resident demotion
            # per-tenant QoS (fleet/qos.py): token-bucket admission (429
            # TenantQuotaError past the rate), weighted fair batch cuts,
            # and per-tenant breakers; tenants maps name -> {rate, burst,
            # weight} overrides of the defaults
            "qos": {
                "enabled": False,
                "default_rate": 200.0,   # sustained requests/s per tenant
                "default_burst": 50.0,   # bucket capacity (burst headroom)
                "default_weight": 1.0,   # fair-batching share
                "tenants": {},
            },
        }
    )

    # AOT compile registry (nerf_replication_tpu/compile, docs/compilation.md):
    # aot routes every registered jitted entrypoint through
    # lower().compile() up front on host threads (overlapping dataset /
    # checkpoint I/O) instead of building on first dispatch; artifacts
    # additionally serializes picklable executables (serve buckets, NGP
    # eval renders) to dir — "" anchors <repo>/data/jax_cache/aot — so a
    # second process deserializes instead of compiling at all
    cfg.compile = ConfigNode(
        {
            "aot": True,
            "artifacts": True,
            "dir": "",
        }
    )

    # resilience knobs (nerf_replication_tpu/resil, docs/robustness.md):
    # bounded-backoff retry on resumable load paths, the finite-loss guard
    # + divergence rollback budget, SIGTERM preemption flush, and the
    # serve dispatch circuit breaker
    cfg.resil = ConfigNode(
        {
            "retry_attempts": 3,       # tries per load before giving up
            "retry_base_s": 0.05,      # first backoff; doubles per retry
            "retry_max_s": 2.0,        # backoff ceiling
            "finite_guard": True,      # raise on non-finite host loss
            "max_rollbacks": 2,        # divergence rollbacks before abort
            "preempt_sigterm": True,   # SIGTERM -> checkpoint flush + exit
            "breaker_threshold": 5,    # consecutive dispatch failures to open
            "breaker_cooldown_s": 5.0,  # open -> half_open probe delay
        }
    )

    # observability knobs (nerf_replication_tpu/obs, docs/observability.md):
    # request-scoped span tracing, the crash flight recorder's ring size,
    # and the latency target /healthz's SLO view is computed against
    cfg.obs = ConfigNode(
        {
            "trace": True,           # span tracing on the serve path
            "trace_ring": 256,       # flight recorder span-ring capacity
            "flight_dir": "",        # "" -> record_dir (flight_<reason>.json)
            "slo_target_ms": 100.0,  # /healthz SLO attainment target
            # multi-window multi-burn-rate alerting (obs/alerts.py), the
            # incident correlator, and the capacity ledger — serve.py
            # wires all three when enabled
            "alerts": {
                "enabled": True,
                "slo_objective": 0.99,    # latency-SLO attainment objective
                "deny_objective": 0.99,   # tenant-admission objective
                "fast_burn": 14.4,        # page threshold (x budget)
                "slow_burn": 6.0,         # ticket threshold (x budget)
                "fast_short_s": 300.0,    # page windows: 5m AND 1h
                "fast_long_s": 3600.0,
                "slow_short_s": 1800.0,   # ticket windows: 30m AND 6h
                "slow_long_s": 21600.0,
                "clear_hold_s": 60.0,     # hysteresis before an alert clears
                "orphan_grace_s": 30.0,   # span-parent arrival grace
                "orphan_rate_max": 0.05,  # orphan-span rate ticket threshold
                "thrash_per_min_max": 6.0,  # demote+repromote churn/min
                "view_window_s": 300.0,   # /healthz windowed SLO view
                "capacity_every_s": 30.0,  # capacity_snapshot cadence
            },
        }
    )

    # replica scale-out knobs (nerf_replication_tpu/scale, docs/scaleout.md):
    # mesh-sharded dispatch over the data axis, the front-door router, and
    # the supervisor's closed loop on SLO attainment / per-tenant deny rate
    cfg.scale = ConfigNode(
        {
            "enabled": False,          # supervisor loop on/off
            "min_replicas": 1,
            "max_replicas": 4,
            "out_below": 0.90,         # attainment below -> miss window
            "in_above": 0.98,          # attainment at/above -> good window
            "deny_above": 0.05,        # tenant deny rate above -> miss
            "out_windows": 2,          # consecutive misses before scale-out
            "in_windows": 5,           # consecutive goods before scale-in
            "cooldown_out_s": 30.0,
            "cooldown_in_s": 120.0,
            "heartbeat_interval_s": 2.0,
            "heartbeat_timeout_s": 10.0,  # missed beats before dead
            "drain_timeout_s": 60.0,
            # "off" = plain jit; "auto" = shard chunks over the data mesh
            # when >1 device; "force" = mesh even on one device (the
            # CPU parity-test configuration)
            "mesh": "off",
            # 2-D serving mesh [data, model] (None -> all devices on
            # data). model > 1 = model-parallel serving: params shard by
            # parallel/sharding rules (hash tables row-sharded, MLP
            # width column-parallel), so each device holds ~1/model of
            # the scene — scenes bigger than one chip's HBM budget
            # become servable (docs/scaleout.md "Model-parallel serving")
            "mesh_shape": None,
            # scene placement planner (scale/placement.py): which replica
            # holds which scene. Disabled -> the router's passive
            # affinity/least-loaded dispatch is bitwise unchanged.
            "placement": {
                "enabled": False,
                "hot_width": 2,            # replicas per hot scene (R)
                "max_width": 4,            # replication-width ceiling
                "hot_rps": 0.5,            # requests/s at/above -> hot
                "width_rps": 2.0,          # extra replica per this much heat
                "hbm_budget_bytes": 0,     # 0 -> per-replica ladder budget
                "staging_budget_bytes": 0,  # 0 -> ladder staging budget
                "replan_every_s": 10.0,    # supervisor replan cadence
                "max_moves_per_step": 4,   # move-execution rate limit
            },
        }
    )

    return cfg


def _load_yaml(path: str) -> dict:
    with open(path, "r") as f:
        return yaml.safe_load(f) or {}


def _merge_with_parents(cfg: ConfigNode, cfg_file: str, _depth: int = 0) -> None:
    """Recursive ``parent_cfg`` inheritance (reference config.py:177-188)."""
    if _depth > 16:
        raise RecursionError(f"parent_cfg chain too deep at {cfg_file}")
    data = _load_yaml(cfg_file)
    parent = data.pop("parent_cfg", None)
    if parent is not None:
        if not os.path.isabs(parent):
            # Parents are repo-root-relative in the reference; also try
            # relative to the child file and to this repo's root so configs
            # resolve regardless of cwd.
            repo_root = os.path.dirname(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            )
            for base in (
                os.getcwd(),
                os.path.dirname(os.path.abspath(cfg_file)),
                repo_root,
            ):
                cand = os.path.join(base, parent)
                if os.path.exists(cand):
                    parent = cand
                    break
        _merge_with_parents(cfg, parent, _depth + 1)
    cfg.merge(data)


def _git_describe(args_: Sequence[str]) -> str:
    try:
        out = subprocess.run(
            ["git", *args_], capture_output=True, text=True, timeout=5
        )
        return out.stdout.strip()
  
    # graftlint: ok(swallow: best-effort git metadata; empty value lands in run_meta)
    except Exception:
        return ""


def parse_cfg(cfg: ConfigNode, slurm_local_rank: int = 0) -> None:
    """Derive experiment name templates and output dirs (config.py:134-175)."""
    if not cfg.task:
        raise ValueError("task must be specified")

    if cfg.exp_name_tag:
        cfg.exp_name = f"{cfg.exp_name}_{cfg.exp_name_tag}"
    if "gitbranch" in cfg.exp_name:
        branch = _git_describe(["describe", "--all"])
        cfg.exp_name = cfg.exp_name.replace("gitbranch", branch[6:] or "nobranch")
    if "gitcommit" in cfg.exp_name:
        commit = _git_describe(["describe", "--tags", "--always"])
        cfg.exp_name = cfg.exp_name.replace("gitcommit", commit or "nocommit")

    exp = os.path.join(cfg.task, cfg.scene, cfg.exp_name)
    cfg.trained_model_dir = os.path.join(cfg.trained_model_dir, exp)
    cfg.trained_config_dir = os.path.join(cfg.trained_config_dir, exp)
    cfg.record_dir = os.path.join(cfg.record_dir, exp)
    cfg.result_dir = os.path.join(cfg.result_dir, exp, cfg.save_tag)
    # set for reference parity
    cfg.local_rank = slurm_local_rank  # graftlint: ok(config-key: parity-only, never read)


def make_cfg(
    cfg_file: str,
    opts: Sequence[str] = (),
    freeze: bool = True,
    default_task: str = "",
    local_rank: int = 0,
) -> ConfigNode:
    """Build a config: defaults ← parent chain ← cfg_file ← CLI opts."""
    cfg = default_cfg()
    _merge_with_parents(cfg, cfg_file)
    opts = list(opts)
    if "other_opts" in opts:  # reference's sentinel cutoff (config.py:190-194)
        opts = opts[: opts.index("other_opts")]
    cfg.merge_from_list(opts)
    if not cfg.task and default_task:
        cfg.task = default_task
    parse_cfg(cfg, slurm_local_rank=local_rank)
    if freeze:
        cfg.freeze()
    return cfg


def make_parser() -> argparse.ArgumentParser:
    """CLI surface shared by train.py / run.py (reference config.py:199-205)."""
    parser = argparse.ArgumentParser(description="nerf_replication_tpu")
    parser.add_argument("--cfg_file", default="configs/nerf/lego.yaml", type=str)
    parser.add_argument("--test", action="store_true", default=False)
    parser.add_argument("--type", type=str, default="")
    parser.add_argument("--local_rank", type=int, default=0)
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser


def cfg_from_args(args: argparse.Namespace, freeze: bool = True) -> ConfigNode:
    # `--type X` runs work with task-less configs (reference config.py:207-208
    # sets task="run" before the merge for exactly this case).
    return make_cfg(
        args.cfg_file,
        args.opts or (),
        freeze=freeze,
        default_task="run" if getattr(args, "type", "") else "",
        local_rank=getattr(args, "local_rank", 0),
    )
