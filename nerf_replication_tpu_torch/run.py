"""Stage-by-stage eval CLI of the port (the counterpart of the root
``run.py``):

    python -m nerf_replication_tpu_torch.run --type evaluate \\
        --cfg_file configs/nerf/lego.yaml --device cuda [key value ...]
    python -m nerf_replication_tpu_torch.run --type network  --cfg_file ...
    python -m nerf_replication_tpu_torch.run --type dataset  --cfg_file ...
    python -m nerf_replication_tpu_torch.run --type mesh     --cfg_file ...

* ``dataset``: iterates the train split's host loader
  (``datasets.make_data_loader``: sampler → ``__getitem__`` → collate →
  prefetch), capped at 1000 batches, and prints the JAX CLI's line. numpy
  on the host: no device is used (the trainer itself samples on the
  device).
* ``network``: a timed whole-image render of every test view (chunked).
* ``evaluate``: render every test view through the render gate — the
  occupancy-accelerated march when ``task_arg.accelerated_renderer`` is set
  and ``logs/<cfg>/occupancy_grid.npz`` loads, else the chunked render —
  score PSNR/SSIM with ``evaluators/nerf.py`` (PNGs and ``summary.json`` in
  ``result_dir``), and print the mean net_time / fps and the summary.

On the card, under ``compile.aot`` (default on), ``evaluate`` captures the
route it renders (the march when the grid loaded, else the chunked render)
as a CUDA graph before the timed loop and prints the registry's ``compile:``
line; every view then replays it. The first view is left out of the mean
net_time all the same (the reference does so). ``--device cpu`` runs the
plain PyTorch path on the CPU. ``network`` and ``evaluate`` append a
``run_meta`` and an ``eval`` row to ``<record_dir>/telemetry.jsonl``, as the
JAX CLI does, so quality and fps are diffable by ``scripts/tlm_report.py``.
``--type mesh`` writes the trained network's density iso-surface as
``<result_dir>/mesh.ply`` (``utils/mesh.py``). Under torchrun with
``eval.sharded true``, ``evaluate`` renders each view over the ranks (the
sequence-parallel gate, each rank's slice captured as a CUDA graph); every
rank renders, the chief scores and writes the metrics and images.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _load_eval_setup(cfg, device):
    """(network from the trained checkpoint, renderer, test set, device);
    the process group started first when a launcher asked for one (this
    rank's card)."""
    from .datasets import make_dataset
    from .parallel.mesh import multihost_init, rank_device
    from .renderer.volume import make_renderer
    from .utils.setup import load_trained_network
    from .utils.platform import resolve_device

    multihost_init(cfg, device)
    dev = resolve_device(rank_device(device))
    network, _ = load_trained_network(cfg, dev)
    renderer = make_renderer(cfg, network)
    test_ds = make_dataset(cfg, "test")
    return network, renderer, test_ds, dev


def _device_of(args) -> str:
    return getattr(args, "device", None) or "cuda"


def _batch_on(batch: dict, dev) -> dict:
    return {"rays": torch.from_numpy(np.ascontiguousarray(batch["rays"])).to(
        dev), "near": float(batch["near"]), "far": float(batch["far"])}


def _mean_times(net_times: list[float]) -> float:
    times = net_times[1:] if len(net_times) > 1 else net_times
    return float(np.mean(times))


def run_dataset(cfg, args=None):
    """Iterate the train loader contract: the full sampler → collate →
    prefetch pipeline, capped at 1000 batches (the JAX ``run_dataset``)."""
    from .datasets import make_data_loader

    loader = make_data_loader(cfg, "train", max_iter=1000)
    t0 = time.time()
    n = 0
    for _ in loader:
        n += 1
    dt = time.time() - t0
    print(f"iterated {n} batches in {dt:.2f}s ({n / dt:.1f} it/s)")


def run_network(cfg, args=None):
    """Timed whole-image render of every test view (chunked)."""
    from .renderer.gate import full_image_render_fn

    network, renderer, test_ds, dev = _load_eval_setup(cfg, _device_of(args))
    render = full_image_render_fn(cfg, network, renderer, test_ds)
    net_times = []
    for i in range(len(test_ds)):
        batch = _batch_on(test_ds.image_batch(i), dev)
        _sync(dev)
        t0 = time.perf_counter()
        render(batch)
        _sync(dev)
        net_times.append(time.perf_counter() - t0)
    mean = _mean_times(net_times)
    print(f"mean net_time: {mean:.4f}s  fps: {1.0 / mean:.3f}")
    _eval_row(cfg, "eval_network", "network", {}, len(net_times), mean)
    return {"mean_net_time_s": mean, "n_images": len(net_times)}


def _eval_row(cfg, component: str, prefix: str, metrics: dict,
              n_images: int, mean_s: float) -> None:
    """The run's ``run_meta`` and its one ``eval`` row."""
    from .obs import init_run

    emitter = init_run(cfg, component=component)
    emitter.emit("eval", prefix=prefix,
                 metrics={k: float(v) for k, v in metrics.items()},
                 n_images=n_images, mean_net_time_s=float(mean_s),
                 fps=float(1.0 / mean_s))
    emitter.close()


def run_evaluate(cfg, args=None):
    """Render every test view, PSNR/SSIM, summary.json. Returns the
    evaluator's summary plus ``mean_net_time_s``, ``fps``, ``n_images``,
    ``used_grid``, ``n_truncated``, for a march that reports them, the
    per-chunk traversal stats averaged over the views (``march``), and the
    registry's status after the views (``compile``; None: eager)."""
    from .evaluators import make_evaluator
    from .parallel.mesh import is_chief
    from .renderer.gate import full_image_render_fn
    from .renderer.occupancy import default_grid_path

    network, renderer, test_ds, dev = _load_eval_setup(cfg, _device_of(args))
    # every rank of a sharded eval renders; the chief scores and writes
    evaluator = make_evaluator(cfg) if is_chief() else None

    grid_loaded = False
    if bool(cfg.task_arg.get("accelerated_renderer", False)):
        grid_path = default_grid_path(getattr(args, "cfg_file", "config"))
        grid_loaded = renderer.load_occupancy_grid(grid_path)
    render = full_image_render_fn(cfg, network, renderer, test_ds,
                                  use_grid=grid_loaded)
    registry = _capture_eval(cfg, renderer, test_ds, dev, grid_loaded,
                             render)

    net_times, march = [], {}
    for i in range(len(test_ds)):
        host = test_ds.image_batch(i)
        batch = _batch_on(host, dev)
        _sync(dev)
        t0 = time.perf_counter()
        out = render(batch)
        _sync(dev)
        net_times.append(time.perf_counter() - t0)
        for k, v in renderer.last_march_stats.items():
            if k != "sweep":
                march.setdefault(k, []).append(v.float().mean().item())
        if evaluator is not None:
            evaluator.evaluate({k: v.cpu().numpy() for k, v in out.items()},
                               host)

    result = evaluator.summarize() if evaluator is not None else {}
    n_truncated = renderer.report_truncation()
    mean = _mean_times(net_times)
    print(f"mean net_time: {mean:.4f}s  fps: {1.0 / mean:.3f}")
    march = {k: float(np.mean(v)) for k, v in march.items()}
    if march:
        print("march: " + "  ".join(f"{k}: {v:.6g}" for k, v in march.items()))
    print(result)
    _eval_row(cfg, "evaluate", "evaluate", result or {}, len(net_times), mean)
    return {**(result or {}), "mean_net_time_s": mean, "fps": 1.0 / mean,
            "n_images": len(net_times), "used_grid": grid_loaded,
            "n_truncated": n_truncated, "march": march or None,
            "compile": None if registry is None else registry.status()}


def _capture_eval(cfg, renderer, test_ds, dev, use_grid: bool, render=None):
    """The view's render captured (``compile.aot`` on the card) and
    installed in ``renderer`` (a sharded gate's ``render``: this rank's
    slice), and the registry's ``compile:`` line printed; returns the
    registry (None: eager)."""
    from .compile import registry_from_cfg

    registry = registry_from_cfg(cfg, dev)
    if registry is None or not registry.enabled or not len(test_ds):
        return None
    first = test_ds.image_batch(0)
    if render is not None and render.mesh is not None:
        from .parallel import sequence

        n = first["rays"].shape[0]
        if use_grid:
            sequence.aot_register_sequence_march(
                registry, render.surface, n, renderer.occupancy_grid,
                renderer.grid_bbox)
        else:
            sequence.aot_register_sequence_renderer(
                registry, render.surface, n, width=first["rays"].shape[1])
        print("compile: " + json.dumps(registry.status()))
        return registry
    renderer.aot_register_eval(registry, first["rays"].shape[0],
                               first["near"], first["far"],
                               chunked=not use_grid)
    registry.compile_all()
    renderer.aot_install(registry)
    print("compile: " + json.dumps(registry.status()))
    return registry


def run_mesh(cfg, args=None) -> str:
    """The trained network's density iso-surface as a PLY mesh
    (``utils/mesh.extract_mesh``: ``cfg.resolution``, ``cfg.level``, the
    train split's ``scene_bbox``) in ``<result_dir>/mesh.ply``; returns its
    path."""
    from .utils.mesh import extract_mesh
    from .utils.platform import resolve_device
    from .utils.setup import load_trained_network

    network, _ = load_trained_network(cfg, resolve_device(_device_of(args)))
    path = extract_mesh(network, cfg)
    print(f"mesh saved to {path}")
    return path


def main(argv=None) -> int:
    from .config import cfg_from_args, make_parser

    parser = make_parser()
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cfg = cfg_from_args(args)
    from .utils.setup import configure_runtime

    configure_runtime(cfg)
    fn = globals().get("run_" + args.type)
    if fn is None:
        known = sorted(n[len("run_"):] for n in globals()
                       if n.startswith("run_"))
        raise SystemExit(f"unknown --type {args.type!r}; choose from {known}")
    fn(cfg, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
