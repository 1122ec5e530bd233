"""Trainer: the step loop, epoch cadence, validation and checkpointing.

Port of ``nerf_replication_tpu/train/trainer.py`` for one card. Each step
draws a batch from the device-resident ray bank, renders it coarse + fine
(through the fused MLP kernels K1/K2 under ``network.nerf.fused_trunk``) —
or, under ``sampling.mode: proposal``, through the proposal resampler and
the fine network, with the step count as the anneal's ``batch["step"]`` —
backpropagates the loss, clips gradients by value at 40 and takes an
optimizer step whose lr is the schedule at the step count (optax's order).

* RNG: one generator per step, seeded from ``(seed, step)``
  (``datasets/sampling.step_generator``), so a resumed run draws what an
  uninterrupted one would.
* Precrop warm-up: the first ``precrop_iters`` steps draw from the center
  crop's index pool.
* ``task_arg.scan_steps = K`` groups steps into bursts of K
  (:meth:`Trainer.multi_step`) with the JAX package's logging at burst
  boundaries; the port runs the K steps one after another (PyTorch runs
  eagerly; there is no scan to fuse them), with the same numerics.
* Validation renders whole test images through the render gate
  (``renderer/gate.py``) and feeds the evaluator.

``task_arg.ngp_training`` routes :func:`fit` to ``ngp.fit_ngp`` (the
occupancy-accelerated trainer with a live grid), as the JAX package does.

Not in the port yet, each raising ``NotImplementedError`` where a run asks
for it: a mesh of several cards (slice 7), ``pretrain`` warm starts, and the
divergence rollback (slice 10) — a non-finite loss stops the run. The
SIGTERM checkpoint flush (slice 10) is not installed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..datasets.sampling import step_generator
from ..resil import DivergenceError, check_finite
from .checkpoint import load_model, save_model, save_trained_config
from .optim import apply_update, make_optimizer
from .recorder import Recorder
from .step_core import sampled_grad_step


@dataclass
class TrainState:
    """What the JAX ``TrainState`` holds: the network (parameters), the
    optimizer (its moments) with its lr schedule, and the step count."""

    network: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: object
    step: int = 0


def make_train_state(cfg, network, device) -> TrainState:
    """Seeded init of ``network`` (``cfg.seed``), moved to ``device``, and
    its optimizer."""
    from ..models import init_params_for

    gen = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    init_params_for(cfg)(network, gen)
    network.to(device)
    optimizer, schedule = make_optimizer(cfg, network.parameters())
    return TrainState(network, optimizer, schedule, 0)


def _later_slice(what: str, slice_no: int) -> NotImplementedError:
    return NotImplementedError(f"{what} comes with port slice {slice_no}")


class Trainer:
    def __init__(self, cfg, network, loss, evaluator=None, mesh=None):
        if mesh is not None:
            raise _later_slice("training over a mesh of cards", 7)
        self.cfg = cfg
        self.network = network
        self.loss = loss  # NeRFLoss: (batch, gen, train) -> (out, loss, stats)
        self.evaluator = evaluator
        self.seed = int(cfg.get("seed", 0))
        self.n_rays = int(
            cfg.task_arg.get("N_rays", cfg.task_arg.get("N_pixels", 1024))
        )
        bounds = getattr(loss, "ray_bounds", None)
        if bounds is not None and "near" not in cfg.task_arg:
            self.near, self.far = float(bounds[0]), float(bounds[1])
        else:
            self.near = float(cfg.task_arg.near)
            self.far = float(cfg.task_arg.far)
        self.precrop_iters = int(cfg.task_arg.get("precrop_iters", 0))
        self.ep_iter = int(cfg.get("ep_iter", 500))
        self.scan_steps = max(1, int(cfg.task_arg.get("scan_steps", 1)))
        self.grad_accum = max(1, int(cfg.task_arg.get("grad_accum", 1)))
        self.finite_guard = bool(cfg.get("resil", {}).get("finite_guard", True))
        self._val_render = None

    def epoch_iters(self, bank_size: int) -> int:
        """Steps per epoch; ep_iter=-1 means one pass over the bank."""
        if self.ep_iter > 0:
            return self.ep_iter
        return max(1, bank_size // self.n_rays)

    def step(self, state: TrainState, bank_rays, bank_rgbs, index_pool=None):
        """One optimization step: ``(state, stats)`` (stats stay tensors on
        the device; reading them is the caller's synchronisation)."""
        gen = step_generator(self.seed, state.step, bank_rays.device)
        stats = sampled_grad_step(
            self.loss, state.network.parameters(), bank_rays, bank_rgbs,
            self.n_rays, self.near, self.far, gen, index_pool=index_pool,
            grad_accum=self.grad_accum, step=state.step,
        )
        apply_update(state.optimizer, state.schedule, state.step)
        state.step += 1
        return state, stats

    def multi_step(self, state: TrainState, bank_rays, bank_rgbs,
                   k_steps: int | None = None):
        """A burst of ``k_steps`` steps (``scan_steps`` by default); returns
        the last step's stats, as the JAX scan burst does. Precrop steps
        never run in a burst (:meth:`train_epoch` single-steps them)."""
        k = int(k_steps if k_steps is not None else self.scan_steps)
        stats = None
        for _ in range(max(k, 1)):
            state, stats = self.step(state, bank_rays, bank_rgbs)
        return state, stats

    def train_epoch(self, state: TrainState, epoch: int, bank,
                    recorder: Recorder, index_pool=None, log=print,
                    emit=None):
        """One epoch of steps. ``emit(row)``, when given, receives one dict
        per logged burst — ``step``, ``epoch``, ``k``, ``step_time_s`` (host
        wall time per step, the burst ending in the stats read that
        synchronises with the card) and ``stats`` — the fields of the JAX
        package's telemetry ``step`` row."""
        bank_rays, bank_rgbs, pool = bank[0], bank[1], index_pool
        max_iter = self.epoch_iters(int(bank_rays.shape[0]))
        end = time.time()
        log_interval = int(self.cfg.get("log_interval", 20))
        stats = None
        it = 0
        while it < max_iter:
            data_time = time.time() - end
            use_pool = pool is not None and state.step < self.precrop_iters
            if use_pool or self.scan_steps <= 1:
                k = 1
                state, stats = self.step(state, bank_rays, bank_rgbs,
                                         index_pool=pool if use_pool else None)
            else:
                k = min(self.scan_steps, max_iter - it)
                state, stats = self.multi_step(state, bank_rays, bank_rgbs, k)
            # log when a burst crosses a log_interval boundary (k = 1: the
            # reference cadence)
            should_log = (
                it == 0
                or (it + k - 1) // log_interval > (it - 1) // log_interval
                or it + k >= max_iter
            )
            if should_log:
                stats_host = {kk: float(v) for kk, v in stats.items()}
                if self.finite_guard:
                    check_finite(stats_host, state.step)
                recorder.update_loss_stats(stats_host)
            recorder.step = state.step
            step_time = (time.time() - end) / k
            recorder.batch_time.update(step_time)
            recorder.data_time.update(data_time)
            end = time.time()
            if should_log:
                lr = float(state.schedule(state.step))
                log(recorder.console_line(
                    epoch, min(it + k - 1, max_iter - 1), max_iter, lr,
                    _device_mem_mb(bank_rays.device)))
                recorder.record("train")
                if emit is not None:
                    emit({"step": state.step, "epoch": epoch, "k": k,
                          "step_time_s": step_time, "lr": lr,
                          "stats": stats_host})
            it += k
        return state, stats

    def val(self, state: TrainState, epoch: int, test_dataset,
            recorder: Recorder | None = None, max_images: int | None = None,
            log=print):
        """Render whole test images and run the evaluator on each."""
        if self._val_render is None or self._val_render[0] is not test_dataset:
            from ..renderer.gate import full_image_render_fn

            self._val_render = (
                test_dataset,
                full_image_render_fn(self.cfg, self.network,
                                     self.loss.renderer, test_dataset,
                                     use_grid=False),
            )
        device = next(state.network.parameters()).device
        n = len(test_dataset)
        if max_images is not None:
            n = min(n, max_images)
        for i in range(n):
            batch = test_dataset.image_batch(i)
            out = self._val_render[1]({
                "rays": torch.from_numpy(batch["rays"]).to(device),
                "near": float(batch["near"]),
                "far": float(batch["far"]),
            })
            if self.evaluator is not None:
                self.evaluator.evaluate(
                    {k: v.cpu().numpy() for k, v in out.items()}, batch)
        result = {}
        if self.evaluator is not None:
            result = self.evaluator.summarize()
            if recorder is not None and result:
                recorder.record("val", step=epoch, stats=result)
            if result:
                log(f"val epoch {epoch}: " + "  ".join(
                    f"{k}: {v:.4f}" for k, v in result.items()
                ))
        return result


def _device_mem_mb(device) -> float | None:
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**20


def _check_single_card(cfg) -> None:
    par = cfg.get("parallel", {})
    if int(par.get("model_axis", 1)) > 1 or int(par.get("data_axis", -1)) > 1:
        raise _later_slice("parallel.data_axis/model_axis > 1 (a mesh)", 7)


def fit(cfg, network=None, log=print, device="cuda", emit=None):
    """Full training entry: build everything from cfg, resume if a
    checkpoint is there, run the epoch loop with the save/eval cadence on
    one card (``device``). ``emit`` receives the per-step rows of
    :meth:`Trainer.train_epoch`. Returns the final :class:`TrainState`."""
    from ..datasets import make_dataset
    from ..evaluators import make_evaluator
    from ..registry import load_attr
    from ..utils.platform import resolve_device
    from .recorder import make_recorder

    if bool(cfg.task_arg.get("ngp_training", False)):
        # occupancy-accelerated training has its own state (the live grid
        # EMA) and march; same entry contract, its own epoch loop
        from .ngp import fit_ngp

        return fit_ngp(cfg, network=network, log=log, device=device,
                       emit=emit)
    _check_single_card(cfg)
    if cfg.get("pretrain", ""):
        raise NotImplementedError(
            "pretrain warm starts read the JAX package's Orbax checkpoints, "
            "which the port does not"
        )
    dev = resolve_device(device)

    if network is None:
        from ..models import make_network

        network = make_network(cfg)
    loss_factory = load_attr(cfg.loss_module, "make_loss", "NetworkWrapper")
    loss = loss_factory(cfg, network)
    evaluator = None if cfg.get("skip_eval", False) else make_evaluator(cfg)

    trainer = Trainer(cfg, network, loss, evaluator)
    recorder = make_recorder(cfg)
    state = make_train_state(cfg, network, dev)

    begin_epoch = 0
    if cfg.get("resume", True):
        state, begin_epoch, rec_state = load_model(cfg.trained_model_dir,
                                                   state)
        if rec_state:
            recorder.load_state_dict(rec_state)
    save_trained_config(cfg)

    train_ds = make_dataset(cfg, "train")
    bank = tuple(torch.from_numpy(a).to(dev) for a in train_ds.ray_bank())
    pool = None
    if trainer.precrop_iters > 0:
        frac = float(cfg.task_arg.get("precrop_frac", 0.5))
        pool = torch.from_numpy(
            np.asarray(train_ds.precrop_index_pool(frac))).to(dev)
    test_ds = make_dataset(cfg, "test")

    epochs = int(cfg.train.epoch)
    save_ep = int(cfg.get("save_ep", 40))
    save_latest_ep = int(cfg.get("save_latest_ep", 10))
    eval_ep = int(cfg.get("eval_ep", 10))
    for epoch in range(begin_epoch, epochs):
        recorder.epoch = epoch
        try:
            state, _ = trainer.train_epoch(state, epoch, bank, recorder,
                                           index_pool=pool, log=log,
                                           emit=emit)
        except DivergenceError as err:
            if int(cfg.get("resil", {}).get("max_rollbacks", 2)) > 0:
                raise _later_slice("rolling back to the last checkpoint "
                                   "after a non-finite loss", 10) from err
            raise
        if (epoch + 1) % save_ep == 0:
            save_model(cfg.trained_model_dir, state, epoch,
                       recorder.state_dict(), latest=False)
        if (epoch + 1) % save_latest_ep == 0:
            save_model(cfg.trained_model_dir, state, epoch,
                       recorder.state_dict(), latest=True)
        if (epoch + 1) % eval_ep == 0 and evaluator is not None:
            trainer.val(state, epoch, test_ds, recorder, log=log)
    return state

