"""Trainer: the step loop, epoch cadence, validation and checkpointing.

Port of ``nerf_replication_tpu/train/trainer.py`` for one card. Each step
draws a batch from the device-resident ray bank, renders it coarse + fine
(through the fused MLP kernels K1/K2 under ``network.nerf.fused_trunk``) —
or, under ``sampling.mode: proposal``, through the proposal resampler and
the fine network, with the step count as the anneal's ``batch["step"]`` —
backpropagates the loss, clips gradients by value at 40 and takes an
optimizer step whose lr is the schedule at the step count (optax's order).

* RNG: one generator per trainer, reseeded from ``(seed, step)`` before
  every step (``datasets/sampling.reseed``), so a resumed run draws what an
  uninterrupted one would.
* CUDA graphs (``compile.aot``, the JAX package's AOT registry;
  ``compile/registry.py``): :func:`fit` installs ``registry_from_cfg`` and
  :meth:`Trainer.aot_register_steps` captures the step (and the precrop
  pool's) before the loop; each step then does its host part (the
  generator's seed, the lr, the step count the proposal anneal reads) and
  replays the graph.
* Precrop warm-up: the first ``precrop_iters`` steps draw from the center
  crop's index pool.
* ``task_arg.scan_steps = K`` groups steps into bursts of K
  (:meth:`Trainer.multi_step`) with the JAX package's logging at burst
  boundaries; the port runs the K steps one after another (each step
  reseeds, so a burst replays one captured step K times), with the same
  numerics.
* Validation renders whole test images through the render gate
  (``renderer/gate.py``) and feeds the evaluator; under ``compile.aot``
  :func:`fit` captures the test view's chunked render beside the steps
  (:meth:`Trainer.aot_register_val`), and every view replays it.

``task_arg.ngp_training`` routes :func:`fit` to ``ngp.fit_ngp`` (the
occupancy-accelerated trainer with a live grid), as the JAX package does.

The ops layers (``obs/``, ``resil/``), as in the JAX ``fit``:

* Telemetry: :func:`fit` opens ``<record_dir>/telemetry.jsonl``
  (``obs.init_run``) after the recorder; the loop emits a ``step`` row per
  logged burst (with its dispatch/block split), the epoch cadence
  ``epoch`` / ``memory`` / ``heartbeat`` rows, validation ``eval`` and
  ``sample`` rows, and every capture is a ``compile`` row.
  In-process readers subscribe with ``obs.add_row_tap``.
* ``train.profile: {start_step, num_steps, dir}``: a ``torch.profiler``
  window over those steps (``obs.ProfileWindow``), ticked every burst.
* A non-finite loss (``resil.check_finite`` on the stats the log cadence
  reads anyway) rolls back to the last checkpoint, up to
  ``resil.max_rollbacks`` times, with a ``fault`` row; with no checkpoint
  it re-raises. The restore copies into the tensors the captured step
  reads (``checkpoint.load_model``), so the replays go on from it.
* ``resil.preempt_sigterm`` (default on): SIGTERM stops the loop at the
  next burst boundary, flushes ``latest.pt`` with the steps of the epoch
  already taken (``epoch_it``), and ``fit`` returns; a resumed run takes
  the rest of that epoch and ends where an uninterrupted run ends.
* ``pretrain``: a fresh run (begin epoch 0) warm-starts its parameters
  from a port checkpoint (``checkpoint.load_pretrain``).

Data parallelism (``parallel/``): under torchrun (or ``parallel.multihost``)
:func:`fit` starts the process group, permutes the ray bank globally with the
seed and gives each rank its slice (``parallel.shard_bank``; the precrop pool
rebased per rank), broadcasts rank 0's state, and steps through
``parallel.step.DPStep``: each rank draws ``N_rays / world`` rays from its
slice on its own stream, the gradients and stats are all-reduced between two
captured segments, and every rank applies the same update. Decisions the ranks
must take alike read reduced values (the finite guard reads the reduced stats;
a SIGTERM is agreed by a MAX over the ranks' flags at each burst boundary);
only the chief writes checkpoints, the recorder's files and telemetry, with a
barrier after each save. Validation renders on the chief, or on every rank
through the sequence-parallel gate under ``eval.sharded``.

Tensor parallelism (``parallel.model_axis > 1``, JAX ``trainer.py:128``):
the state is split by the rule table (``parallel.step.shard_train_state``:
the optimizer updates this rank's blocks), each block broadcast within its
data group, and the steps go through ``parallel.step.TPStep``; precrop
refuses first, in JAX's words. Checkpoints hold the gathered state (an
ordinary one-card checkpoint, which a TP resume slices), and validation
renders the weights gathered at the end of each epoch.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from ..datasets.sampling import reseed
from ..obs import (
    CompileTracker,
    ProfileWindow,
    annotate,
    get_emitter,
    get_tracer,
    init_run,
    sample_memory,
)
from ..resil import DivergenceError, PreemptionGuard, check_finite, report
from .checkpoint import (
    has_checkpoint,
    load_model,
    load_pretrain,
    save_model_with_retry,
    save_trained_config,
)
from .optim import capturable, make_optimizer, optimizer_step, set_lr
from .recorder import Recorder
from .step_core import sampled_grad_step


@dataclass
class TrainState:
    """What the JAX ``TrainState`` holds: the network (parameters), the
    optimizer (its moments) with its lr schedule, and the step count;
    ``epoch_it``: the steps of the current epoch already taken when a run
    stopped mid-epoch (a SIGTERM flush), 0 otherwise; ``tp``: under tensor
    parallelism the ``parallel.step.TPLayout`` (the optimizer then updates
    this rank's blocks; ``parallel.step.shard_train_state``)."""

    network: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: object
    step: int = 0
    epoch_it: int = 0
    tp: object = None


def make_train_state(cfg, network, device) -> TrainState:
    """Seeded init of ``network`` (``cfg.seed``), moved to ``device``, and
    its optimizer."""
    from ..models import init_params_for

    gen = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    init_params_for(cfg)(network, gen)
    network.to(device)
    optimizer, schedule = make_optimizer(cfg, network.parameters())
    return TrainState(network, optimizer, schedule, 0)


@contextmanager
def restored(state):
    """Leaves the parameters, the optimizer's state and an NGP state's grid
    as they were on entry (a captured step's warm-up runs a real step).
    State the optimizer makes inside (Adam's moments on a first step) is
    zeroed, which is how a first step finds it."""
    opt = state.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    saved = [p.detach().clone() for p in params]
    saved_opt = {p: {k: v.clone() for k, v in opt.state[p].items()
                     if torch.is_tensor(v)}
                 for p in params if p in opt.state}
    grid = getattr(state, "grid_ema", None)
    saved_grid = None if grid is None else grid.clone()
    try:
        yield
    finally:
        with torch.no_grad():
            for p, v in zip(params, saved):
                p.copy_(v)
            for p in params:
                old = saved_opt.get(p, {})
                for k, v in opt.state.get(p, {}).items():
                    if not torch.is_tensor(v):
                        continue
                    if k in old:
                        v.copy_(old[k])
                    else:
                        v.zero_()
            if grid is not None:
                state.grid_ema.copy_(saved_grid)


def capture_steps(trainer, state, entries: dict) -> bool:
    """Capture ``entries`` (name -> step function, all drawing from
    ``trainer._gen``) in ``trainer.aot`` with the state restored after their
    warm-ups. False when a step cannot be captured: a float lr, or a
    capture that failed, which can leave the shared generator in its
    capture state, so the registry is switched off and the caller takes a
    fresh generator for its eager steps."""
    if not capturable(state.optimizer):
        print("the optimizer is not capturable (a float lr): the steps run "
              "eagerly")
        trainer.aot.enabled = False
        return True
    for name, fn in entries.items():
        trainer.aot.register(name, fn, generators=(trainer._gen,))
    with restored(state):
        trainer.aot.compile_all()
    if trainer.aot.summary()["errors"]:
        trainer.aot.enabled = False
        return False
    return True


def agreed_stop(guard, mesh) -> bool:
    """Whether the run stops here: the SIGTERM flag, agreed by a MAX over
    the ranks (every rank must call this at the same boundary, or one of
    them would wait alone in the next all-reduce)."""
    if guard is None:
        return False
    if mesh is None:
        return bool(guard.triggered)
    from ..parallel.collectives import all_reduce_

    flag = torch.full((1,), float(guard.triggered), device=mesh.device)
    # graftlint: ok(host-sync: every rank agrees on the SIGTERM flag at each burst boundary; the mesh path only)
    return bool(all_reduce_(flag, mesh, "max").item())


class Trainer:
    def __init__(self, cfg, network, loss, evaluator=None, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
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
        # compile rows of the captures, the profiler window, and the SIGTERM
        # guard fit() installs (polled at burst boundaries)
        self.tracker = CompileTracker()
        self.profile = ProfileWindow.from_cfg(cfg)
        self.preempt: PreemptionGuard | None = None
        self._val_render = None
        self.aot = None  # compile.AOTRegistry, or None: eager steps
        # the step stream's generator and, on the card, the step count the
        # proposal anneal reads (batch["step"]), both filled before a step
        self._gen: torch.Generator | None = None
        self._step_t: torch.Tensor | None = None
        # the sharded step over a mesh (parallel/step.py)
        self._dp = None
        if mesh is not None:
            self._dp = self._build_sharded_step()

    def _uses_tp(self) -> bool:
        from ..parallel.mesh import MODEL_AXIS

        return self.mesh is not None and self.mesh.shape[MODEL_AXIS] > 1

    def _build_sharded_step(self):
        """One routing ladder for every mesh (JAX ``trainer.py:128``):
        ``model_axis > 1`` through the GSPMD step (``TPStep``), pure data
        parallelism through ``DPStep``."""
        from ..parallel.step import build_dp_step, build_gspmd_step

        if self._uses_tp():
            refuse_tp_precrop(self.cfg, self.mesh)
            return build_gspmd_step(self.mesh, self.loss, self.n_rays,
                                    self.near, self.far, seed=self.seed,
                                    k_steps=self.scan_steps,
                                    grad_accum=self.grad_accum)
        return build_dp_step(self.mesh, self.loss, self.n_rays, self.near,
                             self.far, seed=self.seed,
                             k_steps=self.scan_steps,
                             grad_accum=self.grad_accum)

    def epoch_iters(self, bank_size: int) -> int:
        """Steps per epoch; ep_iter=-1 means one pass over the bank."""
        if self.ep_iter > 0:
            return self.ep_iter
        return max(1, bank_size // self.n_rays)

    def _prepare(self, state: TrainState, device) -> None:
        """A step's host part: reseed the generator, fill the lr and the
        step count."""
        device = torch.device(device)
        if self._gen is None or self._gen.device != device:
            self._gen = torch.Generator(device=device)
            self._step_t = (torch.zeros((), dtype=torch.int64, device=device)
                            if device.type == "cuda" else None)
        reseed(self._gen, self.seed, state.step)
        set_lr(state.optimizer, state.schedule, state.step)
        if self._step_t is not None:
            self._step_t.fill_(state.step)

    def _step_body(self, state: TrainState, bank_rays, bank_rgbs,
                   index_pool=None) -> dict:
        """A step's device work (capturable): draw, render, backward, clip
        and update. ``batch["step"]`` is the step count on the card (a
        Python int on the CPU)."""
        stats = sampled_grad_step(
            self.loss, state.network.parameters(), bank_rays, bank_rgbs,
            self.n_rays, self.near, self.far, self._gen,
            index_pool=index_pool, grad_accum=self.grad_accum,
            step=state.step if self._step_t is None else self._step_t,
        )
        optimizer_step(state.optimizer)
        return stats

    @staticmethod
    def _entry_name(pool: bool) -> str:
        return "train_step_pool" if pool else "train_step"

    def step(self, state: TrainState, bank_rays, bank_rgbs, index_pool=None):
        """One optimization step: ``(state, stats)`` (stats stay tensors on
        the device; reading them is the caller's synchronisation). Replays
        the captured step when the registry has it; over a mesh, the
        data-parallel step. One process's step runs under a ``train.step``
        span (its host part: the seed, lr and step count, the replay's
        launch and the stats' copy; an eager step's launches)."""
        if self._dp is not None:
            stats = self._dp.one_step(state, bank_rays, bank_rgbs, index_pool)
            return state, stats
        with get_tracer().span("train.step", step=state.step):
            self._prepare(state, bank_rays.device)
            fn = (None if self.aot is None
                  else self.aot.take(self._entry_name(index_pool is not None)))
            if fn is not None:
                stats = {k: v.clone() for k, v in fn().items()}
            else:
                stats = self._step_body(state, bank_rays, bank_rgbs,
                                        index_pool)
        state.step += 1
        return state, stats

    def aot_register_steps(self, state: TrainState, bank,
                           pool=None) -> None:
        """Capture every step this run takes (JAX ``trainer.py:250``): the
        precrop pool's step while precrop steps remain, and the step. A
        burst replays the step K times (each step reseeds). Each entry's
        warm-up runs a real step on the side stream; the state is restored
        after it, so the run goes on from the state it had."""
        if self.aot is None or not self.aot.enabled:
            return
        if self._dp is not None:
            self._dp.aot_register(
                self.aot, state, bank,
                pool if state.step < self.precrop_iters else None)
            return
        self._prepare(state, bank[0].device)
        entries = {self._entry_name(False):
                   lambda: self._step_body(state, bank[0], bank[1])}
        if pool is not None and state.step < self.precrop_iters:
            entries[self._entry_name(True)] = lambda: self._step_body(
                state, bank[0], bank[1], pool)
        if not capture_steps(self, state, entries):
            self._gen = None

    def aot_register_val(self, test_dataset) -> None:
        """Capture the chunked render of one test view (every view has its
        ray count and bounds) in the steps' registry and pool
        (``Renderer.aot_register_eval``); :meth:`val` then replays it."""
        if self.aot is None or not self.aot.enabled or not len(test_dataset):
            return
        batch = test_dataset.image_batch(0)
        renderer = self.loss.renderer
        render = self._val_fn(test_dataset)
        if render.mesh is not None:
            from ..parallel.sequence import aot_register_sequence_renderer

            aot_register_sequence_renderer(self.aot, render.surface,
                                           batch["rays"].shape[0],
                                           width=batch["rays"].shape[1])
            return
        renderer.aot_register_eval(self.aot, batch["rays"].shape[0],
                                   batch["near"], batch["far"],
                                   width=batch["rays"].shape[1])
        self.aot.compile_all()
        renderer.aot_install(self.aot)

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

    # graftlint: hot
    def train_epoch(self, state: TrainState, epoch: int, bank,
                    recorder: Recorder, index_pool=None, log=print):
        """One epoch of steps, from ``state.epoch_it`` (a resumed mid-epoch
        flush) to ``epoch_iters``; each logged burst is a ``step`` row. A
        triggered SIGTERM guard stops it at the next burst boundary with
        ``state.epoch_it`` set to the steps taken."""
        bank_rays, bank_rgbs, pool = bank[0], bank[1], index_pool
        # the bank's global size (a rank holds 1/world of it)
        world = 1 if self.mesh is None else self.mesh.shape["data"]
        max_iter = self.epoch_iters(int(bank_rays.shape[0]) * world)
        end = time.time()
        log_interval = int(self.cfg.get("log_interval", 20))
        emitter = get_emitter()
        stats = None
        it, state.epoch_it = state.epoch_it, 0
        while it < max_iter:
            # the window opens BEFORE the burst that first overlaps it
            self.profile.tick(state.step)
            data_time = time.time() - end
            use_pool = pool is not None and state.step < self.precrop_iters
            t_dispatch = time.perf_counter()
            with annotate("train/step_dispatch"):
                if use_pool or self.scan_steps <= 1:
                    k = 1
                    state, stats = self.step(
                        state, bank_rays, bank_rgbs,
                        index_pool=pool if use_pool else None)
                else:
                    k = min(self.scan_steps, max_iter - it)
                    state, stats = self.multi_step(state, bank_rays,
                                                   bank_rgbs, k)
            dispatch_s = time.perf_counter() - t_dispatch
            # log when a burst crosses a log_interval boundary (k = 1: the
            # reference cadence)
            should_log = (
                it == 0
                or (it + k - 1) // log_interval > (it - 1) // log_interval
                or it + k >= max_iter
            )
            if should_log:
                # the stats read is the sync with the card: timed, so the
                # step row splits host dispatch from device wait
                t_block = time.perf_counter()
                stats_host = {kk: float(v) for kk, v in stats.items()}
                block_s = time.perf_counter() - t_block
                if self.finite_guard:
                    stats_host = check_finite(stats_host, state.step)
                recorder.update_loss_stats(stats_host)
            recorder.step = state.step
            recorder.batch_time.update((time.time() - end) / k)
            recorder.data_time.update(data_time)
            end = time.time()
            if should_log:
                lr = float(state.schedule(state.step))
                mem = _device_mem_mb(bank_rays.device)
                log(recorder.console_line(
                    epoch, min(it + k - 1, max_iter - 1), max_iter, lr, mem))
                recorder.record("train")
                # graftlint: ok(emit-hot: inside the should_log gate — one row per logging cadence, after the stats read)
                emitter.emit(
                    "step", step=state.step, epoch=epoch, k=k,
                    step_time_s=recorder.batch_time.median,
                    step_time_avg_s=recorder.batch_time.avg,
                    data_time_s=recorder.data_time.avg,
                    dispatch_s=dispatch_s / k, block_s=block_s / k, lr=lr,
                    max_mem_mb=mem, stats=stats_host)
            it += k
            if agreed_stop(self.preempt, self.mesh):
                state.epoch_it = it % max_iter
                break
        self.profile.tick(state.step)
        return state, stats

    def _val_fn(self, test_dataset):
        """The render gate of ``test_dataset``'s views (built once)."""
        if self._val_render is None or self._val_render[0] is not test_dataset:
            from ..renderer.gate import full_image_render_fn

            self._val_render = (
                test_dataset,
                full_image_render_fn(self.cfg, self.network,
                                     self.loss.renderer, test_dataset,
                                     use_grid=False),
            )
        return self._val_render[1]

    def val(self, state: TrainState, epoch: int, test_dataset,
            recorder: Recorder | None = None, max_images: int | None = None,
            log=print):
        """Render whole test images and run the evaluator on each (under
        the sequence-parallel gate every rank renders, the chief
        evaluates)."""
        from ..parallel.mesh import is_chief

        render = self._val_fn(test_dataset)
        evaluator = self.evaluator if is_chief() else None
        device = next(state.network.parameters()).device
        n = len(test_dataset)
        if max_images is not None:
            n = min(n, max_images)
        with annotate("train/validation"):
            for i in range(n):
                batch = test_dataset.image_batch(i)
                out = render({
                    "rays": torch.from_numpy(batch["rays"]).to(device),
                    "near": float(batch["near"]),
                    "far": float(batch["far"]),
                })
                if evaluator is not None:
                    evaluator.evaluate(
                        {k: v.cpu().numpy() for k, v in out.items()}, batch)
        result = {}
        if evaluator is not None:
            result = evaluator.summarize()
            if recorder is not None and result:
                recorder.record("val", step=epoch, stats=result)
            if result:
                log(f"val epoch {epoch}: " + "  ".join(
                    f"{k}: {v:.4f}" for k, v in result.items()
                ))
        # one sample row per validation pass: the fine-MLP evaluations a
        # ray costs beside the quality they bought
        renderer = getattr(self.loss, "renderer", None)
        if renderer is not None and hasattr(renderer, "sampling_stats"):
            ss = renderer.sampling_stats()
            row = {"mode": ss["mode"],
                   "fine_evals_per_ray": ss["fine_evals_per_ray_eval"],
                   "n_proposal": ss["n_proposal"], "n_fine": ss["n_fine"],
                   "surface": "val", "step": int(state.step)}
            if "psnr" in result:
                row["psnr"] = float(result["psnr"])
            get_emitter().emit("sample", **row)
        return result


def _device_mem_mb(device) -> float | None:
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**20


def validates(begin_epoch: int, epochs: int, eval_ep: int) -> bool:
    """Whether an epoch loop from ``begin_epoch`` to ``epochs`` runs a
    validation (the fit loops capture the eval render only then)."""
    return any((e + 1) % eval_ep == 0 for e in range(begin_epoch, epochs))


def refuse_tp_precrop(cfg, mesh) -> None:
    """Precrop warm-up over a tensor-parallel mesh raises, in JAX's words
    (``trainer.py:140``), before the data loads."""
    if (mesh is not None and mesh.model > 1
            and int(cfg.task_arg.get("precrop_iters", 0)) > 0):
        raise NotImplementedError(
            "precrop warm-up is not supported with "
            "parallel.model_axis > 1 — set task_arg.precrop_iters 0 "
            "or train pure-DP"
        )


def setup_mesh(cfg, device, log=print):
    """The run's process group and mesh: ``(mesh or None, this rank's
    device)``. Starts the group when a launcher asked for one
    (``parallel.multihost_init``); one process trains on one card; over
    ranks the ``(data, model)`` mesh ``cfg.parallel`` asks for
    (``make_mesh_from_cfg``)."""
    from ..parallel.mesh import make_mesh_from_cfg, multihost_init, \
        rank_device
    from ..utils.platform import resolve_device

    multihost_init(cfg, device)
    dev = resolve_device(rank_device(device))
    mesh = make_mesh_from_cfg(cfg, device=dev)
    if mesh is not None:
        log(f"training over mesh {mesh.shape} ({mesh.backend}), rank "
            f"{mesh.rank} on {dev}")
    return mesh, dev


def sync_state(state, mesh, grid=None) -> None:
    """Rank 0's parameters, optimizer moments and step counts (and an NGP
    state's grid EMA) on every rank, in place (after init, resume or a
    ``pretrain`` warm start). A tensor-parallel state broadcasts each block
    and its moments within its data group (the ranks of its model index)
    from data index 0, then gathers the full weights."""
    if mesh is None:
        return
    from ..parallel.collectives import broadcast_from_chief

    if getattr(state, "tp", None) is not None:
        state.tp.broadcast_blocks(state.optimizer)
        state.tp.gather(all_leaves=True)
        state.step, state.epoch_it = broadcast_from_chief(
            (int(state.step), int(state.epoch_it)), mesh)
        return

    opt = state.optimizer
    tensors = [p.data for g in opt.param_groups for p in g["params"]]
    for g in opt.param_groups:
        for p in g["params"]:
            st = opt.state.get(p, {})
            tensors += [st[k] for k in sorted(st) if torch.is_tensor(st[k])]
    if grid is not None:
        tensors.append(grid)
    for t in tensors:
        broadcast_from_chief(t, mesh)
    state.step, state.epoch_it = broadcast_from_chief(
        (int(state.step), int(state.epoch_it)), mesh)


def chief_save(cfg, state, epoch: int, recorder, mesh, log=print,
               **kw) -> None:
    """``save_model_with_retry`` on the chief, then a barrier: no rank reads
    a partial file. A tensor-parallel state is gathered first (every rank
    takes part), so the chief writes an ordinary one-card checkpoint."""
    from ..parallel.collectives import barrier
    from ..parallel.mesh import is_chief

    if getattr(state, "tp", None) is not None:
        state = state.tp.full_state(state)

    if is_chief():
        save_model_with_retry(cfg, cfg.trained_model_dir, state, epoch,
                              recorder.state_dict(), log=log, **kw)
    barrier(mesh, "post_save")


def shard_inputs(cfg, train_ds, mesh, dev, precrop: bool):
    """``(bank, pool)`` on ``dev``: the whole ray bank (and precrop pool) on
    one card; over a mesh this rank's slice of the bank permuted globally
    with the seed (each slice a uniform sample of the scene) and its pool
    segment rebased to the slice (JAX ``trainer.py:558-587``)."""
    frac = float(cfg.task_arg.get("precrop_frac", 0.5))
    rays, rgbs = train_ds.ray_bank()
    pool = np.asarray(train_ds.precrop_index_pool(frac)) if precrop else None
    if mesh is not None:
        from ..parallel.sharding import shard_bank, shard_index_pool

        perm = np.random.default_rng(int(cfg.get("seed", 0))).permutation(
            rays.shape[0])
        n_data = mesh.shape["data"]
        n_bank = (rays.shape[0] // n_data) * n_data
        rays, rgbs = shard_bank(rays[perm], rgbs[perm], mesh)
        if pool is not None:
            inv = np.empty_like(perm)
            inv[perm] = np.arange(perm.size)
            moved = inv[pool]
            pool = shard_index_pool(moved[moved < n_bank], n_bank, mesh)
    bank = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (rays, rgbs))
    if pool is not None:
        pool = torch.from_numpy(pool).to(dev)
    return bank, pool


def fit(cfg, network=None, log=print, device="cuda"):
    """Full training entry: build everything from cfg, resume if a
    checkpoint is there (or warm-start from ``pretrain``), run the epoch
    loop with the save/eval cadence on one card (``device``), with
    telemetry, the profiler window, the divergence rollback and the
    SIGTERM flush; over a mesh of ranks when a launcher started several
    (module docstring). Returns the final :class:`TrainState`."""
    from ..compile import registry_from_cfg
    from ..datasets import make_dataset
    from ..evaluators import make_evaluator
    from ..parallel.mesh import is_chief
    from ..registry import load_attr
    from ..utils.setup import configure_runtime
    from .recorder import make_recorder

    if bool(cfg.task_arg.get("ngp_training", False)):
        # occupancy-accelerated training has its own state (the live grid
        # EMA) and march; same entry contract, its own epoch loop
        from .ngp import fit_ngp

        return fit_ngp(cfg, network=network, log=log, device=device)
    mesh, dev = setup_mesh(cfg, device, log)
    refuse_tp_precrop(cfg, mesh)
    configure_runtime(cfg)

    if network is None:
        from ..models import make_network

        network = make_network(cfg)
    loss_factory = load_attr(cfg.loss_module, "make_loss", "NetworkWrapper")
    loss = loss_factory(cfg, network)
    evaluator = None if cfg.get("skip_eval", False) else make_evaluator(cfg)

    trainer = Trainer(cfg, network, loss, evaluator, mesh=mesh)
    recorder = make_recorder(cfg)
    # telemetry opens AFTER the recorder (a fresh run wipes record_dir)
    emitter = init_run(cfg, component="train")
    state = make_train_state(cfg, network, dev)
    if trainer._uses_tp():
        from ..parallel.step import shard_train_state

        state = shard_train_state(state, mesh, column=not bool(
            cfg.network.nerf.get("fused_trunk", False)))

    begin_epoch = 0
    if cfg.get("resume", True):
        state, begin_epoch, rec_state = load_model(cfg.trained_model_dir,
                                                   state)
        if rec_state:
            recorder.load_state_dict(rec_state)
    if begin_epoch == 0 and state.epoch_it == 0 and cfg.get("pretrain", ""):
        load_pretrain(str(cfg.pretrain), state.network)
        if state.tp is not None:
            state.tp.pull_blocks()
    sync_state(state, mesh)
    if is_chief():
        save_trained_config(cfg)

    train_ds = make_dataset(cfg, "train")
    bank, pool = shard_inputs(cfg, train_ds, mesh, dev,
                              trainer.precrop_iters > 0)
    # CUDA graphs: every step of this run and the validation render
    # captured before the loop (compile.aot; a disabled registry on the CPU)
    trainer.aot = registry_from_cfg(cfg, dev, tracker=trainer.tracker)
    trainer.aot_register_steps(state, bank, pool=pool)
    test_ds = make_dataset(cfg, "test")
    epochs = int(cfg.train.epoch)
    save_ep = int(cfg.get("save_ep", 40))
    save_latest_ep = int(cfg.get("save_latest_ep", 10))
    eval_ep = int(cfg.get("eval_ep", 10))
    # validation: the chief alone, or every rank through the sharded gate
    sharded_val = mesh is not None and bool(
        cfg.get("eval", {}).get("sharded", False))
    if not (is_chief() or sharded_val):
        evaluator = None
    if evaluator is not None and validates(begin_epoch, epochs, eval_ep):
        trainer.aot_register_val(test_ds)
    if trainer.aot is not None and trainer.aot.names():
        log("compile: " + json.dumps(trainer.aot.status()))

    rcfg = cfg.get("resil", {})
    max_rollbacks = int(rcfg.get("max_rollbacks", 2))
    guard = (PreemptionGuard.install()
             if bool(rcfg.get("preempt_sigterm", True)) else None)
    trainer.preempt = guard
    rollbacks = 0
    t_fit_start = time.time()
    try:
        epoch = begin_epoch
        while epoch < epochs:
            recorder.epoch = epoch
            t_epoch = time.time()
            step_before = state.step
            try:
                state, _ = trainer.train_epoch(state, epoch, bank, recorder,
                                               index_pool=pool, log=log)
            except DivergenceError as err:
                # every rank read the same reduced stats: all roll back
                epoch = _roll_back(cfg, state, recorder, err, rollbacks,
                                   max_rollbacks, log)
                rollbacks += 1
                continue
            if state.epoch_it:
                # SIGTERM mid-epoch: flush what this epoch has taken
                _flush_preempted(cfg, state, epoch, recorder, log,
                                 mesh=mesh)
                break
            _epoch_rows(emitter, epoch, state.step, state.step - step_before,
                        time.time() - t_epoch, time.time() - t_fit_start)
            if state.tp is not None:
                # validation renders the gathered weights (every rank)
                state.tp.gather(all_leaves=True)
            for latest, every in ((False, save_ep), (True, save_latest_ep)):
                if (epoch + 1) % every == 0:
                    chief_save(cfg, state, epoch, recorder, mesh, log=log,
                               latest=latest)
            if (epoch + 1) % eval_ep == 0 and evaluator is not None:
                trainer.val(state, epoch, test_ds, recorder, log=log)
            if agreed_stop(guard, mesh):
                # SIGTERM at the epoch's end: one latest flush, then stop
                chief_save(cfg, state, epoch, recorder, mesh, log=log,
                           latest=True)
                log("SIGTERM: latest checkpoint flushed; exiting")
                break
            epoch += 1
    finally:
        if guard is not None:
            guard.uninstall()
        # a window still open at exit must be closed to write its trace
        trainer.profile.stop()
        emitter.close()
    return state


def _roll_back(cfg, state, recorder, err, rollbacks: int,
               max_rollbacks: int, log) -> int:
    """Answer a :class:`DivergenceError`: restore the last checkpoint into
    ``state`` in place (the tensors the captured steps read) and return
    the epoch to go on from; re-raise when the budget is spent or there is
    no checkpoint."""
    if rollbacks >= max_rollbacks or not has_checkpoint(
            cfg.trained_model_dir):
        raise err
    report("train.loss", "rollback", step=err.step,
           detail=f"rollback {rollbacks + 1}/{max_rollbacks}")
    log(f"non-finite loss at step {err.step}: rolling back to the last "
        f"good checkpoint ({rollbacks + 1}/{max_rollbacks})")
    _, epoch, rec_state = load_model(cfg.trained_model_dir, state)
    if rec_state:
        recorder.load_state_dict(rec_state)
    return epoch


def _flush_preempted(cfg, state, epoch: int, recorder, log,
                     phase_state=None, mesh=None) -> None:
    """The SIGTERM flush in the middle of ``epoch``: ``latest.pt`` with the
    last whole epoch (``epoch - 1``) and the steps of this one taken (by
    the chief)."""
    chief_save(cfg, state, epoch - 1, recorder, mesh, log=log, latest=True,
               epoch_it=state.epoch_it, phase_state=phase_state)
    log("SIGTERM: latest checkpoint flushed; exiting")


def _epoch_rows(emitter, epoch: int, step: int, steps: int, wall_s: float,
                since_start_s: float) -> None:
    """The epoch cadence's rows: throughput, memory, liveness."""
    emitter.emit("epoch", epoch=epoch, steps=steps, wall_s=wall_s,
                 steps_per_sec=steps / max(wall_s, 1e-9))
    sample_memory(step=step, epoch=epoch)
    emitter.emit("heartbeat", wall_s=since_start_s, step=step, epoch=epoch)
