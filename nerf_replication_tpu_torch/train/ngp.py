"""Occupancy-accelerated training with a live grid (port of
``nerf_replication_tpu/train/ngp.py``): the instant-ngp trainer of the
hash-grid configurations, ``task_arg.ngp_training: true``.

The density grid EMA ([R, R, R] float32) is training state. Each step
renders a ray batch through the ``fine`` network, backpropagates, takes an
optimizer step, then refreshes the grid: decay, a scatter-max of the sigmas
the step sampled (subsampled to ``ngp_sample_update_cap``) and of the live
network probed at a jittered point in ``R³/ngp_grid_update_every`` random
cells. ``scatter_reduce_(..., "amax")`` is order-independent, so the update
is deterministic on the card too.

Two phases, switched on the host between bursts (:meth:`NGPTrainer.
multi_step`): the warm phase renders plain stratified samples
(``ngp_warmup_samples``, no march) while the grid carves; the march phase
renders through the occupancy march with the live grid — the per-ray
``march_rays_accelerated`` or, under ``ngp_packed_march``, the packed
``march_rays_packed``. Three behaviours the JAX package's records were won
by are kept: truncated rays are masked out of the march loss
(:meth:`march_loss`); warmup ends at the LATER of ``ngp_warmup_steps`` and
occupancy < ``ngp_warmup_exit_occ`` and re-engages while the grid is dense,
within a cumulative ``ngp_warmup_max``; the density threshold follows
``occupancy_grid_threshold`` (σ = 1.0), not 0.01.

The hash encoder runs through kernels K6 (forward) and K6b (backward) on
the card; the MLP is the plain ``Network`` (the fused trunk refuses a
learnable encoder). Randomness: one generator, reseeded from (seed, step)
before every step, drawn in the order ray batch, warm depths, refresh
cells, jitter.

The ops layers run as in :func:`trainer.fit`: telemetry rows (``step``
with the dispatch/block split, ``epoch``, ``memory``, ``heartbeat``,
``eval``, a ``compile`` row per capture and per eval-cap change, and a
``march`` row per packed eval view), the ``train.profile`` window, the
divergence rollback (the grid EMA and the phase counters restored too),
the SIGTERM flush with the phase sidecar, and ``pretrain`` warm starts.

Over a mesh (``parallel/``, started by :func:`fit_ngp` under torchrun) each
rank draws ``N_rays / world`` rays from its slice of the globally permuted
bank on its own stream (``step_seed(seed, step, rank)``); the step is two
captured segments around the eager collectives: (1) draw, render, backward,
gradients and stats packed into one buffer; an ``all_reduce(SUM)`` and a
division by the world size; (2) unpack, clip + Adam, the grid update from
this rank's samples and its own refresh cells and jitter; then an
``all_reduce(MAX)`` of the grid EMA. All candidates start from the same
replicated decayed grid, so the MAX is exactly the union of the ranks'
scatter-max updates, and the grids stay bitwise replicated (JAX's
``pmax``). The warm/march switch reads the replicated grid's occupancy.
Under
``compile.aot`` (the JAX package's AOT registry) :func:`fit_ngp` captures
both phase variants of the step as CUDA graphs before the loop
(:meth:`NGPTrainer.aot_register_steps`); each step then reseeds the
generator, fills the lr and replays. It also captures the eval render of
one test image at the eval stream cap (:meth:`NGPTrainer.
aot_register_render`): each view copies its rays and the live grid into the
graph and replays it; a cap that grows (derived from the carved grid, or
doubled on an overflow) captures its own entry once. The ``gather`` eval
route stays eager (its ``nonzero`` compaction).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..datasets.sampling import reseed, sample_rays
from ..renderer.accelerated import (
    MarchOptions,
    march_points,
    march_rays_accelerated,
)
from ..renderer.occupancy import world_to_voxel
from ..renderer.volume import (
    chunk_layout,
    eval_entry,
    map_chunks,
    raw2outputs,
    replay_padded,
    stratified_z_vals,
)
from ..utils.numerics import norm3_rn
from .loss import mse, mse_to_psnr
from .optim import make_optimizer, optimizer_step, set_lr
from ..obs import CompileTracker, ProfileWindow, annotate, get_emitter
from .trainer import (
    _device_mem_mb,
    _epoch_rows,
    _flush_preempted,
    _roll_back,
    agreed_stop,
    capture_steps,
    chief_save,
    setup_mesh,
    shard_inputs,
    sync_state,
    validates,
)


@dataclass
class NGPState:
    """The trainer's state: network (parameters, table included),
    optimizer with its schedule, the step count and the live grid EMA;
    ``epoch_it`` as in ``trainer.TrainState``."""

    network: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: object
    step: int
    grid_ema: torch.Tensor
    epoch_it: int = 0


class NGPTrainer:
    """Occupancy-accelerated trainer on one card, or on each rank of
    ``mesh``."""

    def __init__(self, cfg, network, mesh=None):
        ta = cfg.task_arg
        self.cfg = cfg
        self.network = network
        self.mesh = mesh
        self.seed = int(cfg.get("seed", 0))
        self.n_rays = int(ta.get("N_rays", 1024))
        # the rays a step draws here: the global batch over the ranks
        self.n_local = self.n_rays
        if mesh is not None:
            from ..parallel.step import FlatGrads, local_batch

            self.n_local = local_batch(self.n_rays, mesh, "N_rays")
            # per phase: gradients + stats and the samples the grid takes
            self._flats = {True: FlatGrads(), False: FlatGrads()}
            self._carry: dict = {True: {}, False: {}}
        self.near = float(ta.near)
        self.far = float(ta.far)
        self.bbox_np = np.asarray(cfg.train_dataset.scene_bbox, np.float32)
        self.march = MarchOptions.from_cfg(cfg)
        # eval renders pay their march once per image: their own budget
        self.eval_march = MarchOptions.eval_from_cfg(cfg)
        self.packed_march = bool(ta.get("ngp_packed_march", False))
        self.packed_cap_avg = int(ta.get("ngp_packed_cap_avg", 32))
        self.packed_cap_avg_eval = int(ta.get(
            "ngp_packed_cap_avg_eval", max(1024, 4 * self.packed_cap_avg)))
        self._eval_cap_user_preset = "ngp_packed_cap_avg_eval" in ta
        self._eval_cap_derived = False
        self.grid_res = int(ta.get("ngp_grid_res", 64))
        # the density threshold follows the eval bake's convention
        # (occupancy_grid_threshold, σ = 1.0 in the lego family) unless
        # pinned: at σ = 0.01 a trained network still reads ~98% occupied
        # and the grid never carves
        thr_cfg = ta.get("ngp_density_threshold", None)
        self.threshold = float(ta.get("occupancy_grid_threshold", 1.0)
                               if thr_cfg is None else thr_cfg)
        update_every = int(ta.get("ngp_grid_update_every", 16))
        decay_window = float(ta.get("ngp_grid_decay", 0.95))
        # continuous equivalent of "×decay every `update_every` steps"
        self.decay_step = float(decay_window ** (1.0 / update_every))
        self.cells_per_step = max(self.grid_res**3 // update_every, 1)
        self.warm_factor = float(ta.get("ngp_grid_warm_factor", 2.0))
        self.sample_update_cap = int(ta.get("ngp_sample_update_cap", 65536))
        self.warm_samples = int(ta.get("ngp_warmup_samples", 128))
        self.scan_steps = max(1, int(ta.get("scan_steps", 1)))
        self.warmup_steps = int(ta.get("ngp_warmup_steps", 500))
        self.warmup_exit_occ = float(ta.get("ngp_warmup_exit_occ", 0.6))
        self.warmup_max = int(ta.get("ngp_warmup_max", 8 * self.warmup_steps))
        self.occ_resync_bursts = int(ta.get("ngp_occ_resync_bursts", 32))
        self.trunc_warn_frac = float(ta.get("ngp_trunc_warn_frac", 0.25))
        self._host_step: int | None = None
        self._last_occ: float = 1.0
        self._bursts: int = 0
        self._warm_steps_total: int = 0
        self._trunc_warned: bool = False
        self.last_burst_steps = 0
        self.last_burst_warm = False
        self._bbox_on: dict = {}
        # the step stream's generator, reseeded before every step; the
        # captured steps draw from it (registry.py)
        self._gen: torch.Generator | None = None
        self.aot = None  # compile.AOTRegistry, or None: eager steps
        self.tracker = CompileTracker()
        self.profile = ProfileWindow.from_cfg(cfg)
        self._eval_cap_escalations = 0
        # captured eval renders per (n_chunks, chunk, eval cap); None: a
        # capture that failed (that render stays eager)
        self._render_fns: dict = {}

    # -- state ---------------------------------------------------------------
    def _bbox(self, device) -> torch.Tensor:
        """The scene bbox on ``device``, copied there once (a captured
        step reads the copy; it cannot make one)."""
        device = torch.device(device)
        if device not in self._bbox_on:
            self._bbox_on[device] = torch.from_numpy(self.bbox_np).to(device)
        return self._bbox_on[device]

    def init_grid(self, device) -> torch.Tensor:
        """Grid EMA warm-started at ``warm_factor × threshold`` (fully
        occupied): the first steps have gradients everywhere, then decay and
        the live updates carve out empty space."""
        return torch.full((self.grid_res,) * 3,
                          self.warm_factor * self.threshold,
                          dtype=torch.float32, device=device)

    def make_state(self, device) -> NGPState:
        """Seeded init of the network (``cfg.seed``) on ``device``, its
        optimizer and the warm grid."""
        from ..models import init_params_for

        gen = torch.Generator().manual_seed(self.seed)
        init_params_for(self.cfg)(self.network, gen)
        self.network.to(device)
        optimizer, schedule = make_optimizer(self.cfg,
                                             self.network.parameters())
        return NGPState(self.network, optimizer, schedule, 0,
                        self.init_grid(device))

    # -- warm/carve phase persistence ---------------------------------------
    def phase_state(self) -> dict:
        """Host-side phase counters for the checkpoint sidecar: what a
        resumed trainer needs to re-enter the exact phase."""
        if self._host_step is None:
            return {}
        return {
            "host_step": int(self._host_step),
            "last_occ": float(self._last_occ),
            "warm_steps_total": int(self._warm_steps_total),
            "bursts": int(self._bursts),
            "trunc_warned": bool(self._trunc_warned),
        }

    def restore_phase(self, phase: dict | None,
                      expect_step: int | None = None) -> bool:
        """Adopt persisted phase counters; False (→ the occupancy estimate
        in :meth:`multi_step`) on a missing sidecar or one whose step is
        not the restored bundle's."""
        if not phase or "warm_steps_total" not in phase:
            return False
        if expect_step is not None and int(phase.get("host_step", -1)) != int(
                expect_step):
            return False
        self._host_step = int(phase["host_step"])
        self._last_occ = float(phase.get("last_occ", 1.0))
        self._warm_steps_total = int(phase["warm_steps_total"])
        self._bursts = int(phase.get("bursts", 0))
        self._trunc_warned = bool(phase.get("trunc_warned", False))
        return True

    def maybe_derive_eval_cap(self, grid: torch.Tensor) -> bool:
        """Size the packed eval stream cap from the live grid's occupancy,
        once, on the first carved grid: ``occ × max_samples × 1.5`` rounded
        up to a multiple of 64. No-op when pinned by the user, when the
        march is not packed, or after the first derivation."""
        if (not self.packed_march or self._eval_cap_user_preset
                or self._eval_cap_derived):
            return False
        occ = float(grid.float().mean())
        if occ <= 0.0 or occ >= self.warmup_exit_occ:
            return False
        raw = occ * self.eval_march.max_samples * 1.5
        cap = max(64, -(-int(np.ceil(raw)) // 64) * 64)
        self._eval_cap_derived = True
        if cap == self.packed_cap_avg_eval:
            return False
        cap_old, self.packed_cap_avg_eval = self.packed_cap_avg_eval, cap
        get_emitter().emit("compile", name="ngp_render_eval_cap_derived",
                           n_compiles=0, wall_s=0.0, cap_old=cap_old,
                           cap_new=cap)
        print(f"ngp eval cap: occupancy {occ:.1%} x "
              f"{self.eval_march.max_samples} max_samples x 1.5 headroom "
              f"-> packed_cap_avg_eval {cap} (was {cap_old})")
        return True

    # -- the step pieces -----------------------------------------------------
    def _apply_fn(self):
        network = self.network
        return lambda pts, dirs, model: network(pts, dirs, model=model)

    def march_loss(self, rays, rgbs, grid):
        """March-phase loss: ``(loss, out, stats)``. Truncated rays (out of
        budget while still transparent) are masked out: supervising their
        near content against the full ground truth corrupts the field."""
        bbox = self._bbox(rays.device)
        if self.packed_march:
            from ..renderer.packed_march import march_rays_packed

            out = march_rays_packed(self._apply_fn(), rays, self.near,
                                    self.far, grid, bbox, self.march,
                                    cap_avg=self.packed_cap_avg,
                                    return_samples=True)
        else:
            out = march_rays_accelerated(self._apply_fn(), rays, self.near,
                                         self.far, grid, bbox, self.march,
                                         return_samples=True)
        w = 1.0 - out["truncated"].to(torch.float32)
        per_ray = torch.mean((out["rgb_map_f"] - rgbs) ** 2, -1)
        loss = torch.sum(per_ray * w) / torch.clamp_min(torch.sum(w), 1.0)
        stats = {
            "loss": loss.detach(),
            "psnr": mse_to_psnr(loss.detach()),
            "occupancy": grid.to(torch.float32).mean(),
            "truncated_frac": out["truncated"].to(torch.float32).mean(),
        }
        if self.packed_march:
            stats["overflow_frac"] = out["overflow_frac"]
            stats["march_coarse_occ"] = out["march_coarse_occ"]
        return loss, out, stats

    def warm_loss(self, rays, rgbs, z, grid):
        """Warm-phase loss: plain stratified volume rendering of the fine
        network at depths ``z [N, S]`` (no march); its sample densities
        still carve the grid (out-of-bbox samples masked)."""
        bbox = self._bbox(rays.device)
        rays_o, rays_d = rays[..., 0:3], rays[..., 3:6]
        # o + d·z as one fused multiply-add, as XLA evaluates it in the
        # jitted JAX step
        pts = march_points(rays_o, rays_d, z)
        viewdirs = rays_d / norm3_rn(rays_d, keepdim=True)
        raw = self.network(pts, viewdirs, model="fine")
        rgb_map, _, _, _ = raw2outputs(raw, z, rays_d,
                                       white_bkgd=self.march.white_bkgd)
        loss = mse(rgb_map, rgbs)
        res = self.grid_res
        vox = world_to_voxel(pts, bbox, res)
        flat = (vox[..., 0] * res + vox[..., 1]) * res + vox[..., 2]
        in_bbox = torch.all((pts >= bbox[0]) & (pts <= bbox[1]), -1)
        out = {"sample_flat": flat.to(torch.int32),
               "sample_sigma": torch.relu(raw[..., 3]).detach(),
               "sample_valid": in_bbox.to(torch.float32)}
        stats = {"loss": loss.detach(), "psnr": mse_to_psnr(loss.detach()),
                 "occupancy": grid.to(torch.float32).mean(),
                 "truncated_frac": torch.zeros((), device=rays.device)}
        return loss, out, stats

    @torch.no_grad()
    def grid_update(self, grid_ema, out, idx, u) -> torch.Tensor:
        """The new grid EMA: decay, the scatter-max of the step's sampled
        sigmas (strided down to ``ngp_sample_update_cap`` rows), then the
        exploration refresh of cells ``idx [n]`` probed with the live fine
        network at the jittered points ``lo + (cell + u)/R·(hi − lo)``
        (``u [n, 3]`` in [0, 1))."""
        res = self.grid_res
        ema = grid_ema.reshape(-1) * self.decay_step
        s_flat = out["sample_flat"].reshape(-1).to(torch.int64)
        s_sigma = (out["sample_sigma"] * out["sample_valid"]).reshape(-1)
        stride = max(1, int(np.ceil(s_flat.shape[0] / self.sample_update_cap)))
        if stride > 1:
            s_flat, s_sigma = s_flat[::stride], s_sigma[::stride]
        ema.scatter_reduce_(0, s_flat, s_sigma.to(torch.float32), "amax")
        iz = idx % res
        iy = (idx // res) % res
        ix = idx // (res * res)
        cell = torch.stack([ix, iy, iz], -1).to(torch.float32)
        bbox = self._bbox(grid_ema.device)
        pts = bbox[0] + (cell + u) / res * (bbox[1] - bbox[0])
        dirs = torch.zeros_like(pts)
        raw = self.network(pts[:, None, :], dirs, model="fine")
        sigma = torch.relu(raw[:, 0, 3]).to(torch.float32)
        ema.scatter_reduce_(0, idx.to(torch.int64), sigma, "amax")
        return ema.reshape(res, res, res)

    def _generator(self, device) -> torch.Generator:
        device = torch.device(device)
        if self._gen is None or self._gen.device != device:
            self._gen = torch.Generator(device=device)
        return self._gen

    def _step_body(self, state: NGPState, bank_rays, bank_rgbs, warm: bool,
                   mark=None) -> dict:
        """One step's device work (capturable: no host read, no host copy,
        static shapes): draw, render + loss, backward, clip + Adam, grid
        update in place. ``mark(i)``, when given, is called at the
        boundaries of its four parts (render + loss, backward, optimizer,
        grid update): the profiler's hook."""
        mark = mark or (lambda i: None)
        stats, out = self._grad_part(state, bank_rays, bank_rgbs, warm, mark)
        optimizer_step(state.optimizer)
        mark(3)
        self._grid_part(state, out)
        mark(4)
        return stats

    def _grad_part(self, state: NGPState, bank_rays, bank_rgbs, warm: bool,
                   mark) -> tuple[dict, dict]:
        """Draw ``n_local`` rays, render + loss, backward: ``(stats, the
        march's samples)``."""
        dev = bank_rays.device
        gen = self._gen
        mark(0)
        rays, rgbs = sample_rays(gen, bank_rays, bank_rgbs, self.n_local)
        grid = state.grid_ema > self.threshold
        for p in state.network.parameters():
            p.grad = None
        if warm:
            z = stratified_z_vals(gen, self.near, self.far, self.n_local,
                                  self.warm_samples, 1.0, device=dev)
            loss, out, stats = self.warm_loss(rays, rgbs, z, grid)
        else:
            loss, out, stats = self.march_loss(rays, rgbs, grid)
        mark(1)
        loss.backward()
        mark(2)
        return stats, out

    def _grid_part(self, state: NGPState, out: dict) -> None:
        """The refresh cells and jitter drawn after the update, and the grid
        update in place (a captured step reads and writes the grid where it
        lies)."""
        dev = state.grid_ema.device
        idx = torch.randint(0, self.grid_res**3, (self.cells_per_step,),
                            generator=self._gen, device=dev)
        u = torch.rand((self.cells_per_step, 3), generator=self._gen,
                       dtype=torch.float32, device=dev)
        state.grid_ema.copy_(self.grid_update(state.grid_ema, out, idx, u))

    # -- the data-parallel step's segments (parallel/step.py) --------------
    _SAMPLES = ("sample_flat", "sample_sigma", "sample_valid")

    def _dp_grad(self, state: NGPState, bank_rays, bank_rgbs,
                 warm: bool) -> None:
        """Segment 1 (capturable): gradients and stats into the phase's flat
        buffer, the samples into buffers of their own (made on the first,
        eager call)."""
        stats, out = self._grad_part(state, bank_rays, bank_rgbs, warm,
                                     lambda i: None)
        self._flats[warm].pack(state.network.parameters(), stats)
        carry = self._carry[warm]
        for k in self._SAMPLES:
            if k not in carry:
                carry[k] = torch.empty_like(out[k])
            carry[k].copy_(out[k])

    def _dp_update(self, state: NGPState, warm: bool) -> None:
        """Segment 2 (capturable): the reduced gradients, clip + Adam, this
        rank's grid candidate in ``state.grid_ema``."""
        self._flats[warm].unpack_grads()
        optimizer_step(state.optimizer)
        self._grid_part(state, self._carry[warm])

    def _dp_step(self, state: NGPState, bank_rays, bank_rgbs,
                 warm: bool) -> dict:
        from ..parallel.collectives import all_reduce_

        phase = "warm" if warm else "march"
        fn = (None if self.aot is None
              else self.aot.take(f"ngp_dp_grad_{phase}"))
        if fn is not None:
            fn()
        else:
            self._dp_grad(state, bank_rays, bank_rgbs, warm)
        self._flats[warm].reduce(self.mesh)
        fn = (None if self.aot is None
              else self.aot.take(f"ngp_dp_update_{phase}"))
        if fn is not None:
            fn()
        else:
            self._dp_update(state, warm)
        all_reduce_(state.grid_ema, self.mesh, "max")
        return self._flats[warm].stats()

    def _one_step(self, state: NGPState, bank_rays, bank_rgbs, warm: bool,
                  mark=None) -> dict:
        """One optimizer step and grid update: the host's part (the step's
        generator seed, the lr), then the captured step's replay when the
        registry has it, else :meth:`_step_body` eagerly."""
        reseed(self._generator(bank_rays.device), self.seed, state.step,
               0 if self.mesh is None else self.mesh.rank)
        set_lr(state.optimizer, state.schedule, state.step)
        if self.mesh is not None:
            stats = self._dp_step(state, bank_rays, bank_rgbs, warm)
            state.step += 1
            return stats
        fn = None
        if self.aot is not None and mark is None:
            fn = self.aot.take(self._entry_name(warm))
        if fn is not None:
            stats = {k: v.clone() for k, v in fn().items()}
        else:
            stats = self._step_body(state, bank_rays, bank_rgbs, warm, mark)
        state.step += 1
        return stats

    @staticmethod
    def _entry_name(warm: bool) -> str:
        return f"ngp_step_{'warm' if warm else 'march'}"

    def aot_register_steps(self, state: NGPState, bank) -> None:
        """Capture both phase variants of the step (JAX ``ngp.py:256``):
        warm and march (per-ray or packed, as ``ngp_packed_march`` asks).
        Each entry's warm-up runs a real step on the side stream; the
        parameters, Adam's moments and the grid are restored after, so the
        run goes on from the state it had."""
        if self.aot is None or not self.aot.enabled:
            return
        reseed(self._generator(bank[0].device), self.seed, state.step,
               0 if self.mesh is None else self.mesh.rank)
        set_lr(state.optimizer, state.schedule, state.step)
        if self.mesh is not None:
            # each phase's two segments, segment 1 first (it makes the
            # buffers segment 2 reads)
            entries = {}
            for w in (True, False):
                phase = "warm" if w else "march"
                entries[f"ngp_dp_grad_{phase}"] = (
                    lambda w=w: self._dp_grad(state, bank[0], bank[1], w))
                entries[f"ngp_dp_update_{phase}"] = (
                    lambda w=w: self._dp_update(state, w))
        else:
            entries = {self._entry_name(w): (
                lambda w=w: self._step_body(state, bank[0], bank[1], w))
                for w in (True, False)}
        if not capture_steps(self, state, entries):
            self._gen = None

    def aot_register_render(self, state: NGPState, n_rays_image: int) -> None:
        """Capture the eval render of one test image's ray count at the eval
        stream cap (JAX ``ngp.py:316``), the cap first sized from the live
        grid (:meth:`maybe_derive_eval_cap`)."""
        if self.aot is None or not self.aot.enabled:
            return
        grid = state.grid_ema > self.threshold
        self.maybe_derive_eval_cap(grid)
        self._render_entry(grid, int(n_rays_image))

    def _render_entry(self, grid: torch.Tensor, n_rays: int):
        """The captured render of ``n_rays`` rays at the current cap,
        registered and captured on first use (JAX compiles a new cap's
        executable): ``ngp_render_{n_chunks}x{chunk}_cap{cap}``, the JAX
        name. None: no registry on the card, a ``march_fused`` route
        (``gather`` runs eagerly, ``full`` raises there) or a capture that
        failed."""
        if (self.aot is None or not self.aot.enabled
                or self.eval_march.march_fused != "off"):
            return None
        chunk, n_chunks = chunk_layout(n_rays, self.eval_march.chunk_size)
        key = (n_chunks, chunk, self.packed_cap_avg_eval)
        if key not in self._render_fns:
            name = f"ngp_render_{n_chunks}x{chunk}_cap{key[2]}"
            bbox = self._bbox(grid.device)
            rays = torch.zeros((n_chunks * chunk, 6), dtype=torch.float32,
                               device=grid.device)
            render = eval_entry(lambda g: self._march_fn(g, bbox), chunk)
            self.aot.register(name, render, (rays, grid.clone()))
            self.aot.compile_all()
            self._render_fns[key] = self.aot.take(name)
        return self._render_fns[key]

    def multi_step(self, state: NGPState, bank_rays, bank_rgbs,
                   k_steps: int | None = None):
        """A burst of K steps in one phase; a burst never straddles the end
        of the mandatory warmup. Returns ``(state, stats of the last
        step)``."""
        k = max(int(k_steps if k_steps is not None else self.scan_steps), 1)
        if self._host_step is None:
            # one sync at (re)start: the occupancy gate reflects the
            # RESTORED grid, and the cumulative warm steps are estimated
            # (resumed dense: every prior step was warm; carved: only the
            # mandatory warmup was)
            self._host_step = int(state.step)
            self._last_occ = float(
                (state.grid_ema > self.threshold).to(torch.float32).mean())
            est = (self._host_step if self._last_occ > self.warmup_exit_occ
                   else min(self._host_step, self.warmup_steps))
            self._warm_steps_total = min(est, self.warmup_max)
        # warm inside the mandatory warmup, or while the grid is dense
        # (capped by cumulative warm steps so a scene cannot warm forever)
        warm = self._host_step < self.warmup_steps or (
            self._last_occ > self.warmup_exit_occ
            and self._warm_steps_total < self.warmup_max)
        if warm and self._host_step < self.warmup_steps:
            k = min(k, self.warmup_steps - self._host_step)
        self._host_step += k
        if warm:
            self._warm_steps_total += k
        self.last_burst_steps = k
        self.last_burst_warm = warm
        stats = None
        for _ in range(k):
            stats = self._one_step(state, bank_rays, bank_rgbs, warm)
        self._bursts += 1
        if (warm or self._host_step < self.warmup_max or (
                self.occ_resync_bursts > 0
                and self._bursts % self.occ_resync_bursts == 0)):
            self._last_occ = float(stats["occupancy"])
            if not warm and not self._trunc_warned:
                tf = float(stats.get("truncated_frac", 0.0))
                if tf > self.trunc_warn_frac:
                    self._trunc_warned = True
                    knob = ("ngp_packed_cap_avg" if self.packed_march
                            else "max_march_samples")
                    print(f"ngp: truncated_frac {tf:.2f} exceeds "
                          f"{self.trunc_warn_frac} after warmup — the march "
                          "budget is dropping far content and those rays "
                          f"are masked out of the loss (raise {knob} or "
                          "check the grid threshold)")
        return state, stats

    # -- eval ----------------------------------------------------------------
    def val(self, state: NGPState, test_dataset, evaluator,
            max_images: int | None = None, log=print) -> dict:
        """Render test images through the live-grid march and feed the
        evaluator."""
        dev = state.grid_ema.device
        n = len(test_dataset)
        if max_images is not None:
            n = min(n, max_images)
        for i in range(n):
            batch = test_dataset.image_batch(i)
            with torch.no_grad():
                out = self.render_image(
                    state, {"rays": torch.from_numpy(batch["rays"]).to(dev)})
            evaluator.evaluate({k: v.cpu().numpy() for k, v in out.items()},
                               batch)
        result = evaluator.summarize()
        if result:
            log("ngp val: " + "  ".join(f"{k}: {v:.4f}"
                                        for k, v in result.items()))
        return result

    def _march_fn(self, grid, bbox):
        options, near, far = self.eval_march, self.near, self.far
        apply_fn = self._apply_fn()
        if options.march_fused == "full":
            # the fused mega-kernel encodes in-kernel (frequency family
            # only): a hash table cannot ride it
            raise ValueError(
                "march_fused='full' is unsupported on the NGP (hashgrid) "
                "eval path — use march_fused='gather' (fused DDA + gather; "
                "the MLP stays outside, so any encoder family rides it)")
        if options.march_fused == "gather":
            from ..ops.fused_march import march_rays_fused

            return lambda rc: march_rays_fused(apply_fn, rc, near, far, grid,
                                               bbox, options)
        if self.packed_march:
            from ..renderer.packed_march import march_rays_packed

            cap = self.packed_cap_avg_eval
            return lambda rc: march_rays_packed(apply_fn, rc, near, far,
                                                grid, bbox, options,
                                                cap_avg=cap)
        return lambda rc: march_rays_accelerated(apply_fn, rc, near, far,
                                                 grid, bbox, options)

    def render_image(self, state: NGPState, batch: dict) -> dict:
        """Whole-image eval through the march with the live grid, in
        ``march_chunk_size``-ray chunks: the captured render of the current
        cap when the registry is on the card, else eagerly. A packed stream
        that overflows its cap doubles ``ngp_packed_cap_avg_eval`` and
        re-renders (at most 3 times; the raised cap persists). Returns the
        per-ray maps (a replay's: read them before the next replay)."""
        grid = state.grid_ema > self.threshold
        self.maybe_derive_eval_cap(grid)
        bbox = self._bbox(grid.device)
        rays = batch["rays"]
        chunk, n_chunks = chunk_layout(rays.shape[0],
                                       self.eval_march.chunk_size)
        for attempt in range(4):
            # the cap is part of the entry's key: an escalation never
            # replays the outgrown entry
            fn = self._render_entry(grid, rays.shape[0])
            if fn is not None:
                out = replay_padded(fn, rays, n_chunks * chunk, grid)
            else:
                out = map_chunks(self._march_fn(grid, bbox), rays, chunk)
            overflow = out.pop("overflow_frac", None)
            max_of = float(overflow.max()) if overflow is not None else 0.0
            if max_of <= 0.0 or attempt == 3:
                break
            cap_old = self.packed_cap_avg_eval
            self.packed_cap_avg_eval *= 2
            self._eval_cap_escalations += 1
            get_emitter().emit("compile", name="ngp_render_eval_cap",
                               n_compiles=self._eval_cap_escalations,
                               wall_s=0.0, cap_old=cap_old,
                               cap_new=self.packed_cap_avg_eval)
            print(f"ngp render_image: packed stream overflow {max_of:.1%} — "
                  "escalating ngp_packed_cap_avg_eval to "
                  f"{self.packed_cap_avg_eval} and re-rendering")
        if "march_candidates" in out:
            # per-chunk traversal scalars: one march row per eval view
            get_emitter().emit(
                "march", surface="ngp_eval",
                mode=("fused" if self.eval_march.march_fused != "off"
                      else "hierarchical" if self.eval_march.coarse_block > 0
                      else "packed"),
                candidates_in=float(out.pop("march_candidates").sum()),
                samples_out=float(out.pop("march_samples_out").sum()),
                coarse_occ=float(out.pop("march_coarse_occ").mean()),
                overflow_frac=max_of, n_rays=int(rays.shape[0]))
        n_trunc = int(out.pop("truncated").sum())
        if n_trunc:
            budget = (f"ngp_packed_cap_avg_eval={self.packed_cap_avg_eval}"
                      if self.packed_march
                      else f"eval K={self.eval_march.max_samples}")
            print(f"ngp render_image: {n_trunc} rays exceeded the march "
                  f"budget ({budget}) while still transparent (far "
                  "contributions truncated)")
        if max_of > 0:
            print(f"ngp render_image: packed stream overflow up to "
                  f"{max_of:.1%} of occupied samples per chunk — raise "
                  "ngp_packed_cap_avg_eval")
        return out


def _ngp_epoch_steps(trainer: NGPTrainer, state: NGPState, bank, recorder,
                     epoch: int, ep_iter: int, log_interval: int,
                     finite_guard: bool = True, guard=None, log=print):
    """One epoch's burst loop from ``state.epoch_it``; each logged burst is
    a ``step`` row. A triggered SIGTERM ``guard`` stops it at the next
    burst boundary with ``state.epoch_it`` set to the steps taken."""
    from ..resil import check_finite

    emitter = get_emitter()
    it, state.epoch_it = state.epoch_it, 0
    end = time.time()
    while it < ep_iter:
        trainer.profile.tick(state.step)
        k = min(trainer.scan_steps, ep_iter - it)
        t_dispatch = time.perf_counter()
        with annotate("train/step_dispatch"):
            state, stats = trainer.multi_step(state, bank[0], bank[1], k)
        dispatch_s = time.perf_counter() - t_dispatch
        # multi_step may clamp a burst at the warmup boundary
        k = trainer.last_burst_steps
        should_log = (
            it == 0
            or (it + k - 1) // log_interval > (it - 1) // log_interval
            or it + k >= ep_iter
        )
        if should_log:
            t_block = time.perf_counter()
            stats_host = {kk: float(v) for kk, v in stats.items()}
            block_s = time.perf_counter() - t_block
            if finite_guard:
                stats_host = check_finite(stats_host, state.step)
            recorder.update_loss_stats(stats_host)
        recorder.step = state.step
        recorder.batch_time.update((time.time() - end) / k)
        recorder.data_time.update(0.0)
        end = time.time()
        if should_log:
            lr = float(state.schedule(state.step))
            mem = _device_mem_mb(bank[0].device)
            log(recorder.console_line(
                epoch, min(it + k - 1, ep_iter - 1), ep_iter, lr, mem))
            recorder.record("train")
            emitter.emit(
                "step", step=state.step, epoch=epoch, k=k,
                step_time_s=recorder.batch_time.median,
                step_time_avg_s=recorder.batch_time.avg,
                data_time_s=recorder.data_time.avg,
                dispatch_s=dispatch_s / k, block_s=block_s / k, lr=lr,
                max_mem_mb=mem,
                stats={**stats_host, "warm": trainer.last_burst_warm})
        it += k
        if agreed_stop(guard, trainer.mesh):
            state.epoch_it = it % ep_iter
            break
    trainer.profile.tick(state.step)
    return state


def fit_ngp(cfg, network=None, log=print, device="cuda"):
    """Epoch-loop entry for ``task_arg.ngp_training: true`` (what
    ``trainer.fit`` routes to): resume (weights, optimizer, grid EMA and the
    phase sidecar) or a ``pretrain`` warm start, the epoch loop with its
    save/eval cadence on one card, telemetry, the profiler window, the
    divergence rollback and the SIGTERM flush; over a mesh of ranks when a
    launcher started several (module docstring). Returns the final
    :class:`NGPState`."""
    from ..compile import registry_from_cfg
    from ..datasets import make_dataset
    from ..evaluators import make_evaluator
    from ..obs import init_run
    from ..parallel.mesh import is_chief
    from ..resil import DivergenceError, PreemptionGuard
    from ..utils.setup import configure_runtime
    from .checkpoint import (
        load_model,
        load_phase_state,
        load_pretrain,
        save_trained_config,
    )
    from .recorder import make_recorder

    if int(cfg.get("parallel", {}).get("model_axis", 1)) > 1:
        # JAX train/ngp.py:980, before any process group or data
        raise NotImplementedError(
            "ngp_training supports data parallelism only (the occupancy "
            "march has no tensor-parallel seam yet) — set "
            "parallel.model_axis 1"
        )
    mesh, dev = setup_mesh(cfg, device, log)
    configure_runtime(cfg)
    if network is None:
        from ..models import make_network

        network = make_network(cfg)
    trainer = NGPTrainer(cfg, network, mesh=mesh)
    evaluator = None if cfg.get("skip_eval", False) else make_evaluator(cfg)
    recorder = make_recorder(cfg)
    # telemetry opens AFTER the recorder (a fresh run wipes record_dir)
    emitter = init_run(cfg, component="train_ngp")
    state = trainer.make_state(dev)

    begin_epoch = 0
    if cfg.get("resume", True):
        state, begin_epoch, rec_state = load_model(cfg.trained_model_dir,
                                                   state)
        if rec_state:
            recorder.load_state_dict(rec_state)
        # re-enter the persisted warm/carve phase (the occupancy estimate
        # in multi_step when the sidecar is absent or torn)
        trainer.restore_phase(load_phase_state(cfg.trained_model_dir),
                              expect_step=state.step)
    if begin_epoch == 0 and state.epoch_it == 0 and cfg.get("pretrain", ""):
        load_pretrain(str(cfg.pretrain), state.network)
    sync_state(state, mesh, grid=state.grid_ema)
    if is_chief():
        save_trained_config(cfg)

    train_ds = make_dataset(cfg, "train")
    bank, _ = shard_inputs(cfg, train_ds, mesh, dev, precrop=False)
    # CUDA graphs: both phase variants and the eval render captured before
    # the loop (compile.aot; a disabled registry on the CPU)
    trainer.aot = registry_from_cfg(cfg, dev, tracker=trainer.tracker)
    trainer.aot_register_steps(state, bank)
    test_ds = make_dataset(cfg, "test")
    epochs = int(cfg.train.epoch)
    ep_iter = int(cfg.get("ep_iter", 500))
    if ep_iter <= 0:
        world = 1 if mesh is None else mesh.size
        ep_iter = max(1, int(bank[0].shape[0]) * world // trainer.n_rays)
    save_ep = int(cfg.get("save_ep", 40))
    save_latest_ep = int(cfg.get("save_latest_ep", 10))
    eval_ep = int(cfg.get("eval_ep", 10))
    if not is_chief():
        evaluator = None  # the chief validates (JAX: rank 0 only)
    if evaluator is not None and validates(begin_epoch, epochs, eval_ep):
        trainer.aot_register_render(state, int(test_ds.H) * int(test_ds.W))
    if trainer.aot is not None and trainer.aot.names():
        log("compile: " + json.dumps(trainer.aot.status()))
    log_interval = int(cfg.get("log_interval", 20))
    rcfg = cfg.get("resil", {})
    finite_guard = bool(rcfg.get("finite_guard", True))
    max_rollbacks = int(rcfg.get("max_rollbacks", 2))
    guard = (PreemptionGuard.install()
             if bool(rcfg.get("preempt_sigterm", True)) else None)
    rollbacks = 0
    t_fit_start = time.time()
    try:
        epoch = begin_epoch
        while epoch < epochs:
            recorder.epoch = epoch
            t_epoch = time.time()
            step_before = state.step
            try:
                state = _ngp_epoch_steps(trainer, state, bank, recorder,
                                         epoch, ep_iter, log_interval,
                                         finite_guard, guard=guard, log=log)
            except DivergenceError as err:
                epoch = _roll_back(cfg, state, recorder, err, rollbacks,
                                   max_rollbacks, log)
                rollbacks += 1
                # re-sync the warm/carve phase to the RESTORED state (the
                # diverged run's host counters are stale)
                trainer._host_step = None
                trainer.restore_phase(
                    load_phase_state(cfg.trained_model_dir),
                    expect_step=state.step)
                continue
            if state.epoch_it:
                _flush_preempted(cfg, state, epoch, recorder, log,
                                 phase_state=trainer.phase_state(),
                                 mesh=mesh)
                break
            _epoch_rows(emitter, epoch, state.step, state.step - step_before,
                        time.time() - t_epoch, time.time() - t_fit_start)
            for latest, every in ((False, save_ep), (True, save_latest_ep)):
                if (epoch + 1) % every == 0:
                    chief_save(cfg, state, epoch, recorder, mesh, log=log,
                               latest=latest,
                               phase_state=trainer.phase_state())
            if (epoch + 1) % eval_ep == 0 and evaluator is not None:
                result = trainer.val(state, test_ds, evaluator, log=log)
                if result:
                    recorder.record("val", step=epoch, stats=result)
            if agreed_stop(guard, mesh):
                chief_save(cfg, state, epoch, recorder, mesh, log=log,
                           latest=True, phase_state=trainer.phase_state())
                log("SIGTERM: latest checkpoint flushed; exiting")
                break
            epoch += 1
    finally:
        if guard is not None:
            guard.uninstall()
        trainer.profile.stop()
        emitter.close()
    return state
