"""Training cells: set-up, the first steps, the window and the comparison.

Set-up makes the ray bank and the weights on the device from the seed,
builds the program's trainer around them, captures its step (the program's
CUDA graphs) and drives it through its first steps through the window's own
call; those steps are the ones the reference follows. The window then runs
the same trainer in a closed loop. After the window the program's state is
freed and the reference retrains the first steps from the same weights and
draws.
"""

from __future__ import annotations

import math
import time

from . import scene, weights
from .window import closed_loop, device_sync


def program_cfg(config: dict, seed: int, extra=()):
    from nerf_replication_tpu_torch.config import make_cfg

    from .spec import ROOT
    import os

    prog = config["program"]
    return make_cfg(os.path.join(ROOT, prog["yaml"]),
                    [*prog["train_opts"], *extra, "seed", str(int(seed))])


def check_cfg(cfg, spec: dict) -> None:
    """Refuse a program configuration that is not the one stated."""
    ta, net = cfg.task_arg, cfg.network
    have = {
        "D": int(net.nerf.D), "W": int(net.nerf.W),
        "skips": [int(s) for s in net.nerf.skips],
        "N_rays": int(ta.N_rays), "near": float(ta.near),
        "far": float(ta.far),
        "compute_dtype": str(cfg.precision.compute_dtype),
        "lr": float(cfg.train.lr),
        "eps": float(cfg.train.get("eps", 1e-8)),
        "decay_steps": float(cfg.train.scheduler.decay_epochs)
        * int(cfg.ep_iter),
        "gamma": float(cfg.train.scheduler.gamma),
        "N_samples": int(ta.N_samples),
        "N_importance": int(ta.N_importance),
        "pe_xyz": int(net.xyz_encoder.freq),
        "pe_dir": int(net.dir_encoder.freq),
        "perturb": float(ta.perturb),
    }
    want = {k: spec[k] for k in ("D", "W", "skips", "N_rays", "near", "far",
                                 "compute_dtype", "N_samples",
                                 "N_importance", "pe_xyz", "pe_dir")}
    want.update({k: spec["optimizer"][k] for k in ("lr", "eps",
                                                   "decay_steps", "gamma")})
    want["perturb"] = 1.0
    bad = {k: (have[k], want[k]) for k in want if have[k] != want[k]}
    if bad:
        raise ValueError(f"the program's configuration is not the stated "
                         f"one (program, stated): {bad}")


class TrainRun:
    """One training cell's run: :meth:`setup`, :meth:`window`,
    :meth:`free_program`, then :meth:`reference` and :meth:`numbers`."""

    def __init__(self, torch, device, cell, seed: int, t_start: float):
        self.torch, self.device, self.cell = torch, device, cell
        self.seed = int(seed)
        self.t_start = t_start
        self.spec = cell.config["model_spec"]
        self.traffic = cell.traffic
        self.readings = {}

    # -- set-up ---------------------------------------------------------
    def _layout(self):
        from reference import nerf

        s = self.spec
        c_pts = nerf.encoded_width(s["pe_xyz"])
        c_views = nerf.encoded_width(s["pe_dir"])
        return [item for prefix in ("coarse", "fine")
                for item in nerf.mlp_layout(prefix, s["D"], s["W"],
                                            s["skips"], c_pts, c_views)]

    def make_inputs(self) -> None:
        """The ray bank and the weights, from the seed."""
        sc = self.cell.config["scene"]
        self.bank = scene.make_bank(self.seed, sc["n_views"], sc["H"],
                                    sc["W"], self.device,
                                    sc["camera_angle_x"])
        self.layout = self._layout()
        self.w0 = weights.make_weights(self.layout, self.seed, self.device)

    def setup(self) -> None:
        torch, dev = self.torch, self.device
        self.make_inputs()
        self._setup_trainer()
        self._first_steps()
        device_sync(torch, dev)
        self.setup_s = time.perf_counter() - self.t_start

    def _build_network(self, cfg):
        from nerf_replication_tpu_torch.models import make_network
        from nerf_replication_tpu_torch.train.optim import make_optimizer

        network = make_network(cfg).to(self.device)
        weights.load_into(network, self.w0)
        optimizer, schedule = make_optimizer(cfg, network.parameters())
        return network, optimizer, schedule

    def _setup_trainer(self) -> None:
        from nerf_replication_tpu_torch.compile import registry_from_cfg
        from nerf_replication_tpu_torch.train.loss import make_loss
        from nerf_replication_tpu_torch.train.trainer import (Trainer,
                                                              TrainState)

        cfg = program_cfg(self.cell.config, self.seed)
        check_cfg(cfg, self.spec)
        network, optimizer, schedule = self._build_network(cfg)
        self.state = TrainState(network, optimizer, schedule, 0)
        self.trainer = Trainer(cfg, network, make_loss(cfg, network))
        self.trainer.aot = registry_from_cfg(cfg, self.device)
        self.trainer.aot_register_steps(self.state, self.bank)
        self._check_registry(self.trainer.aot)
        k = int(self.traffic["unit_steps"])
        rays, rgbs = self.bank

        def unit(k_steps=k):
            self.state, self.last_stats = self.trainer.multi_step(
                self.state, rays, rgbs, k_steps=k_steps)

        self.unit = unit
        self.step_one = lambda: unit(1)

    def _check_registry(self, aot) -> None:
        if aot is not None and aot.summary()["errors"]:
            raise RuntimeError(f"step capture failed: {aot.status()}")

    def _first_steps(self) -> None:
        """The compared steps, through the window's own call: each step's
        loss, the first gradient as Adam holds it after one step, the
        change of every leaf after the last."""
        torch = self.torch
        opt = self.state.optimizer
        names = {p: n for n, p in self.state.network.named_parameters()}
        beta1 = opt.param_groups[0]["betas"][0]
        n = int(self.traffic["compared_steps"])
        losses = []
        for i in range(n):
            self.step_one()
            losses.append(float(self.last_stats["loss"]))
            if i == 0:
                # a leaf the optimizer holds no moment for took no step
                self.readings["grad1"] = {
                    names[p]: (opt.state[p]["exp_avg"] / (1.0 - beta1)
                               if "exp_avg" in opt.state.get(p, {})
                               else torch.zeros_like(p)) for p in names}
        params = dict(self.state.network.named_parameters())
        self.readings["losses"] = losses
        self.readings["delta"] = {k: params[k].detach() - self.w0[k]
                                  for k in self.w0}

    # -- the window -----------------------------------------------------
    def window(self, seconds: float, tracer=None) -> dict:
        out = closed_loop(self.torch, self.device, self.unit, seconds,
                          tracer)
        steps = out["units"] * int(self.traffic["unit_steps"])
        loss = float(self.last_stats["loss"])
        return {
            "rays_per_s": steps * self.spec["N_rays"] / out["elapsed_s"],
            "steps": steps,
            "finite": math.isfinite(loss),
            "traced_steps": out["traced_units"]
            * int(self.traffic["unit_steps"]),
        }

    def free_program(self) -> None:
        for name in ("trainer", "state", "unit", "step_one", "last_stats"):
            if hasattr(self, name):
                delattr(self, name)
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    # -- the comparison -------------------------------------------------
    def reference(self, precision: str | None = None, fault=None) -> dict:
        """The first steps retrained plainly, every product's operands
        rounded to ``precision`` (by default the configuration's)."""
        from reference import lego_train
        from reference.precision import exact_float32

        exact_float32()
        n = int(self.traffic["compared_steps"])
        return lego_train.train_steps(self.w0, self.spec, *self.bank,
                                      self.seed, n,
                                      precision or self.spec["compute_dtype"],
                                      fault)

    def numbers(self, ref: dict) -> dict:
        from reference import compare

        return compare.train_numbers(self.readings, ref)
