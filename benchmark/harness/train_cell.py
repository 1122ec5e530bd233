"""Training cells: set-up, the first steps, the window and the comparison.

Set-up makes the ray bank and the weights on the device from the seed,
has the cell's model family build the program's trainer around them, with
its step captured (the program's CUDA graphs), and drives it through its
first steps through the window's own call; those steps are the ones the
reference follows. The window then runs the same trainer in a closed loop.
After the window the program's state is freed and the family's reference
retrains the first steps from the same weights and draws.
"""

from __future__ import annotations

import math
import time

from . import scene
from .window import closed_loop, device_sync


def program_cfg(config: dict, seed: int, extra=()):
    from nerf_replication_tpu_torch.config import make_cfg

    from .spec import ROOT
    import os

    prog = config["program"]
    return make_cfg(os.path.join(ROOT, prog["yaml"]),
                    [*prog["train_opts"], *extra, "seed", str(int(seed))])


class TrainRun:
    """One training cell's run: :meth:`setup`, :meth:`window`,
    :meth:`free_program`, then :meth:`reference` and :meth:`numbers`."""

    def __init__(self, torch, device, cell, seed: int, t_start: float):
        self.torch, self.device, self.cell = torch, device, cell
        self.seed = int(seed)
        self.t_start = t_start
        self.spec = cell.config["model_spec"]
        self.family = cell.family
        self.traffic = cell.traffic
        self.readings = {}
        self.marks = [("start", t_start)]

    def mark(self, phase: str) -> None:
        """End set-up's phase ``phase`` here, once the device has done its
        work: :attr:`setup_phases` gives each phase's seconds."""
        device_sync(self.torch, self.device)
        self.marks.append((phase, time.perf_counter()))

    @property
    def setup_phases(self) -> dict:
        return {name: t - t0 for (_, t0), (name, t)
                in zip(self.marks, self.marks[1:])}

    # -- set-up ---------------------------------------------------------
    def make_inputs(self) -> None:
        """The ray bank and the weights, from the seed."""
        sc = self.cell.config["scene"]
        self.bank = scene.make_bank(self.seed, sc["n_views"], sc["H"],
                                    sc["W"], self.device,
                                    sc["camera_angle_x"])
        self.mark("bank")
        self.w0 = self.family.initial_weights(self.spec, self.seed,
                                              self.device)
        self.mark("weights")

    def setup(self) -> None:
        self.make_inputs()
        self._setup_trainer()
        self.mark("trainer")
        self._first_steps()
        self.mark("first_steps")
        self.setup_s = self.marks[-1][1] - self.t_start

    def _setup_trainer(self) -> None:
        cfg = program_cfg(self.cell.config, self.seed)
        self.family.check_train_cfg(cfg, self.spec)
        self.program = self.family.build_trainer(cfg, self.w0, self.bank,
                                                 self.device)
        k = int(self.traffic["unit_steps"])

        def unit(k_steps=k):
            self.program.unit(k_steps)

        self.unit = unit
        self.step_one = lambda: unit(1)

    def _first_steps(self) -> None:
        """The compared steps, through the window's own call: each step's
        loss, the first gradient as Adam holds it after one step, the
        change of every leaf after the last."""
        torch = self.torch
        opt = self.program.optimizer
        names = {p: n for n, p in self.program.named_parameters()}
        beta1 = opt.param_groups[0]["betas"][0]
        n = int(self.traffic["compared_steps"])
        losses = []
        for i in range(n):
            self.step_one()
            losses.append(self.program.loss())
            if i == 0:
                # a leaf the optimizer holds no moment for took no step
                self.readings["grad1"] = {
                    names[p]: (opt.state[p]["exp_avg"] / (1.0 - beta1)
                               if "exp_avg" in opt.state.get(p, {})
                               else torch.zeros_like(p)) for p in names}
        params = dict(self.program.named_parameters())
        self.readings["losses"] = losses
        self.readings["delta"] = {k: params[k].detach() - self.w0[k]
                                  for k in self.w0}

    # -- the window -----------------------------------------------------
    def window(self, seconds: float, tracer=None) -> dict:
        out = closed_loop(self.torch, self.device, self.unit, seconds,
                          tracer)
        steps = out["units"] * int(self.traffic["unit_steps"])
        loss = self.program.loss()
        rays = self.family.rays_per_step(self.spec)
        return {
            "rays_per_s": steps * rays / out["elapsed_s"],
            "steps": steps,
            "finite": math.isfinite(loss),
            "traced_steps": out["traced_units"]
            * int(self.traffic["unit_steps"]),
        }

    def free_program(self) -> None:
        for name in ("program", "unit", "step_one"):
            if hasattr(self, name):
                delattr(self, name)
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    # -- the comparison -------------------------------------------------
    def reference(self, precision: str | None = None, fault=None) -> dict:
        """The first steps retrained plainly by the family's reference,
        every product's operands rounded to ``precision`` (by default the
        configuration's)."""
        from reference.precision import exact_float32

        exact_float32()
        n = int(self.traffic["compared_steps"])
        return self.family.train_reference(
            self.w0, self.spec, self.bank, self.seed, n,
            precision or self.spec["compute_dtype"], fault)

    def numbers(self, ref: dict) -> dict:
        from reference import compare

        return compare.train_numbers(self.readings, ref)
