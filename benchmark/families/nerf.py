"""The original NeRF (Mildenhall et al. 2020) as a model family of the
benchmark: coarse + fine MLPs on frequency-encoded positions and view
directions, trained by the program's ``Trainer`` and served by its
``RenderEngine``.

A family is the file ``benchmark/families/<model>.py`` that a
configuration's ``model_spec.model`` names; ``harness/spec.py`` loads it by
path. It holds every step of a run that depends on the model, as these
functions (``cfg`` is the program's configuration, ``spec`` the
configuration file's ``model_spec``, ``serve`` its ``serve`` block):

Training cells
    ``check_train_cfg(cfg, spec)``, ``initial_weights(spec, seed,
    device)``, ``build_trainer(cfg, w0, bank, device)`` (an object with
    ``unit(k_steps)``, ``loss()``, ``optimizer`` and
    ``named_parameters()``), ``rays_per_step(spec)``,
    ``train_reference(w0, spec, bank, seed, n_steps, precision, fault)``,
    ``step_flops(spec)`` (read by ``mfu.train``).
Serving cells
    ``check_serve_cfg(cfg, spec, serve)``, ``initial_weights``,
    ``build_engine(cfg, w0, grid, bbox, spec, device)``,
    ``reference_maps(w0, rays, grid, spec, serve, precision)``,
    ``count_samples(rays, grid, spec, serve)``, ``sample_flops(spec)``
    (read by ``mfu.serve``).
CPU tests
    ``tiny_train(config, dtype)`` and ``tiny_serve(config)`` cut a copy of
    the configuration in place; ``fault_patches(name)`` plants a fault
    (:data:`FAULTS`) in the program as ``[(owner, attribute, value)]``.
"""

from __future__ import annotations

from counts import mlp
from harness import weights
from reference import lego_train, nerf, serve_march
from reference.precision import operand_rounding

# -- training ------------------------------------------------------------


def check_train_cfg(cfg, spec: dict) -> None:
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


def _layout(spec: dict):
    c_pts = nerf.encoded_width(spec["pe_xyz"])
    c_views = nerf.encoded_width(spec["pe_dir"])
    return [item for prefix in ("coarse", "fine")
            for item in nerf.mlp_layout(prefix, spec["D"], spec["W"],
                                        spec["skips"], c_pts, c_views)]


def initial_weights(spec: dict, seed: int, device) -> dict:
    """The coarse and fine MLPs' parameters under the program's names:
    LeCun-normal matrices and zero biases (``harness/weights.py``)."""
    return weights.make_weights(_layout(spec), seed, device)


class _Trainer:
    """The program's coarse + fine ``Trainer`` over the bank, started from
    ``w0``, with every step it takes captured."""

    def __init__(self, cfg, w0: dict, bank, device):
        from nerf_replication_tpu_torch.compile import registry_from_cfg
        from nerf_replication_tpu_torch.models import make_network
        from nerf_replication_tpu_torch.train.loss import make_loss
        from nerf_replication_tpu_torch.train.optim import make_optimizer
        from nerf_replication_tpu_torch.train.trainer import (Trainer,
                                                              TrainState)

        network = make_network(cfg).to(device)
        weights.load_into(network, w0)
        optimizer, schedule = make_optimizer(cfg, network.parameters())
        self.state = TrainState(network, optimizer, schedule, 0)
        self.trainer = Trainer(cfg, network, make_loss(cfg, network))
        self.trainer.aot = registry_from_cfg(cfg, device)
        self.trainer.aot_register_steps(self.state, bank)
        aot = self.trainer.aot
        if aot is not None and aot.summary()["errors"]:
            raise RuntimeError(f"step capture failed: {aot.status()}")
        self.rays, self.rgbs = bank
        self.stats = None

    def unit(self, k_steps: int) -> None:
        """``k_steps`` steps as one captured burst (enqueued)."""
        self.state, self.stats = self.trainer.multi_step(
            self.state, self.rays, self.rgbs, k_steps=k_steps)

    def loss(self) -> float:
        """The last step's loss (waits for it)."""
        return float(self.stats["loss"])

    @property
    def optimizer(self):
        return self.state.optimizer

    def named_parameters(self):
        return self.state.network.named_parameters()


def build_trainer(cfg, w0: dict, bank, device) -> _Trainer:
    return _Trainer(cfg, w0, bank, device)


def rays_per_step(spec: dict) -> int:
    return spec["N_rays"]


def train_reference(w0: dict, spec: dict, bank, seed: int, n_steps: int,
                    precision: str, fault: str | None = None) -> dict:
    """The first ``n_steps`` retrained plainly (``reference/lego_train.py``)
    from the same weights, bank and draws."""
    return lego_train.train_steps(w0, spec, *bank, seed, n_steps, precision,
                                  fault)


def step_flops(spec: dict) -> int:
    """A training step's model operations: every MLP row of the coarse and
    fine networks forward, and the backward's two products."""
    rows = sum(mlp.nerf_rows_per_step(spec).values())
    return mlp.train_step_flops(rows, mlp.row_flops(*mlp.nerf_widths(spec)))


# -- serving -------------------------------------------------------------


def check_serve_cfg(cfg, spec: dict, serve: dict) -> None:
    from nerf_replication_tpu_torch.renderer.accelerated import MarchOptions

    m = MarchOptions.eval_from_cfg(cfg)
    have = {"step": m.step_size, "max_samples": m.max_samples,
            "termination": m.transmittance_threshold,
            "coarse_block": m.coarse_block,
            "route": m.march_fused,
            "compute_dtype": str(cfg.precision.compute_dtype),
            "near": float(cfg.task_arg.near), "far": float(cfg.task_arg.far),
            "D": int(cfg.network.nerf.D), "W": int(cfg.network.nerf.W)}
    want = {"step": serve["step"], "max_samples": serve["max_samples"],
            "termination": serve["termination"],
            "coarse_block": serve.get("coarse_block", 0),
            "route": serve["route"], "compute_dtype": serve["compute_dtype"],
            "near": spec["near"], "far": spec["far"], "D": spec["D"],
            "W": spec["W"]}
    bad = {k: (have[k], want[k]) for k in want if have[k] != want[k]}
    if bad:
        raise ValueError(f"the program's serving configuration is not the "
                         f"stated one (program, stated): {bad}")


def build_engine(cfg, w0: dict, grid, bbox, spec: dict, device):
    """The program's ``RenderEngine`` over the network with ``w0``, the
    grid and bbox, with the ``full`` tier warmed."""
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.serve import RenderEngine

    network = make_network(cfg).to(device)
    weights.load_into(network, w0)
    return RenderEngine(cfg, network, spec["near"], spec["far"],
                        grid=grid.cpu().numpy(), bbox=bbox, device=device,
                        warmup_families=("full",))


def reference_maps(w0: dict, rays, grid, spec: dict, serve: dict,
                   precision: str = "float32") -> dict:
    """The served view of ``rays`` rendered plainly: the occupancy march
    (``reference/serve_march.py``) over the fine MLP."""
    q = operand_rounding(precision)

    def field(pts, vd):
        return nerf.field(w0, "fine", pts[:, None, :], vd, spec, q)[:, 0, :]

    return serve_march.render(field, rays, grid,
                              dict(spec, bbox=serve["bbox"]),
                              dict(serve, near=spec["near"], far=spec["far"]))


def count_samples(rays, grid, spec: dict, serve: dict) -> int:
    return serve_march.count_samples(rays, grid,
                                     dict(spec, bbox=serve["bbox"]), serve)


def sample_flops(spec: dict) -> int:
    """One kept sample through the fine MLP forward."""
    return mlp.row_flops(*mlp.nerf_widths(spec))


# -- CPU tests -----------------------------------------------------------

TINY = {"D": 3, "W": 32, "skips": [1], "N_samples": 8, "N_importance": 8,
        "N_rays": 64}
TINY_OPTS = ["network.nerf.D", "3", "network.nerf.W", "32",
             "network.nerf.skips", "[1]", "network.nerf.fused_tile", "64"]


def tiny_train(config: dict, dtype: str | None) -> None:
    """Small widths, 8 + 8 samples, 64 rays; ``dtype``: the compute
    precision, None for the configuration's."""
    ms, opts = config["model_spec"], config["program"]["train_opts"]
    ms.update(TINY)
    opts += TINY_OPTS + ["task_arg.N_samples", "8",
                         "task_arg.N_importance", "8", "task_arg.N_rays",
                         "64"]
    if dtype:
        ms["compute_dtype"] = dtype
        opts += ["precision.compute_dtype", dtype]


def tiny_serve(config: dict) -> None:
    """Small widths and buckets, a 16^3 grid and a 16-position march."""
    extra = ["serve.buckets", "[256, 1024]", "task_arg.march_chunk_size",
             "256", "task_arg.render_step_size", "0.1",
             "task_arg.eval_render_step_size", "0.1",
             "task_arg.max_march_samples", "16",
             "task_arg.eval_max_march_samples", "16", *TINY_OPTS]
    config["model_spec"].update(TINY)
    config["serve"].update({"grid_res": 16, "step": 0.1, "max_samples": 16})
    config["program"]["serve_opts"] = config["program"]["serve_opts"] + extra


def _state_unchanged():
    from nerf_replication_tpu_torch.train import trainer

    return [(trainer, "optimizer_step", lambda opt: None)]


def _half_batch():
    from nerf_replication_tpu_torch.datasets import sampling
    from nerf_replication_tpu_torch.train import step_core

    def half(gen, rays, rgbs, n_rays, index_pool=None):
        r, c = sampling.sample_rays(gen, rays, rgbs, n_rays, index_pool)
        return r[: n_rays // 2], c[: n_rays // 2]

    return [(step_core, "sample_rays", half)]


def _answer_altered():
    from nerf_replication_tpu_torch.serve import engine

    real = engine.RenderEngine._render_bucket

    def altered(self, rays, bucket, family, warm=False, scene=None):
        out = real(self, rays, bucket, family, warm=warm, scene=scene)
        if not warm and rays.shape[0]:
            out["rgb_map_f"] = out["rgb_map_f"].copy()
            out["rgb_map_f"][0] += 0.05
        return out

    return [(engine.RenderEngine, "_render_bucket", altered)]


# each fault a cell can have on one card, by the traffic kind it breaks
FAULTS = {"train_loop": {"state_unchanged": _state_unchanged,
                         "half_batch": _half_batch},
          "viewer_open": {"answer_altered": _answer_altered}}


def fault_patches(name: str) -> list:
    """``[(owner, attribute, value)]`` that plant fault ``name``."""
    for faults in FAULTS.values():
        if name in faults:
            return faults[name]()
    raise KeyError(f"no fault {name!r}")
