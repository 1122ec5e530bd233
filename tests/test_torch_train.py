"""Port parity of the training path: loss, LR schedule, optimizer step,
checkpoints, resume, the fit loop and the train entry point.

* One optimizer step (Adam after clip by value 40) from identical weights
  on an identical ray batch (perturb 0), through the plain Network and
  through the fused MLP Function, against the JAX ``NeRFLoss`` +
  ``TrainState.apply_gradients``: loss atol 1e-6, parameters atol 5e-6 (1%
  of lr = 5e-4) after one and after two steps. Adam moves every parameter
  by about lr on its first step, and gradients that differ in their last
  bits move it by far less than 1e-6 — except where |g| is within a few
  orders of eps (1e-8): there g/(|g| + eps) amplifies those bits (measured:
  2 of 2016 elements of one layer at 2.3e-6).
* The LR schedules equal optax's at steps 0, 1 and decay_epochs·ep_iter
  (rtol 1e-6: optax evaluates in float32).
* A tiny CPU fit raises PSNR; a run saved after one epoch and resumed gives
  the same losses, step for step, and the same weights as an uninterrupted
  run (bitwise on the CPU).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import LEGO, ROOT, both_cfgs, jax_tree_numpy, nets

from nerf_replication_tpu_torch.config import make_cfg
from nerf_replication_tpu_torch.datasets.procedural import generate_scene

NET = ["network.nerf.W", "32", "network.nerf.D", "4",
       "network.nerf.skips", "[1]", "task_arg.N_samples", "16",
       "task_arg.N_importance", "16", "task_arg.perturb", "0",
       "network.nerf.fused_tile", "64"]


def _batch(n=48, seed=3):
    rng = np.random.default_rng(seed)
    o = np.tile([0.0, 0.0, 4.0], (n, 1)) + rng.normal(0, 0.1, (n, 3))
    d = np.array([0.0, 0.0, -1.0]) + rng.normal(0, 0.2, (n, 3))
    rays = np.concatenate([o, d], -1).astype(np.float32)
    rgbs = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return rays, rgbs


@pytest.fixture(scope="module")
def jax_steps():
    """Two JAX steps (NeRFLoss + TrainState.apply_gradients) from the
    weights ``nets(NET)`` gives: [(loss, grads, params after the step)]."""
    from flax.training.train_state import TrainState

    from nerf_replication_tpu.train.loss import NeRFLoss as JaxLoss
    from nerf_replication_tpu.train.optim import make_optimizer as jax_opt

    jnet, params, _ = nets(extra=NET)
    jcfg, _ = both_cfgs(NET)
    rays, rgbs = _batch()
    jbatch = {"rays": jnp.asarray(rays), "rgbs": jnp.asarray(rgbs),
              "near": 2.0, "far": 6.0}
    jloss = JaxLoss(jcfg, jnet)
    tx, _ = jax_opt(jcfg)
    state = TrainState.create(apply_fn=jnet.apply, params=params["params"],
                              tx=tx)

    @jax.jit
    def step(state):
        def lf(p):
            return jloss({"params": p}, jbatch, key=None, train=True)[1]

        loss, g = jax.value_and_grad(lf)(state.params)
        return loss, g, state.apply_gradients(grads=g)

    out = []
    for _ in range(2):
        loss, g, state = step(state)
        out.append((float(loss), jax_tree_numpy(g),
                    jax_tree_numpy(state.params)))
    return out


def _pairs(pnet, tree, grad=False):
    """(port array in the JAX layout, JAX array) for every leaf."""
    for branch, layers in tree.items():
        for name, leaf in layers.items():
            mod = getattr(getattr(pnet, branch), name)
            w, b = (mod.weight.grad, mod.bias.grad) if grad else (
                mod.weight, mod.bias)
            yield (f"{branch}.{name}", w.detach().numpy().T, leaf["kernel"])
            yield (f"{branch}.{name}.bias", b.detach().numpy(), leaf["bias"])


@pytest.mark.parametrize("fused", [False, True])
def test_two_optimizer_steps_match_jax(jax_steps, fused):
    """Loss (atol 1e-6) and gradients (within 1e-3 of each tensor's largest
    |value|: each sums 768 samples' terms with cancellation in another
    order than XLA's; measured 1.1e-4) at identical weights; then two steps
    of the whole trajectory:
    every parameter within 2·lr of JAX's (one Adam step moves it at most
    about lr) and 99.9% of them within 1e-6."""
    from nerf_replication_tpu_torch.train.loss import NeRFLoss
    from nerf_replication_tpu_torch.train.optim import (
        apply_update,
        make_optimizer,
    )

    _, _, pnet = nets(extra=NET)
    _, pcfg = both_cfgs(NET + ["network.nerf.fused_trunk", str(fused).lower()])
    rays, rgbs = _batch()
    pbatch = {"rays": torch.from_numpy(rays), "rgbs": torch.from_numpy(rgbs),
              "near": 2.0, "far": 6.0}
    ploss = NeRFLoss(pcfg, pnet)
    opt, sched = make_optimizer(pcfg, pnet.parameters())
    lr = float(pcfg.train.lr)
    for count, (jl, jg, tree) in enumerate(jax_steps):
        opt.zero_grad()
        _, pl, _ = ploss(pbatch, gen=None, train=True)
        pl.backward()
        if count == 0:
            assert abs(float(pl.detach()) - jl) <= 1e-6
            for name, a, b in _pairs(pnet, jg, grad=True):
                scale = max(float(np.abs(b).max()), 1e-30)
                assert float(np.abs(a - b).max()) <= 1e-3 * scale, name
        apply_update(opt, sched, count)
        diffs = np.concatenate([np.abs(a - b).ravel()
                                for _, a, b in _pairs(pnet, tree)])
        assert float(diffs.max()) <= 2 * lr
        assert float(np.mean(diffs <= 1e-6)) >= 0.999


def test_adam_after_clip_matches_optax_on_the_same_gradients(jax_steps):
    """JAX's own gradients fed to the port's optimizer (clip by value 40,
    lr = schedule(count), torch Adam with eps outside the bias-corrected
    square root) give optax's parameters after each of two steps, to
    1e-7 (a few float32 ulps of the weights)."""
    from nerf_replication_tpu_torch.train.optim import (
        apply_update,
        make_optimizer,
    )

    _, _, pnet = nets(extra=NET)
    _, pcfg = both_cfgs(NET)
    opt, sched = make_optimizer(pcfg, pnet.parameters())
    for count, (_, jg, tree) in enumerate(jax_steps):
        for branch, layers in jg.items():
            for name, leaf in layers.items():
                mod = getattr(getattr(pnet, branch), name)
                mod.weight.grad = torch.from_numpy(leaf["kernel"].T.copy())
                mod.bias.grad = torch.from_numpy(leaf["bias"].copy())
        apply_update(opt, sched, count)
        for name, a, b in _pairs(pnet, tree):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-7,
                                       err_msg=f"{count} {name}")


def test_gradient_clip_is_by_value_at_40():
    from nerf_replication_tpu_torch.train.optim import clip_gradients

    p = torch.nn.Parameter(torch.zeros(4))
    p.grad = torch.tensor([-100.0, -3.0, 39.0, 1e6])
    clip_gradients([p])
    assert p.grad.tolist() == [-40.0, -3.0, 39.0, 40.0]


@pytest.mark.parametrize("sched", [
    [],
    ["train.scheduler.type", "multi_step", "train.scheduler.milestones",
     "[2, 4]", "train.scheduler.gamma", "0.5"],
    ["train.scheduler.type", "warmup_multi_step",
     "train.scheduler.milestones", "[2, 4]", "train.scheduler.gamma", "0.5",
     "train.scheduler.warmup_epochs", "1"],
])
def test_lr_schedule_matches_optax(sched):
    from nerf_replication_tpu.train.optim import make_lr_schedule as jax_lr
    from nerf_replication_tpu_torch.train.optim import make_lr_schedule

    jcfg, pcfg = both_cfgs(["ep_iter", "10"] + sched)
    js, ps = jax_lr(jcfg), make_lr_schedule(pcfg)
    decay = int(float(pcfg.train.scheduler.get("decay_epochs", 3)) * 10)
    for step in (0, 1, 9, 10, 11, 20, 39, 40, 41, decay):
        np.testing.assert_allclose(ps(step), float(js(step)), rtol=1e-6,
                                   err_msg=str(step))


def _tiny_opts(root, out, exp="t", extra=()):
    return [
        "scene", "procedural", "exp_name", exp,
        "train_dataset.data_root", root, "test_dataset.data_root", root,
        "train_dataset.H", "16", "train_dataset.W", "16",
        "test_dataset.H", "16", "test_dataset.W", "16",
        "task_arg.N_rays", "64", "task_arg.N_samples", "12",
        "task_arg.N_importance", "12", "task_arg.chunk_size", "256",
        "task_arg.precrop_iters", "4",
        "network.nerf.W", "32", "network.nerf.D", "3",
        "network.nerf.skips", "[1]", "network.xyz_encoder.freq", "4",
        "network.dir_encoder.freq", "2", "ep_iter", "10",
        "log_interval", "1", "eval_ep", "100", "save_ep", "1",
        "save_latest_ep", "1",
        "trained_model_dir", os.path.join(out, "trained"),
        "trained_config_dir", os.path.join(out, "config"),
        "record_dir", os.path.join(out, "record"),
        "result_dir", os.path.join(out, "result"),
        *extra,
    ]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene_train"))
    generate_scene(root, "procedural", H=16, W=16, n_train=4, n_test=1)
    return root


def _fit(root, out, exp, extra=()):
    from nerf_replication_tpu_torch.obs import add_row_tap, remove_row_tap
    from nerf_replication_tpu_torch.train.trainer import fit

    rows = []

    def tap(row):
        if row["kind"] == "step":
            rows.append(row)

    cfg = make_cfg(LEGO, _tiny_opts(root, out, exp, extra))
    add_row_tap(tap)
    try:
        state = fit(cfg, device="cpu", log=lambda s: None)
    finally:
        remove_row_tap(tap)
    return cfg, state, rows


def test_tiny_fit_raises_psnr_and_validates(scene, tmp_path):
    cfg, state, rows = _fit(scene, str(tmp_path), "fit", [
        "train.epoch", "4", "eval_ep", "4", "network.nerf.fused_trunk",
        "true", "network.nerf.fused_tile", "64"])
    psnr = [r["stats"]["psnr"] for r in rows]
    assert state.step == 40 and len(rows) == 40
    assert np.mean(psnr[-5:]) > np.mean(psnr[:5]) + 0.5
    assert os.path.exists(os.path.join(cfg.result_dir, "summary.json"))
    assert os.path.exists(os.path.join(cfg.result_dir, "pred_0000.png"))
    assert os.path.exists(os.path.join(cfg.trained_config_dir,
                                       "train_config.yaml"))


def test_resume_equals_uninterrupted(scene, tmp_path):
    """Two epochs in one run vs one epoch, a new process state, resume for
    the second: the same losses step for step and the same weights."""
    _, whole, rows_a = _fit(scene, str(tmp_path / "a"), "r",
                            ["train.epoch", "2"])
    _, _, rows_b1 = _fit(scene, str(tmp_path / "b"), "r",
                         ["train.epoch", "1"])
    _, resumed, rows_b2 = _fit(scene, str(tmp_path / "b"), "r",
                               ["train.epoch", "2"])
    assert [r["step"] for r in rows_b1 + rows_b2] == [r["step"] for r in rows_a]
    assert [r["stats"]["loss"] for r in rows_b1 + rows_b2] == \
        [r["stats"]["loss"] for r in rows_a]
    assert resumed.step == whole.step == 20
    for (k, a), b in zip(whole.network.state_dict().items(),
                         resumed.network.state_dict().values()):
        assert torch.equal(a, b), k


def test_checkpoints_retention_and_serving_load(scene, tmp_path):
    """save_model keeps the newest KEEP_EPOCHS numbered bundles; the
    serving loader (load_network) reads a trainer checkpoint."""
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.train import checkpoint as ck
    from nerf_replication_tpu_torch.train.trainer import make_train_state

    cfg, state, _ = _fit(scene, str(tmp_path), "ck", ["train.epoch", "1"])
    d = cfg.trained_model_dir
    assert ck.has_checkpoint(d)
    for epoch in range(1, 8):
        ck.save_model(d, state, epoch, {"step": epoch})
    assert ck._available_epochs(d) == list(range(8 - ck.KEEP_EPOCHS, 8))
    net = make_network(cfg)
    assert ck.load_network(d, net) == -1  # latest.pt
    for a, b in zip(net.state_dict().values(),
                    state.network.state_dict().values()):
        assert torch.equal(a, b)
    fresh = make_train_state(cfg, make_network(cfg), "cpu")
    _, begin, rec = ck.load_model(d, fresh, epoch=5)
    assert begin == 6 and rec == {"step": 5} and fresh.step == state.step


def test_train_entry_point_runs_one_epoch(scene, tmp_path):
    out = str(tmp_path)
    opts = _tiny_opts(scene, out, "cli", ["train.epoch", "1"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "nerf_replication_tpu_torch.train",
         "--cfg_file", LEGO, "--device", "cpu", *opts],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "epoch: 0" in res.stdout
    cfg = make_cfg(LEGO, opts)
    assert os.path.exists(os.path.join(cfg.trained_model_dir, "latest.pt"))


def test_fit_refuses_later_slices(scene, tmp_path):
    """Tensor parallelism (``model_axis 2``) still raises, naming ROADMAP
    item 8 part 2; ``data_axis 2`` in one process trains on one card, as
    JAX with one device builds no mesh."""
    from nerf_replication_tpu_torch.train.trainer import fit

    cfg = make_cfg(LEGO, _tiny_opts(scene, str(tmp_path), "x",
                                    ["parallel.model_axis", "2"]))
    with pytest.raises(NotImplementedError, match="item 8 part 2"):
        fit(cfg, device="cpu")
    cfg = make_cfg(LEGO, _tiny_opts(scene, str(tmp_path), "y",
                                    ["parallel.data_axis", "2",
                                     "train.epoch", "1"]))
    state = fit(cfg, device="cpu", log=lambda s: None)
    assert state.step == 10


def test_scan_step_bursts_keep_the_numerics(scene, tmp_path):
    """scan_steps 4 runs the same steps as single steps (the same losses at
    the steps it logs), logging at burst boundaries."""
    _, a, rows_a = _fit(scene, str(tmp_path / "a"), "s1",
                        ["train.epoch", "1", "task_arg.precrop_iters", "0"])
    _, b, rows_b = _fit(scene, str(tmp_path / "b"), "s4",
                        ["train.epoch", "1", "task_arg.precrop_iters", "0",
                         "task_arg.scan_steps", "4"])
    assert a.step == b.step == 10
    assert [r["step"] for r in rows_b] == [4, 8, 10]
    assert [r["k"] for r in rows_b] == [4, 4, 2]
    by_step = {r["step"]: r["stats"]["loss"] for r in rows_a}
    assert all(r["stats"]["loss"] == by_step[r["step"]] for r in rows_b)


def test_recorder_writes_json_lines_without_tensorboard(tmp_path,
                                                       monkeypatch):
    import builtins

    from nerf_replication_tpu_torch.train.recorder import Recorder

    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kw):
        if name in ("tensorboardX", "torch.utils.tensorboard"):
            raise ImportError(name)
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    cfg = make_cfg(LEGO, ["record_dir", str(tmp_path / "rec")])
    rec = Recorder(cfg)
    rec.update_loss_stats({"loss": 0.5})
    rec.step = 3
    rec.record("train")
    rec.record("val", step=7, stats={"psnr": 21.5})
    with open(os.path.join(cfg.record_dir, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows == [{"tag": "train/loss", "value": 0.5, "step": 3},
                    {"tag": "val/psnr", "value": 21.5, "step": 7}]
    state = rec.state_dict()
    other = Recorder(cfg)
    other.load_state_dict(state)
    assert other.loss_stats["loss"].global_avg == 0.5 and other.step == 3


def test_grad_accum_averages_microbatches(scene, tmp_path):
    """grad_accum 2 runs two half batches per step; psnr is recomputed from
    the averaged mse (fix_accum_psnr)."""
    from nerf_replication_tpu_torch.train.step_core import fix_accum_psnr

    _, state, rows = _fit(scene, str(tmp_path), "ga",
                          ["train.epoch", "1", "task_arg.grad_accum", "2"])
    assert state.step == 10
    for r in rows:
        s = r["stats"]
        assert abs(s["psnr"] + 10 * np.log10(s["loss_f"])) < 1e-4
    out = fix_accum_psnr({"loss_f": torch.tensor(0.01),
                          "psnr": torch.tensor(0.0)})
    assert abs(float(out["psnr"]) - 20.0) < 1e-5
