"""Resilience of the port's training and load paths, end to end on the CPU:
the divergence rollback (lego and NGP, the restore landing in the tensors
the steps read), the SIGTERM flush and its bitwise resume, a kill inside a
save, a torn ``latest.pt`` and a torn occupancy grid falling back, the
in-place optimizer restore, and ``pretrain`` warm starts from a port
checkpoint.

A rolled-back or resumed run takes the same steps from the same state as
an uninterrupted one (the draws are reseeded from (seed, step)), so on
the CPU they compare bitwise."""

import json
import os
import signal

import numpy as np
import pytest
import torch

from test_torch_helpers import LEGO, ROOT

from nerf_replication_tpu_torch import resil
from nerf_replication_tpu_torch.config import make_cfg
from nerf_replication_tpu_torch.datasets.procedural import generate_scene
from nerf_replication_tpu_torch.obs import emit as emit_mod

LEGO_HASH = os.path.join(ROOT, "configs", "nerf", "lego_hash.yaml")


def _opts(root, out, extra=()):
    """Tiny lego: 5 steps an epoch, every step logged (so every step is a
    finite-guard check), latest.pt and a numbered checkpoint each epoch."""
    return [
        "scene", "procedural",
        "train_dataset.data_root", root, "test_dataset.data_root", root,
        "train_dataset.H", "16", "train_dataset.W", "16",
        "test_dataset.H", "16", "test_dataset.W", "16",
        "task_arg.N_rays", "64", "task_arg.N_samples", "8",
        "task_arg.N_importance", "8", "task_arg.chunk_size", "256",
        "task_arg.precrop_iters", "0",
        "network.nerf.W", "32", "network.nerf.D", "2",
        "network.nerf.skips", "[1]", "network.xyz_encoder.freq", "4",
        "network.dir_encoder.freq", "2", "ep_iter", "5", "train.epoch", "2",
        "log_interval", "1", "eval_ep", "100", "save_ep", "1",
        "save_latest_ep", "1", "skip_eval", "True",
        "trained_model_dir", os.path.join(out, "trained"),
        "trained_config_dir", os.path.join(out, "config"),
        "record_dir", os.path.join(out, "record"),
        "result_dir", os.path.join(out, "result"),
        *extra,
    ]


def _ngp_extra():
    return ["task_arg.ngp_training", "true", "task_arg.ngp_grid_res", "16",
            "task_arg.ngp_warmup_steps", "3", "task_arg.N_samples", "16",
            "task_arg.max_march_samples", "16",
            "network.xyz_encoder.log2_hashmap_size", "12"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene_resil_fit"))
    generate_scene(root, "procedural", H=16, W=16, n_train=3, n_test=1)
    return root


def _fit(root, out, extra=(), config=LEGO, **kw):
    from nerf_replication_tpu_torch.train.trainer import fit

    cfg = make_cfg(config, _opts(root, out, extra))
    return cfg, fit(cfg, device="cpu", **({"log": lambda s: None} | kw))


def _rows(cfg, kind):
    with open(os.path.join(cfg.record_dir, "telemetry.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def _assert_same_weights(a, b):
    for (k, x), y in zip(a.network.state_dict().items(),
                         b.network.state_dict().values()):
        assert torch.equal(x, y), k


@pytest.fixture(scope="module")
def whole(scene, tmp_path_factory):
    """The uninterrupted 2-epoch lego run the others are held to."""
    return _fit(scene, str(tmp_path_factory.mktemp("whole")))[1]


def test_divergence_rolls_back_in_place(scene, tmp_path, whole):
    """A NaN in epoch 1 restores the epoch-0 checkpoint INTO the tensors
    the steps read (no parameter is rebound) and the run finishes equal to
    the uninterrupted one, with the injected fault and the rollback as
    rows."""
    from nerf_replication_tpu_torch.models import make_network

    net = make_network(make_cfg(LEGO, _opts(scene, str(tmp_path))))
    ptrs = [p.data_ptr() for p in net.parameters()]
    plan = resil.FaultPlan().add("train.loss", "nan_loss", after=6)
    with resil.injecting(plan):
        cfg, state = _fit(scene, str(tmp_path), network=net)
    assert plan.injected() == 1 and state.step == 10
    assert [p.data_ptr() for p in state.network.parameters()] == ptrs
    _assert_same_weights(state, whole)
    faults = [(r["fault"], r["injected"]) for r in _rows(cfg, "fault")]
    assert faults == [("nan_loss", True), ("rollback", False)]
    # the diverged step 7 logs no row; epoch 1 runs again from step 5
    steps = [r["step"] for r in _rows(cfg, "step")]
    assert steps == list(range(1, 7)) + list(range(6, 11))


def test_divergence_without_a_checkpoint_reraises(scene, tmp_path):
    plan = resil.FaultPlan().add("train.loss", "nan_loss", after=1)
    with resil.injecting(plan):
        with pytest.raises(resil.DivergenceError):
            _fit(scene, str(tmp_path), ["save_latest_ep", "100",
                                        "save_ep", "100"])


def test_sigterm_flush_then_resume_equals_uninterrupted(scene, tmp_path,
                                                        whole):
    """A real SIGTERM mid-epoch 0: the loop stops at the next step, flushes
    latest.pt (and its checksum sidecar) with the steps of the epoch taken,
    and returns; the resumed run takes the rest and ends where the
    uninterrupted run ends, bitwise."""
    from nerf_replication_tpu_torch.train.checkpoint import load_model

    calls = []

    def preempting_log(msg):
        calls.append(msg)
        if len(calls) == 3:
            signal.raise_signal(signal.SIGTERM)

    cfg, cut = _fit(scene, str(tmp_path), log=preempting_log)
    assert any("SIGTERM" in m for m in calls) and cut.step == 3
    latest = os.path.join(cfg.trained_model_dir, "latest.pt")
    assert resil.verify_checksum(latest) is True
    blob = torch.load(latest, weights_only=True)
    assert (blob["step"], blob["epoch"], blob["epoch_it"]) == (3, -1, 3)
    handler = signal.getsignal(signal.SIGTERM)  # the guard is gone again
    assert not isinstance(getattr(handler, "__self__", None),
                          resil.PreemptionGuard)
    probe = make_cfg(LEGO, _opts(scene, str(tmp_path)))
    from nerf_replication_tpu_torch.train.trainer import make_train_state
    from nerf_replication_tpu_torch.models import make_network

    restored, begin, _ = load_model(
        cfg.trained_model_dir,
        make_train_state(probe, make_network(probe), "cpu"))
    assert (begin, restored.step, restored.epoch_it) == (0, 3, 3)
    _assert_same_weights(restored, cut)
    _, resumed = _fit(scene, str(tmp_path))
    assert resumed.step == 10
    _assert_same_weights(resumed, whole)


@pytest.mark.parametrize("kill_point", ["checkpoint.save",
                                        "checkpoint.save.sidecar"])
def test_kill_during_a_save_then_resume_completes(scene, tmp_path,
                                                  kill_point, whole):
    plan = resil.FaultPlan().add(kill_point, "kill", after=1, times=1)
    with resil.injecting(plan):
        with pytest.raises(resil.SimulatedKill):
            _fit(scene, str(tmp_path))
    assert plan.injected() == 1
    _, state = _fit(scene, str(tmp_path))
    assert state.step == 10
    _assert_same_weights(state, whole)


def test_torn_latest_falls_back_to_the_numbered_checkpoint(scene, tmp_path,
                                                           monkeypatch):
    from nerf_replication_tpu_torch.train.checkpoint import (
        load_model,
        load_network,
    )
    from nerf_replication_tpu_torch.train.trainer import make_train_state
    from nerf_replication_tpu_torch.models import make_network

    cfg, _ = _fit(scene, str(tmp_path), ["train.epoch", "1"])
    latest = os.path.join(cfg.trained_model_dir, "latest.pt")
    with open(latest, "r+b") as fh:
        fh.truncate(os.path.getsize(latest) // 2)
    telem = str(tmp_path / "t.jsonl")
    em = emit_mod.Emitter(telem)
    monkeypatch.setattr(emit_mod, "_active", em)
    state, begin, _ = load_model(
        cfg.trained_model_dir,
        make_train_state(cfg, make_network(cfg), "cpu"))
    assert (begin, state.step) == (1, 5)
    assert load_network(cfg.trained_model_dir, make_network(cfg)) == 0
    em.close()
    with open(telem) as f:
        faults = [r for r in map(json.loads, f) if r["kind"] == "fault"]
    assert [(r["point"], r["fault"], os.path.basename(r["path"]))
            for r in faults] == [("checkpoint.load", "torn", "latest.pt")] * 2


def test_optimizer_state_loads_in_place():
    """load_optimizer_state fills the optimizer's own tensors (what a
    captured step reads) with what load_state_dict would give."""
    from nerf_replication_tpu_torch.train.checkpoint import (
        load_optimizer_state,
    )

    torch.manual_seed(0)
    w = torch.nn.Parameter(torch.randn(4, 3))
    opt = torch.optim.Adam([w], lr=torch.tensor(1e-2, dtype=torch.float64))
    w.grad = torch.randn(4, 3)
    opt.step()
    saved = {k: v for k, v in opt.state_dict().items()}
    saved = torch.load(_roundtrip(saved), weights_only=True)
    ptrs = {k: v.data_ptr() for k, v in opt.state[w].items()}
    w.grad = torch.randn(4, 3)
    opt.step()
    load_optimizer_state(opt, saved)
    assert {k: v.data_ptr() for k, v in opt.state[w].items()} == ptrs
    for k, v in saved["state"][0].items():
        assert torch.equal(opt.state[w][k], v), k


def _roundtrip(obj):
    import io

    buf = io.BytesIO()
    torch.save(obj, buf)
    buf.seek(0)
    return buf


def test_torn_occupancy_grid_falls_back(scene, tmp_path, monkeypatch,
                                        capsys):
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.renderer.occupancy import (
        load_occupancy_pyramid,
        save_occupancy_grid,
    )
    from nerf_replication_tpu_torch.renderer.volume import make_renderer

    telem = str(tmp_path / "t.jsonl")
    em = emit_mod.Emitter(telem)
    monkeypatch.setattr(emit_mod, "_active", em)
    path = str(tmp_path / "grid.npz")
    grid = np.zeros((16, 16, 16), bool)
    grid[2:9, 3:11, 4:12] = True
    save_occupancy_grid(path, grid, [[-1.5] * 3, [1.5] * 3], 1.0)
    assert np.array_equal(load_occupancy_pyramid(path)[0][0], grid)
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) // 2)
    with pytest.raises(OSError):
        load_occupancy_pyramid(path)
    cfg = make_cfg(LEGO, _opts(scene, str(tmp_path)))
    renderer = make_renderer(cfg, make_network(cfg))
    assert renderer.load_occupancy_grid(path) is False
    assert renderer.occupancy_grid is None
    assert "slow mode" in capsys.readouterr().out
    em.close()
    with open(telem) as f:
        faults = [r for r in map(json.loads, f) if r["kind"] == "fault"]
    assert [(r["point"], r["fault"]) for r in faults] == [
        ("occupancy.load", "checksum")] * 2


def test_pretrain_warm_start_from_a_port_checkpoint(scene, tmp_path, whole):
    """``pretrain`` names a port checkpoint dir: a fresh run starts from its
    weights (0 epochs: the loaded weights come back as they are). A JAX
    Orbax directory is refused, naming the converter."""
    from nerf_replication_tpu_torch.train.checkpoint import save_pretrain

    pre = str(tmp_path / "pre")
    save_pretrain(pre, whole.network)
    _, state = _fit(scene, str(tmp_path / "b"),
                    ["pretrain", pre, "train.epoch", "0"])
    assert state.step == 0
    _assert_same_weights(state, whole)
    orbax = tmp_path / "orbax"
    (orbax / "pretrain").mkdir(parents=True)
    with pytest.raises(ValueError, match="convert.params_from_jax"):
        _fit(scene, str(tmp_path / "c"), ["pretrain", str(orbax)])


def test_ngp_rollback_restores_grid_ema(scene, tmp_path):
    """A NaN in NGP epoch 1 restores the epoch-0 bundle — weights, Adam
    state, grid_ema (in place) and the phase sidecar — and the run ends
    equal to an uninterrupted one."""
    _, ref = _fit(scene, str(tmp_path / "w"), _ngp_extra(), LEGO_HASH)
    plan = resil.FaultPlan().add("train.loss", "nan_loss", after=7)
    with resil.injecting(plan):
        cfg, state = _fit(scene, str(tmp_path / "r"), _ngp_extra(),
                          LEGO_HASH)
    assert plan.injected() == 1 and state.step == 10
    assert torch.equal(state.grid_ema, ref.grid_ema)
    _assert_same_weights(state, ref)
    assert [r["fault"] for r in _rows(cfg, "fault")] == ["nan_loss",
                                                         "rollback"]
    with open(os.path.join(cfg.trained_model_dir, "latest_phase.json")) as f:
        assert json.load(f)["host_step"] == 10
