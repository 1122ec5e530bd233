"""Port parity of the NGP trainer (``train/ngp.py``): one step's pieces
against the JAX package on the same weights and inputs, the trainer's three
recorded behaviours, resume, the CLI, and lego_hash through the ordinary
trainer and the eval CLI.

* March-phase loss (per-ray and packed) and its gradients through JAX
  ``march_rays_accelerated`` / ``march_rays_packed`` with ``network.apply``
  inside ``jax.jit(jax.value_and_grad(...))``: loss within 1e-6, every
  gradient within 1e-4 of its tensor's max |grad| (float32 sums in another
  order, through a [N, K] compositing chain).
* Warm-phase loss on the same depths: the same bounds.
* Grid update with the same sampled sigmas, cells ``idx`` and jitter ``u``
  against a numpy statement of ngp.py:486-532 (the refresh sigmas from the
  JAX network): within 1e-6 of max|ema|.
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

from test_torch_helpers import (
    BBOX,
    ROOT,
    box_grid,
    both_cfgs,
    jax_tree_numpy,
    nets,
)

from nerf_replication_tpu_torch.config import make_cfg
from nerf_replication_tpu_torch.datasets.procedural import generate_scene

LEGO_HASH = os.path.join(ROOT, "configs", "nerf", "lego_hash.yaml")
SMALL_HASH = [
    "network.xyz_encoder.num_levels", "4",
    "network.xyz_encoder.log2_hashmap_size", "10",
    "network.xyz_encoder.desired_resolution", "64",
    "network.nerf.W", "32", "network.nerf.D", "2",
    "network.dir_encoder.freq", "2",
]
STEP = SMALL_HASH + [
    "network.xyz_encoder.type", "hashgrid",
    "network.xyz_encoder.bbox", "[[-1.5,-1.5,-1.5],[1.5,1.5,1.5]]",
    "network.nerf.skips", "[1]", "network.dir_encoder.type", "frequency",
    "task_arg.render_step_size", "0.08", "task_arg.max_march_samples", "24",
    "task_arg.ngp_grid_res", "16", "task_arg.ngp_packed_cap_avg", "12",
]


def _rays(n=48, seed=3):
    rng = np.random.default_rng(seed)
    o = np.tile([0.0, 0.0, 4.0], (n, 1)) + rng.normal(0, 0.1, (n, 3))
    d = np.array([0.0, 0.0, -1.0]) + rng.normal(0, 0.2, (n, 3))
    rays = np.concatenate([o, d], -1).astype(np.float32)
    return rays, rng.uniform(0, 1, (n, 3)).astype(np.float32)


def _pair(extra=()):
    """(JAX network, JAX params, port trainer over the same weights, JAX
    cfg). The table is uniform in ±1 and the fine density bias 2, so the
    field is dense enough for its gradients to be well conditioned."""
    from nerf_replication_tpu_torch.convert import params_from_jax
    from nerf_replication_tpu_torch.train.ngp import NGPTrainer

    opts = STEP + list(extra)
    jnet, params, pnet = nets(extra=opts)
    tree = jax_tree_numpy(params)
    emb = tree["params"]["xyz_encoder"]["embeddings"]
    tree["params"]["xyz_encoder"]["embeddings"] = np.random.default_rng(
        11).uniform(-1, 1, emb.shape).astype(np.float32)
    tree["params"]["fine"]["alpha_linear"]["bias"] = np.full(
        (1,), 2.0, np.float32)
    pnet.load_state_dict(params_from_jax(tree), strict=True)
    jcfg, pcfg = both_cfgs(opts)
    return jnet, jax.tree.map(jnp.asarray, tree), NGPTrainer(pcfg, pnet), \
        jcfg


def _grads_close(pnet, jgrads, rel=1e-4):
    pairs = [(pnet.xyz_encoder.embeddings.grad,
              jgrads["xyz_encoder"]["embeddings"])]
    for name, leaf in jgrads["fine"].items():
        mod = getattr(pnet.fine, name)
        pairs += [(mod.weight.grad.T, leaf["kernel"]),
                  (mod.bias.grad, leaf["bias"])]
    for a, b in pairs:
        b = np.asarray(b)
        assert np.abs(a.detach().numpy() - b).max() <= rel * max(
            np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("packed", [False, True])
def test_march_loss_and_grads_match_jax(packed):
    from nerf_replication_tpu.renderer.accelerated import (
        MarchOptions,
        march_rays_accelerated,
    )
    from nerf_replication_tpu.renderer.packed_march import march_rays_packed

    extra = ["task_arg.ngp_packed_march", str(packed).lower()]
    jnet, params, trainer, jcfg = _pair(extra)
    rays, rgbs = _rays()
    grid = box_grid(16)
    opts = MarchOptions.from_cfg(jcfg)

    def loss_fn(p, r, target, occ, bbox):
        apply_fn = lambda pts, d, m: jnet.apply(  # noqa: E731
            {"params": p}, pts, d, model=m)
        args = (apply_fn, r, 2.0, 6.0, occ, bbox, opts)
        out = (march_rays_packed(*args, cap_avg=12, return_samples=True)
               if packed else march_rays_accelerated(*args,
                                                     return_samples=True))
        w = 1.0 - out["truncated"].astype(jnp.float32)
        per_ray = jnp.mean((out["rgb_map_f"] - target) ** 2, -1)
        return jnp.sum(per_ray * w) / jnp.maximum(jnp.sum(w), 1.0), out

    # inputs as arguments, as the trainer's are (XLA would fold constants)
    (jl, jout), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params["params"], jnp.asarray(rays), jnp.asarray(rgbs),
        jnp.asarray(grid), jnp.asarray(BBOX))
    loss, out, stats = trainer.march_loss(torch.from_numpy(rays),
                                          torch.from_numpy(rgbs),
                                          torch.from_numpy(grid))
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-6
    assert int(out["truncated"].sum()) == int(jnp.sum(jout["truncated"]))
    assert float(stats["occupancy"]) == pytest.approx(float(grid.mean()))
    np.testing.assert_array_equal(out["sample_flat"].numpy(),
                                  np.asarray(jout["sample_flat"]))
    np.testing.assert_allclose(out["sample_sigma"].numpy(),
                               np.asarray(jout["sample_sigma"]), rtol=0,
                               atol=1e-5)
    _grads_close(trainer.network, jax.tree.map(np.asarray, jg))
    if packed:
        assert float(stats["overflow_frac"]) == pytest.approx(
            float(jout["overflow_frac"]), abs=1e-7)


def test_warm_loss_matches_jax():
    """Warm phase: stratified rendering of the fine net at fixed depths,
    loss and gradients as JAX's loss_fn_warm, and the same sampled voxel
    ids, sigmas and in-bbox mask for the grid."""
    from nerf_replication_tpu.renderer.accelerated import world_to_voxel
    from nerf_replication_tpu.renderer.volume import raw2outputs

    jnet, params, trainer, _ = _pair()
    rays, rgbs = _rays()
    z = np.sort(np.random.default_rng(5).uniform(2.0, 6.0, (48, 16)),
                -1).astype(np.float32)
    grid = np.ones((16, 16, 16), bool)
    bbox = jnp.asarray(BBOX)

    def loss_fn(p, r, zz, target, bbox):
        ro, rd = r[:, 0:3], r[:, 3:6]
        pts = ro[:, None, :] + rd[:, None, :] * zz[..., None]
        vd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
        raw = jnet.apply({"params": p}, pts, vd, model="fine")
        rgb, _, _, _ = raw2outputs(raw, zz, rd, white_bkgd=True)
        vox = world_to_voxel(pts, bbox, 16)
        flat = (vox[..., 0] * 16 + vox[..., 1]) * 16 + vox[..., 2]
        inb = jnp.all((pts >= bbox[0]) & (pts <= bbox[1]), -1)
        return jnp.mean((rgb - target) ** 2), (
            flat, jax.nn.relu(raw[..., 3]), inb)

    (jl, (jflat, jsig, jin)), jg = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
            params["params"], jnp.asarray(rays), jnp.asarray(z),
            jnp.asarray(rgbs), bbox)
    loss, out, _ = trainer.warm_loss(torch.from_numpy(rays),
                                     torch.from_numpy(rgbs),
                                     torch.from_numpy(z),
                                     torch.from_numpy(grid))
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-6
    np.testing.assert_array_equal(out["sample_flat"].numpy(),
                                  np.asarray(jflat))
    np.testing.assert_array_equal(out["sample_valid"].numpy(),
                                  np.asarray(jin).astype(np.float32))
    np.testing.assert_allclose(out["sample_sigma"].numpy(), np.asarray(jsig),
                               rtol=0, atol=1e-5)
    _grads_close(trainer.network, jax.tree.map(np.asarray, jg))


def test_grid_update_matches_a_numpy_statement():
    """Decay, the strided scatter-max of the sampled sigmas (cap 50 of 300
    rows: stride 6) and the refresh of cells ``idx`` at jitter ``u``, the
    refresh sigmas from the JAX network on the numpy points."""
    jnet, params, trainer, _ = _pair(["task_arg.ngp_sample_update_cap",
                                      "50"])
    res = trainer.grid_res
    rng = np.random.default_rng(8)
    ema0 = rng.uniform(0, 3, (res,) * 3).astype(np.float32)
    flat = rng.integers(0, res**3, 300).astype(np.int32)
    sigma = rng.uniform(0, 5, 300).astype(np.float32)
    valid = (rng.random(300) < 0.7).astype(np.float32)
    n = trainer.cells_per_step
    idx = rng.integers(0, res**3, n)
    u = rng.uniform(0, 1, (n, 3)).astype(np.float32)

    ema = ema0.reshape(-1) * np.float32(trainer.decay_step)
    s_flat, s_sig = flat[::6], (sigma * valid)[::6]
    np.maximum.at(ema, s_flat, s_sig)
    cell = np.stack([idx // (res * res), (idx // res) % res, idx % res],
                    -1).astype(np.float32)
    pts = BBOX[0] + (cell + u) / np.float32(res) * (BBOX[1] - BBOX[0])
    raw = jnet.apply(params, jnp.asarray(pts[:, None, :]),
                     jnp.zeros((n, 3)), model="fine")
    np.maximum.at(ema, idx, np.maximum(np.asarray(raw)[:, 0, 3], 0.0))

    out = {"sample_flat": torch.from_numpy(flat),
           "sample_sigma": torch.from_numpy(sigma),
           "sample_valid": torch.from_numpy(valid)}
    got = trainer.grid_update(torch.from_numpy(ema0), out,
                              torch.from_numpy(idx), torch.from_numpy(u))
    assert tuple(got.shape) == (res,) * 3
    np.testing.assert_allclose(got.numpy().reshape(-1), ema, rtol=0,
                               atol=1e-6 * np.abs(ema).max())


def test_truncated_rays_are_masked_out_of_the_march_loss():
    """A 2-sample budget truncates every ray through the occupied box: the
    loss is the mean over the others only, and the truncated rays' targets
    do not move it."""
    _, _, trainer, _ = _pair(["task_arg.max_march_samples", "2"])
    rays, rgbs = _rays()
    grid = torch.from_numpy(box_grid(16))  # some rays miss the box
    loss, out, stats = trainer.march_loss(torch.from_numpy(rays),
                                          torch.from_numpy(rgbs), grid)
    trunc = out["truncated"].numpy()
    assert 0 < trunc.sum() < len(trunc)
    per_ray = ((out["rgb_map_f"].detach().numpy() - rgbs) ** 2).mean(-1)
    assert float(loss.detach()) == pytest.approx(per_ray[~trunc].mean(),
                                                 rel=1e-6)
    assert float(stats["truncated_frac"]) == pytest.approx(trunc.mean())
    moved = rgbs.copy()
    moved[trunc] = 1.0 - moved[trunc]
    again, _, _ = trainer.march_loss(torch.from_numpy(rays),
                                     torch.from_numpy(moved), grid)
    assert float(again.detach()) == float(loss.detach())


def _phase_trace(trainer, state, occs):
    """The warm flag of single-step bursts, the stub step reporting the
    given occupancies (grid maintenance is not what is tested here)."""
    flags = []

    def stub(st, br, bg, warm):
        st.step += 1
        return {"occupancy": torch.tensor(occs[len(flags)]),
                "truncated_frac": torch.tensor(0.0)}

    trainer._one_step = stub
    for _ in occs:
        state, _ = trainer.multi_step(state, None, None, 1)
        flags.append(trainer.last_burst_warm)
    return flags


def test_warmup_exit_is_occupancy_gated():
    """Warm for the mandatory ngp_warmup_steps, then as long as occupancy
    stays above ngp_warmup_exit_occ — within a cumulative ngp_warmup_max —
    and again when the grid re-densifies; a resumed trainer without a phase
    sidecar estimates its warm steps from the restored grid."""
    from nerf_replication_tpu_torch.train.ngp import NGPState

    extra = ["task_arg.ngp_warmup_steps", "2", "task_arg.ngp_warmup_max",
             "6", "task_arg.ngp_warmup_exit_occ", "0.6"]
    _, _, trainer, _ = _pair(extra)
    grid = trainer.init_grid("cpu")
    state = NGPState(trainer.network, None, None, 0, grid)
    # dense: warm until the cumulative cap of 6
    assert _phase_trace(trainer, state, [1.0] * 8) == [True] * 6 + [False] * 2
    # carves after the mandatory 2, re-densifies, carves again
    _, _, trainer, _ = _pair(extra)
    state = NGPState(trainer.network, None, None, 0, grid)
    occs = [0.9, 0.3, 0.3, 0.9, 0.9, 0.3, 0.3]
    assert _phase_trace(trainer, state, occs) == \
        [True, True, False, False, True, True, False]
    assert trainer.phase_state()["warm_steps_total"] == 4
    # resumed at step 10 over a dense grid: every prior step counted warm
    _, _, trainer, _ = _pair(extra)
    state = NGPState(trainer.network, None, None, 10, grid)
    assert _phase_trace(trainer, state, [1.0]) == [False]
    assert trainer.phase_state()["warm_steps_total"] == 6


def test_density_threshold_follows_the_bake_convention():
    """The grid threshold is task_arg.occupancy_grid_threshold (σ = 1.0 in
    lego.yaml), as in the JAX trainer, unless ngp_density_threshold pins
    it; the warm start sits at warm_factor × threshold, and a field of
    σ = 0.5 reads as empty."""
    from nerf_replication_tpu.train.ngp import NGPTrainer as JaxTrainer

    jnet, _, trainer, jcfg = _pair()
    assert trainer.threshold == 1.0 == JaxTrainer(jcfg, jnet).threshold
    assert float(trainer.init_grid("cpu").max()) == 2.0
    assert float((torch.full((4,), 0.5) > trainer.threshold).float().mean()) \
        == 0.0
    _, _, pinned, _ = _pair(["task_arg.ngp_density_threshold", "0.01"])
    assert pinned.threshold == 0.01


def _ngp_opts(root, out, extra=()):
    return [
        "scene", "procedural", "exp_name", "ngp",
        "train_dataset.data_root", root, "test_dataset.data_root", root,
        "train_dataset.H", "16", "train_dataset.W", "16",
        "test_dataset.H", "16", "test_dataset.W", "16",
        "task_arg.N_rays", "64", "task_arg.render_step_size", "0.08",
        "task_arg.max_march_samples", "24",
        "task_arg.eval_render_step_size", "0.08",
        "task_arg.eval_max_march_samples", "24",
        "task_arg.march_chunk_size", "128", "task_arg.ngp_grid_res", "16",
        "task_arg.ngp_training", "true", "task_arg.ngp_warmup_steps", "4",
        "task_arg.ngp_warmup_max", "4", "task_arg.ngp_warmup_samples", "16",
        *SMALL_HASH,
        "ep_iter", "5", "log_interval", "1", "eval_ep", "100",
        "save_ep", "1", "save_latest_ep", "1",
        "trained_model_dir", os.path.join(out, "trained"),
        "trained_config_dir", os.path.join(out, "config"),
        "record_dir", os.path.join(out, "record"),
        "result_dir", os.path.join(out, "result"),
        *extra,
    ]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene_ngp"))
    generate_scene(root, "procedural", H=16, W=16, n_train=4, n_test=1)
    return root


def _fit(root, out, extra):
    """A CPU fit and its ``step`` telemetry rows (read through a row tap)."""
    from nerf_replication_tpu_torch.obs import add_row_tap, remove_row_tap
    from nerf_replication_tpu_torch.train.trainer import fit

    rows = []

    def tap(row):
        if row["kind"] == "step":
            rows.append(row)

    cfg = make_cfg(LEGO_HASH, _ngp_opts(root, out, extra))
    add_row_tap(tap)
    try:
        state = fit(cfg, device="cpu", log=lambda s: None)
    finally:
        remove_row_tap(tap)
    return cfg, state, rows


@pytest.mark.parametrize("packed", [False, True])
def test_resume_equals_uninterrupted(scene, tmp_path, packed):
    """Two epochs (warm, then march) in one run vs one epoch, a new trainer
    resumed from latest.pt (weights, Adam moments, grid_ema) and its phase
    sidecar: the same losses step for step, the same weights and grid,
    bitwise on the CPU (on the card K6b's atomics reorder the table
    gradient's float32 sums, so a resume agrees within a tolerance)."""
    extra = ["task_arg.ngp_packed_march", str(packed).lower()]
    _, whole, rows_a = _fit(scene, str(tmp_path / "a"),
                            extra + ["train.epoch", "2"])
    _, _, rows_b1 = _fit(scene, str(tmp_path / "b"),
                         extra + ["train.epoch", "1"])
    cfg, resumed, rows_b2 = _fit(scene, str(tmp_path / "b"),
                                 extra + ["train.epoch", "2"])
    assert [r["stats"]["warm"] for r in rows_a] == [True] * 4 + [False] * 6
    assert [(r["step"], r["stats"]["warm"], r["stats"]["loss"])
            for r in rows_b1 + rows_b2] == \
        [(r["step"], r["stats"]["warm"], r["stats"]["loss"]) for r in rows_a]
    assert torch.equal(whole.grid_ema, resumed.grid_ema)
    for (k, a), b in zip(whole.network.state_dict().items(),
                         resumed.network.state_dict().values()):
        assert torch.equal(a, b), k
    with open(os.path.join(cfg.trained_model_dir, "0_phase.json")) as f:
        assert json.load(f)["host_step"] == 5


def test_cli_trains_saves_the_grid_evaluates_and_resumes(scene, tmp_path):
    """``python -m nerf_replication_tpu_torch.train --device cpu`` with
    ngp_training: one epoch with validation, a checkpoint carrying
    grid_ema and its phase sidecar, then a second invocation resumes."""
    out = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    base = [sys.executable, "-m", "nerf_replication_tpu_torch.train",
            "--cfg_file", LEGO_HASH, "--device", "cpu"]
    res = subprocess.run(
        base + _ngp_opts(scene, out, ["train.epoch", "1", "eval_ep", "1"]),
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "ngp val: psnr" in res.stdout and "epoch: 0" in res.stdout
    cfg = make_cfg(LEGO_HASH, _ngp_opts(scene, out))
    blob = torch.load(os.path.join(cfg.trained_model_dir, "latest.pt"),
                      weights_only=True)
    assert tuple(blob["grid_ema"].shape) == (16, 16, 16)
    assert blob["step"] == 5
    assert os.path.exists(os.path.join(cfg.trained_model_dir,
                                       "latest_phase.json"))
    res = subprocess.run(base + _ngp_opts(scene, out, ["train.epoch", "2"]),
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "epoch: 1" in res.stdout and "epoch: 0" not in res.stdout
    assert torch.load(os.path.join(cfg.trained_model_dir, "latest.pt"),
                      weights_only=True)["step"] == 10


def test_lego_hash_ordinary_trainer_and_eval_cli(scene, tmp_path,
                                                 monkeypatch):
    """lego_hash without ngp_training trains through the coarse+fine
    trainer (the hash encoder shared by both MLPs); the bake CLI, ``run
    --type evaluate`` and ``train --test`` then work on its checkpoint with
    no NGP code."""
    from types import SimpleNamespace

    from nerf_replication_tpu_torch import occupancy_grid
    from nerf_replication_tpu_torch.run import run_evaluate

    opts = _ngp_opts(scene, str(tmp_path))
    opts[opts.index("task_arg.ngp_training") + 1] = "false"
    opts += ["task_arg.N_samples", "8", "task_arg.N_importance", "8",
             "task_arg.precrop_iters", "0", "train.epoch", "1",
             "task_arg.occupancy_grid_res", "16"]
    cfg = make_cfg(LEGO_HASH, opts)
    from nerf_replication_tpu_torch.train.trainer import fit

    state = fit(cfg, device="cpu", log=lambda s: None)
    assert state.step == 5
    assert state.network.xyz_encoder.embeddings.grad is not None
    monkeypatch.chdir(tmp_path)
    assert occupancy_grid.main(["--cfg_file", LEGO_HASH, "--device", "cpu",
                                *opts]) == 0
    res = run_evaluate(cfg, SimpleNamespace(cfg_file=LEGO_HASH,
                                            device="cpu"))
    assert res["used_grid"] and res["n_images"] == 1
    assert np.isfinite(res["psnr"])
    from nerf_replication_tpu_torch.train.__main__ import main as train_main

    assert train_main(["--cfg_file", LEGO_HASH, "--device", "cpu", "--test",
                       *opts]) == 0
    with open(os.path.join(cfg.result_dir, "summary.json")) as f:
        assert json.load(f)["psnr"] == pytest.approx(res["psnr"])


def test_adam_and_schedule_of_lego_hash_match_optax():
    """lego_hash's optimizer (lr 1e-2, eps 1e-15, exponential schedule
    gamma 0.33 over decay_epochs 500) on the same gradients as optax, the
    table one more Adam parameter: parameters within 3e-5·lr after each of
    two steps (optax takes the bias corrections 1 − β^t in float32, off by
    up to 5e-5 relative at t = 1; torch in float64: measured 1.8e-7 at lr
    1e-2), lr within 1e-6 relative."""
    import optax

    from nerf_replication_tpu.train.optim import make_optimizer as jax_opt
    from nerf_replication_tpu_torch.train.optim import (
        apply_update,
        make_optimizer,
    )

    from nerf_replication_tpu.config import make_cfg as jax_make_cfg

    jcfg = jax_make_cfg(LEGO_HASH, ["ep_iter", "10"])
    pcfg = make_cfg(LEGO_HASH, ["ep_iter", "10"])
    assert float(pcfg.train.eps) == 1e-15 and float(pcfg.train.lr) == 1e-2
    tx, jsched = jax_opt(jcfg)
    rng = np.random.default_rng(9)
    params = {"table": rng.uniform(-1e-4, 1e-4, (64, 2)).astype(np.float32),
              "w": rng.normal(0, 0.1, (8, 4)).astype(np.float32)}
    grads = [{k: rng.normal(0, 1, v.shape).astype(np.float32) * 1e-3
              for k, v in params.items()} for _ in range(2)]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt, sched = make_optimizer(pcfg, tp.values())
    for count, g in enumerate(grads):
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in g.items():
            tp[k].grad = torch.from_numpy(v.copy())
        apply_update(opt, sched, count)
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0,
                                       atol=3e-5 * 1e-2)
    for step in (0, 1, 10, 5000, 12345):
        assert sched(step) == pytest.approx(float(jsched(step)), rel=1e-6)


def test_eval_render_cap_derivation_escalation_and_refusals(scene, tmp_path):
    """The packed eval cap is derived once from a carved grid's occupancy
    and doubles when a render overflows it; march_fused full (the
    frequency-only mega-kernel) is refused on the NGP eval; tensor
    parallelism names ROADMAP item 8 part 2 and an NGP batch the world size
    does not divide raises; load_trained_network defaults to the card and
    refuses silently serving from the CPU."""
    from nerf_replication_tpu_torch.datasets import make_dataset
    from nerf_replication_tpu_torch.train.ngp import NGPTrainer, fit_ngp
    from nerf_replication_tpu_torch.utils.setup import load_trained_network

    cfg = make_cfg(LEGO_HASH, _ngp_opts(scene, str(tmp_path), [
        "task_arg.ngp_packed_march", "true",
        "task_arg.ngp_packed_cap_avg", "2"]))
    from nerf_replication_tpu_torch.models import make_network

    trainer = NGPTrainer(cfg, make_network(cfg))
    state = trainer.make_state("cpu")
    assert trainer.packed_cap_avg_eval == 1024
    carved = torch.zeros((16,) * 3, dtype=torch.bool)
    carved[:8] = True  # 50% occupied
    assert trainer.maybe_derive_eval_cap(carved)
    assert trainer.packed_cap_avg_eval == 64  # 0.5 x 24 x 1.5 = 18 -> 64
    assert not trainer.maybe_derive_eval_cap(carved)  # once only
    trainer.packed_cap_avg_eval = 1  # a dense grid overflows one per ray
    batch = make_dataset(cfg, "test").image_batch(0)
    with torch.no_grad():
        out = trainer.render_image(state,
                                   {"rays": torch.from_numpy(batch["rays"])})
    assert trainer.packed_cap_avg_eval > 1
    assert out["rgb_map_f"].shape == (256, 3)
    assert torch.isfinite(out["rgb_map_f"]).all()

    full = make_cfg(LEGO_HASH, _ngp_opts(scene, str(tmp_path), [
        "task_arg.march_fused", "full"]))
    trainer = NGPTrainer(full, make_network(full))
    with pytest.raises(ValueError, match="march_fused='full'"):
        trainer.render_image(trainer.make_state("cpu"),
                             {"rays": torch.from_numpy(batch["rays"])})
    with pytest.raises(NotImplementedError, match="item 8 part 2"):
        fit_ngp(make_cfg(LEGO_HASH, _ngp_opts(scene, str(tmp_path), [
            "parallel.model_axis", "2"])), device="cpu")
    from nerf_replication_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="N_rays=64 must divide"):
        NGPTrainer(cfg, make_network(cfg),
                   mesh=Mesh(None, 0, 3, torch.device("cpu"), "gloo"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_trained_network(cfg, verbose=False)
    net, epoch = load_trained_network(cfg, "cpu", verbose=False)
    assert epoch == -1 and not net.training
