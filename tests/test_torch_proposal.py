"""Port parity of the proposal-sampling path (``sampling.mode: proposal``):
the ``ProposalMLP`` branch, the proposal render, its loss and gradients, one
Adam step, the packed proposal march, the renderer's eval route, the serving
engine's ``proposal`` tier (and its remap on a coarse+fine checkpoint), and a
CPU fit with resume — each against the JAX package on the same seeded inputs
and the same weights (``params_from_jax``), at lego_proposal.yaml's branch
sizes with a small NeRF trunk (D=4, W=32) and 32 / 24 samples.

Parity runs deterministic paths: ``perturb 0`` (det resampling), and the
anneal at fixed steps (None, 0, anneal_iters / 2, past anneal_iters).
Tolerances: the proposal density atol 1e-5 (bf16 2e-2: bf16 activations in
both frameworks); histograms atol 1e-6 and resampled edges atol 4e-6 (a few
ulps of depths up to 6, XLA's cumsum associates differently); maps atol
1e-5, depth 1e-4 (the resampled depths inherit the histogram's ulps). A
sharp histogram (eval, or the anneal done) carries the cdfs' rounding
difference through its flat bins' steep inverse CDF (test_torch_sampling):
measured resampled depths 9.1e-6 apart, fine weights 2.9e-5, maps 2.9e-5
(depth 1.2e-4), so there edges are held to 2e-5, fine weights and maps to
5e-5 (depth 5e-4). The loss rtol 1e-5 and each gradient within 1e-3 of
its tensor's largest |value| (as the coarse+fine step test); parameters
after one Adam step within 2·lr of JAX's and 99.9% of them within 1e-6."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (
    BBOX,
    FAR,
    NEAR,
    ROOT,
    SMALL_NET,
    jax_tree_numpy,
    nets,
    sample_rays,
)

from nerf_replication_tpu.config import make_cfg as jax_make_cfg
from nerf_replication_tpu.models import make_network as jax_make_network
from nerf_replication_tpu.models.nerf.network import (
    init_params as jax_init_params,
)
from nerf_replication_tpu.renderer import volume as jv
from nerf_replication_tpu_torch.config import make_cfg
from nerf_replication_tpu_torch.convert import params_from_jax
from nerf_replication_tpu_torch.models import make_network
from nerf_replication_tpu_torch.renderer import volume as pv

PROP = os.path.join(ROOT, "configs", "nerf", "lego_proposal.yaml")
OPTS = SMALL_NET + ["task_arg.perturb", "0", "sampling.n_proposal", "32",
                    "sampling.n_fine", "24", "network.nerf.fused_tile", "64"]
MARCH = ["task_arg.render_step_size", "0.0625",
         "task_arg.max_march_samples", "24",
         "task_arg.march_chunk_size", "32"]


def _cfgs(extra=()):
    opts = OPTS + list(extra)
    return jax_make_cfg(PROP, opts), make_cfg(PROP, opts)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def weights():
    """(JAX network, JAX params, port network): JAX's init with biases drawn
    from a seed, so the densities are not all near zero."""
    jcfg, pcfg = _cfgs()
    jnet = jax_make_network(jcfg)
    tree = jax_tree_numpy(jax_init_params(jnet, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    for layers in tree["params"].values():
        for leaf in layers.values():
            leaf["bias"] = rng.normal(0, 0.3, leaf["bias"].shape).astype(
                np.float32)
    pnet = make_network(pcfg)
    pnet.load_state_dict(params_from_jax(tree), strict=True)
    return jnet, jax.tree.map(jnp.asarray, tree), pnet


def _grid(res=16):
    c = (np.arange(res) + 0.5) / res * 2.0 - 1.0
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    g = (x * x + y * y + z * z) < 0.6 ** 2
    return g | (np.random.default_rng(1).random(g.shape) < 0.1)


def _assert_maps(out, ref, keys=("rgb_map_f", "acc_map_f", "depth_map_f"),
                 sharp=False):
    for k in keys:
        atol = 5e-5 if sharp else 1e-5
        atol *= 10 if k.startswith("depth") else 1
        np.testing.assert_allclose(np.asarray(out[k]), np.asarray(ref[k]),
                                   rtol=0, atol=atol, err_msg=k)


# -- the network branch ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_proposal_mlp_matches_flax(weights, dtype):
    jnet, params, pnet = weights
    pts = np.random.default_rng(2).normal(0, 1.5, (5, 11, 3)).astype(
        np.float32)
    ref = jnet.clone(compute_dtype=jnp.dtype(dtype)).apply(
        params, jnp.asarray(pts), None, model="proposal")
    with torch.no_grad():
        out = pnet.clone(getattr(torch, dtype))(_t(pts), None,
                                                model="proposal")
    assert out.shape == (5, 11, 1) and out.dtype == torch.float32
    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=atol)


def test_params_carry_the_branch_and_init_keeps_the_trunk():
    """``params_from_jax`` maps the proposal subtree (prop_linear_i,
    sigma_linear); the port's init draws the branch from its own stream, so
    coarse / fine equal a coarse+fine network's init bitwise; same seed,
    same branch."""
    from nerf_replication_tpu_torch.models.nerf.network import init_params

    _, pcfg = _cfgs()
    a = init_params(make_network(pcfg), torch.Generator().manual_seed(7))
    b = init_params(make_network(make_cfg(PROP, OPTS + [
        "sampling.mode", "coarse_fine"])), torch.Generator().manual_seed(7))
    c = init_params(make_network(pcfg), torch.Generator().manual_seed(7))
    assert b.proposal is None
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert set(sa) - set(sb) == {
        f"proposal.{n}.{p}" for n in ("prop_linear_0", "prop_linear_1",
                                      "sigma_linear")
        for p in ("weight", "bias")}
    for k, v in sb.items():
        assert torch.equal(sa[k], v), k
    for k, v in sa.items():
        assert torch.equal(sc[k], v), k
    assert tuple(sa["proposal.prop_linear_0.weight"].shape) == (64, 33)


# -- the proposal render, its loss and one step ----------------------------

@pytest.mark.parametrize("step", [None, 0, 500, 2000])
def test_proposal_render_rays_matches_jax(weights, step):
    """Train mode (the histograms returned) at the anneal's fixed steps
    (anneal_iters 1000); ``None`` renders in eval mode (fully sharp)."""
    jnet, params, pnet = weights
    jcfg, pcfg = _cfgs()
    rays = sample_rays(30, seed=3)
    train = step is not None
    jb = {"rays": jnp.asarray(rays), "near": NEAR, "far": FAR}
    pb = {"rays": _t(rays), "near": NEAR, "far": FAR}
    if train:
        jb["step"] = jnp.asarray(step, jnp.int32)
        pb["step"] = step
    ref = jv.Renderer(jcfg, jnet).render(params, jb, key=None, train=train)
    with torch.no_grad():
        out = pv.Renderer(pcfg, pnet).render(pb, train=train)
    assert set(out) == set(ref)
    sharp = step is None or step >= 1000
    _assert_maps(out, ref, sharp=sharp)
    if train:
        np.testing.assert_allclose(out["prop_t"].numpy(), ref["prop_t"],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(out["prop_w"].numpy(), ref["prop_w"],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(out["fine_t"].numpy(), ref["fine_t"],
                                   rtol=0, atol=2e-5 if sharp else 4e-6)
        np.testing.assert_allclose(out["fine_w"].numpy(), ref["fine_w"],
                                   rtol=0, atol=5e-5 if sharp else 1e-5)


def _batch(n=40, seed=3):
    rng = np.random.default_rng(seed)
    o = np.tile([0.0, 0.0, 4.0], (n, 1)) + rng.normal(0, 0.1, (n, 3))
    d = np.array([0.0, 0.0, -1.0]) + rng.normal(0, 0.2, (n, 3))
    rays = np.concatenate([o, d], -1).astype(np.float32)
    return rays, rng.uniform(0, 1, (n, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_step(weights):
    """The JAX loss, its stats and gradients at step 300, and the
    parameters after one Adam step (TrainState.apply_gradients)."""
    from flax.training.train_state import TrainState

    from nerf_replication_tpu.train.loss import NeRFLoss as JaxLoss
    from nerf_replication_tpu.train.optim import make_optimizer as jax_opt

    jnet, params, _ = weights
    jcfg, _ = _cfgs()
    rays, rgbs = _batch()
    jb = {"rays": jnp.asarray(rays), "rgbs": jnp.asarray(rgbs), "near": NEAR,
          "far": FAR, "step": jnp.asarray(300, jnp.int32)}
    jloss = JaxLoss(jcfg, jnet)
    tx, _ = jax_opt(jcfg)
    state = TrainState.create(apply_fn=jnet.apply, params=params["params"],
                              tx=tx)

    def lf(p):
        _, loss, stats = jloss({"params": p}, jb, key=None, train=True)
        return loss, stats

    (_, stats), g = jax.value_and_grad(lf, has_aux=True)(state.params)
    state = state.apply_gradients(grads=g)
    return ({k: float(v) for k, v in stats.items()}, jax_tree_numpy(g),
            jax_tree_numpy(state.params))


def _pairs(pnet, tree, grad=False):
    for branch, layers in tree.items():
        for name, leaf in layers.items():
            mod = getattr(getattr(pnet, branch), name)
            w, b = (mod.weight.grad, mod.bias.grad) if grad else (
                mod.weight, mod.bias)
            yield f"{branch}.{name}", w.detach().numpy().T, leaf["kernel"]
            yield f"{branch}.{name}.bias", b.detach().numpy(), leaf["bias"]


def _port_loss(pnet, fused):
    from nerf_replication_tpu_torch.train.loss import NeRFLoss

    _, pcfg = _cfgs(["network.nerf.fused_trunk", str(fused).lower()])
    rays, rgbs = _batch()
    pb = {"rays": _t(rays), "rgbs": _t(rgbs), "near": NEAR, "far": FAR,
          "step": 300}
    return pcfg, NeRFLoss(pcfg, pnet), pb


@pytest.mark.parametrize("fused", [False, True])
def test_proposal_loss_and_gradients_match_jax(weights, jax_step, fused):
    """``loss = loss_f + loss_mult·interlevel`` (no coarse term), with the
    fine pass through the plain Network or the fused Function (plain K1 /
    K2) and the proposal branch plain in both: every stat, and the
    gradients of the fine and proposal branches (the coarse one gets
    none)."""
    _, _, pnet = weights
    jstats, jg, _ = jax_step
    _, ploss, pb = _port_loss(pnet, fused)
    pnet.zero_grad(set_to_none=True)
    _, loss, stats = ploss(pb, gen=None, train=True)
    loss.backward()
    assert set(stats) == set(jstats) == {"loss_f", "psnr", "loss_prop",
                                         "loss"}
    for k, v in stats.items():
        assert float(v.detach()) == pytest.approx(jstats[k], rel=1e-5), k
    assert float(stats["loss_prop"].detach()) > 0.0
    for name, a, b in _pairs(pnet, {k: v for k, v in jg.items()
                                    if k != "coarse"}, grad=True):
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= 1e-3 * scale, name
    assert all(p.grad is None for p in pnet.coarse.parameters())
    pnet.zero_grad(set_to_none=True)


def test_one_training_step_matches_jax(weights, jax_step):
    """One Adam step (clip by value 40, lr = schedule(0)) through the fused
    Function from the same weights and batch: the parameters JAX's
    TrainState reaches."""
    import copy

    from nerf_replication_tpu_torch.train.optim import (
        apply_update,
        make_optimizer,
    )

    pnet = copy.deepcopy(weights[2])
    _, _, jparams = jax_step
    pcfg, ploss, pb = _port_loss(pnet, True)
    opt, sched = make_optimizer(pcfg, pnet.parameters())
    _, loss, _ = ploss(pb, gen=None, train=True)
    loss.backward()
    apply_update(opt, sched, 0)
    lr = float(pcfg.train.lr)
    diffs = np.concatenate([np.abs(a - b).ravel()
                            for _, a, b in _pairs(pnet, jparams)])
    assert float(diffs.max()) <= 2 * lr
    assert float(np.mean(diffs <= 1e-6)) >= 0.999


# -- eval: the packed proposal march and the renderer's route ----------------

def _march_rays(n=40, seed=3, n_zero=4):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.8, (n, 3)) + np.array([0.0, 0.0, 4.0])
    d = rng.normal(0, 0.4, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d], -1).astype(np.float32)
    rays[n - n_zero:] = 0.0
    return rays


@pytest.mark.parametrize("apply", ["plain", "masked"])
def test_march_rays_proposal_packed_matches_jax(weights, apply):
    """The packed proposal march through the plain Network, or through the
    masked fused apply (plain K3a) with the proposal branch plain, against
    the JAX march: maps, truncation and the stream statistics; time-
    conditioned rays are refused as in JAX."""
    from nerf_replication_tpu.renderer.accelerated import (
        MarchOptions as JaxMarchOptions,
    )
    from nerf_replication_tpu.renderer.packed_march import (
        march_rays_proposal_packed as jax_march,
    )
    from nerf_replication_tpu_torch.ops.fused_mlp import make_fused_apply
    from nerf_replication_tpu_torch.renderer.accelerated import MarchOptions
    from nerf_replication_tpu_torch.renderer.packed_march import (
        march_rays_proposal_packed,
    )

    jnet, params, pnet = weights
    jcfg, pcfg = _cfgs()
    kw = dict(step_size=0.0625, max_samples=24, chunk_size=64)
    js = jv.RenderOptions.from_cfg(jcfg, train=False).sampling
    ps = pv.RenderOptions.from_cfg(pcfg, train=False).sampling
    rays, grid = _march_rays(), _grid()

    def japply(pts, vd, model, valid=None):
        return jnet.apply(params, pts, vd, model=model)

    ref = jax.tree.map(np.asarray, jax.jit(
        lambda r, g, b: jax_march(japply, r, NEAR, FAR, g, b,
                                  JaxMarchOptions(**kw), js, cap_avg=4))(
        jnp.asarray(rays), jnp.asarray(grid), jnp.asarray(BBOX)))
    if apply == "plain":
        def papply(pts, vd, model):
            return pnet(pts, vd, model=model)
    else:
        papply = pv.plain_proposal_branch(make_fused_apply(pnet, pcfg), pnet)
    with torch.no_grad():
        out = march_rays_proposal_packed(
            papply, _t(rays), NEAR, FAR, _t(grid), _t(BBOX),
            MarchOptions(**kw), ps, cap_avg=4)
    assert set(out) == set(ref)
    _assert_maps(out, ref)
    np.testing.assert_array_equal(out["truncated"].numpy(), ref["truncated"])
    for k in ("march_candidates", "march_samples_out", "march_coarse_occ",
              "overflow_frac"):
        assert float(out[k]) == pytest.approx(float(ref[k]), rel=1e-6), k
    assert float(out["overflow_frac"]) > 0.0  # a 4-row-a-ray stream
    with pytest.raises(ValueError):
        march_rays_proposal_packed(papply, torch.zeros(4, 7), NEAR, FAR,
                                   _t(grid), _t(BBOX), MarchOptions(**kw), ps)


def test_render_accelerated_routes_proposal_checkpoints(weights, tmp_path):
    """With a grid loaded, a proposal checkpoint's eval goes through the
    packed proposal march (fine MLP through plain K3a under fused_trunk),
    as the JAX renderer routes it; maps and the per-chunk stats agree."""
    from nerf_replication_tpu_torch.renderer.occupancy import (
        save_occupancy_grid,
    )

    jnet, params, pnet = weights
    extra = MARCH + ["task_arg.packed_cap_avg_eval", "16"]
    jcfg, _ = _cfgs(extra)
    _, pcfg = _cfgs(extra + ["network.nerf.fused_trunk", "true"])
    path = str(tmp_path / "occupancy_grid.npz")
    save_occupancy_grid(path, _grid(), BBOX, 1.0)
    jr, pr = jv.Renderer(jcfg, jnet), pv.Renderer(pcfg, pnet)
    assert jr.load_occupancy_grid(path) and pr.load_occupancy_grid(path)
    rays = sample_rays(45, seed=6)
    ref = jr.render_accelerated(params, {"rays": jnp.asarray(rays),
                                         "near": NEAR, "far": FAR})
    with torch.no_grad():
        out = pr.render_accelerated({"rays": _t(rays), "near": NEAR,
                                     "far": FAR})
    assert set(out) == set(ref) == {"rgb_map_f", "depth_map_f", "acc_map_f"}
    _assert_maps(out, ref)
    for k, v in jr.last_march_stats.items():
        np.testing.assert_allclose(np.asarray(pr.last_march_stats[k]),
                                   np.asarray(v), rtol=1e-6, err_msg=k)


# -- serving -----------------------------------------------------------------

ENGINE = MARCH + ["serve.buckets", "[32]", "serve.max_batch_rays", "32",
                  "serve.warmup", "false"]


@pytest.mark.parametrize("grid", [True, False])
def test_engine_proposal_tiers_match_jax(weights, grid):
    """A proposal checkpoint serves the ``proposal`` family: on a grid the
    packed proposal march at half the fine budget (through plain K3a under
    fused_trunk), without one the chunked proposal render; the shed tiers
    shrink the budgets as the JAX engine does."""
    from nerf_replication_tpu.serve import RenderEngine as JaxEngine
    from nerf_replication_tpu_torch.serve import RenderEngine

    jnet, params, pnet = weights
    extra = ENGINE + ([] if grid else ["task_arg.accelerated_renderer",
                                       "false"])
    jcfg, _ = _cfgs(extra)
    _, pcfg = _cfgs(extra + ["network.nerf.fused_trunk", "true"])
    g, b = (_grid(), BBOX) if grid else (None, None)
    jeng = JaxEngine(jcfg, jnet, params, near=NEAR, far=FAR, grid=g, bbox=b)
    peng = RenderEngine(pcfg, pnet, near=NEAR, far=FAR, grid=g, bbox=b,
                        device="cpu")
    assert peng.has_proposal and jeng.has_proposal
    assert peng._families_for_params() == jeng._families_for_params()
    rays = sample_rays(40, seed=8)
    tiers = ("full", "proposal") if grid else ("proposal", "coarse")
    for tier in tiers:
        ref = jeng.render_request(rays, NEAR, FAR, tier=tier, emit=False)
        out = peng.render_request(rays, NEAR, FAR, tier=tier)
        assert out["tier"] == tier and set(out) == set(ref), tier
        _assert_maps(out, ref, sharp=True)
    assert peng.stats()["sampling"] == jeng.stats()["sampling"]


def test_engine_remaps_the_proposal_tier_on_coarse_fine(weights):
    """A coarse+fine checkpoint has no proposal branch: the ``proposal``
    tier is served by the ``reduced_k`` family (bitwise its render), as in
    the JAX engine, and the family is never built."""
    from nerf_replication_tpu.serve import RenderEngine as JaxEngine
    from nerf_replication_tpu_torch.serve import RenderEngine

    jnet, params, pnet = nets()
    jcfg, pcfg = (c(os.path.join(ROOT, "configs", "nerf", "lego.yaml"),
                    SMALL_NET + ENGINE) for c in (jax_make_cfg, make_cfg))
    jeng = JaxEngine(jcfg, jnet, params, near=NEAR, far=FAR, grid=_grid(),
                     bbox=BBOX)
    peng = RenderEngine(pcfg, pnet, near=NEAR, far=FAR, grid=_grid(),
                        bbox=BBOX, device="cpu")
    assert not peng.has_proposal and not jeng.has_proposal
    assert "proposal" not in peng._families_for_params()
    rays = sample_rays(40, seed=9)
    out = peng.render_request(rays, NEAR, FAR, tier="proposal")
    red = peng.render_request(rays, NEAR, FAR, tier="reduced_k")
    ref = jeng.render_request(rays, NEAR, FAR, tier="proposal", emit=False)
    assert out["tier"] == "proposal"
    for k in ("rgb_map_f", "depth_map_f", "acc_map_f"):
        np.testing.assert_array_equal(out[k], red[k], err_msg=k)
    _assert_maps(out, ref)
    assert {k[1] for k in peng._fns} == {"reduced_k"}


# -- training end to end on the CPU ----------------------------------------

def _fit_opts(root, out, extra=()):
    return [
        "scene", "procedural", "exp_name", "prop",
        "train_dataset.data_root", root, "test_dataset.data_root", root,
        "train_dataset.H", "16", "train_dataset.W", "16",
        "test_dataset.H", "16", "test_dataset.W", "16",
        "task_arg.N_rays", "64", "task_arg.chunk_size", "256",
        "task_arg.precrop_iters", "0", "sampling.n_proposal", "16",
        "sampling.n_fine", "12", "sampling.anneal_iters", "10",
        "network.nerf.W", "32", "network.nerf.D", "3",
        "network.nerf.skips", "[1]", "network.xyz_encoder.freq", "4",
        "network.dir_encoder.freq", "2", "ep_iter", "6",
        "log_interval", "1", "eval_ep", "100", "save_ep", "1",
        "save_latest_ep", "1",
        "trained_model_dir", os.path.join(out, "trained"),
        "trained_config_dir", os.path.join(out, "config"),
        "record_dir", os.path.join(out, "record"),
        "result_dir", os.path.join(out, "result"),
        *extra,
    ]


def test_fit_resume_and_serve_a_proposal_checkpoint(tmp_path):
    """``fit`` trains the proposal path on a 16x16 procedural scene (the
    step count drives the anneal; loss_prop finite and logged); a run
    resumed after one epoch equals an uninterrupted one bitwise, proposal
    branch included; ``engine_from_cfg`` loads the checkpoint with its
    branch and answers at the ``proposal`` tier."""
    from nerf_replication_tpu_torch.datasets.procedural import generate_scene
    from nerf_replication_tpu_torch.serve import engine_from_cfg
    from nerf_replication_tpu_torch.train.trainer import fit

    root = str(tmp_path / "scene")
    generate_scene(root, "procedural", H=16, W=16, n_train=3, n_test=1)

    from nerf_replication_tpu_torch.obs import add_row_tap, remove_row_tap

    def run(out, epochs):
        rows = []

        def tap(row):
            if row["kind"] == "step":
                rows.append(row)

        cfg = make_cfg(PROP, _fit_opts(root, str(tmp_path / out),
                                       ["train.epoch", str(epochs)]))
        add_row_tap(tap)
        try:
            state = fit(cfg, device="cpu", log=lambda s: None)
        finally:
            remove_row_tap(tap)
        return cfg, state, rows

    cfg, whole, rows_a = run("a", 2)
    run("b", 1)
    _, resumed, rows_b = run("b", 2)
    assert whole.step == resumed.step == 12
    assert all(np.isfinite(r["stats"]["loss_prop"]) for r in rows_a)
    assert [r["stats"]["loss"] for r in rows_b] == \
        [r["stats"]["loss"] for r in rows_a[6:]]
    for (k, a), b in zip(whole.network.state_dict().items(),
                         resumed.network.state_dict().values()):
        assert torch.equal(a, b), k
    assert any(k.startswith("proposal.") for k in
               whole.network.state_dict())
    eng = engine_from_cfg(make_cfg(PROP, _fit_opts(
        root, str(tmp_path / "a"), ["serve.buckets", "[64]",
                                    "serve.warmup", "false"])),
        cfg_file=PROP, device="cpu")
    assert eng.has_proposal
    for k, v in eng.network.state_dict().items():
        assert torch.equal(v, whole.network.state_dict()[k]), k
    rays = sample_rays(20, seed=1)
    out = eng.render_request(rays, cfg.task_arg.near, cfg.task_arg.far,
                             tier="proposal")
    assert out["tier"] == "proposal"
    assert np.isfinite(out["rgb_map_f"]).all()
    assert out["rgb_map_f"].shape == (20, 3)
