"""Serving a hash-grid checkpoint: the port's RenderEngine against the JAX
RenderEngine on one lego_hash network's weights (JAX init carried across by
``convert.params_from_jax``; a 2^12-row table, W 16), on the 16³ box grid
of ``tests/test_torch_serve.py``.

* Routes: the staged per-ray march (``march_fused off``), the staged
  packed march (``march_coarse_block 8``) and ``gather`` (K4's plain
  version); tiers ``full``, ``bf16`` and ``reduced_k``. On the CPU the
  hash encoder is K6's plain version (``ops.hash_encode.forward_plain``);
  the JAX engine runs its own encoder as the JAX tests run it on the CPU.
* Tolerances: those of ``tests/test_torch_serve.py::_tol`` — f32 rgb/acc
  1e-5, depth 1e-4; bf16 2e-2 / 1e-1 (its ``gather`` row: these routes run
  the plain Network). Traversal stats, truncation and padding exact.
* Both packages refuse the ``full`` (K5) route for a learnable encoder.
* ``engine_from_cfg`` boots on the checkpoint of a 5-step CPU ``fit_ngp``
  with a grid written from its ``grid_ema > threshold``, and its staged
  per-ray ``full`` tier renders what ``NGPTrainer.render_image`` renders
  through the same grid.

``coarse`` / ``half_res`` are left out: ``fit_ngp`` trains only the fine
branch, so those tiers serve an untrained coarse network, in JAX as in the
port (ROADMAP Queue 3).
"""

import os

import jax
import numpy as np
import pytest
import torch

from test_torch_helpers import (
    BBOX,
    FAR,
    NEAR,
    ROOT,
    box_grid,
    jax_tree_numpy,
    sample_rays,
)

from nerf_replication_tpu.config import make_cfg as jax_make_cfg
from nerf_replication_tpu.models import make_network as jax_make_network
from nerf_replication_tpu.models.nerf.network import (
    init_params as jax_init_params,
)
from nerf_replication_tpu_torch.config import make_cfg
from nerf_replication_tpu_torch.convert import params_from_jax
from nerf_replication_tpu_torch.models import make_network
from nerf_replication_tpu_torch.serve import RenderEngine, engine_from_cfg

LEGO_HASH = os.path.join(ROOT, "configs", "nerf", "lego_hash.yaml")
HASH_SERVE = [
    "network.xyz_encoder.log2_hashmap_size", "12",
    "network.nerf.W", "16",
    "task_arg.render_step_size", "0.25",
    "task_arg.max_march_samples", "64",
    "task_arg.eval_render_step_size", "0.25",
    "task_arg.eval_max_march_samples", "64",
    "task_arg.march_chunk_size", "64",
    "task_arg.march_coarse_cap", "3",
    "serve.buckets", "[64]",
    "serve.max_batch_rays", "64",
]
ROUTES = {
    "staged_per_ray": ["task_arg.march_fused", "off",
                       "task_arg.march_coarse_block", "0"],
    "staged_packed": ["task_arg.march_fused", "off",
                      "task_arg.march_coarse_block", "8"],
    "gather": ["task_arg.march_fused", "gather",
               "task_arg.march_coarse_block", "4"],
}
TIERS = ("full", "bf16", "reduced_k")


def _tol(tier):
    """``tests/test_torch_serve.py::_tol`` of a route that runs the plain
    Network (its ``gather`` row)."""
    return (2e-2, 1e-1) if tier == "bf16" else (1e-5, 1e-4)


@pytest.fixture(scope="module")
def weights():
    """(JAX network, JAX params, port network with the same weights)."""
    jcfg = jax_make_cfg(LEGO_HASH, HASH_SERVE)
    jnet = jax_make_network(jcfg)
    params = jax_init_params(jnet, jax.random.PRNGKey(0))
    pnet = make_network(make_cfg(LEGO_HASH, HASH_SERVE))
    pnet.load_state_dict(params_from_jax(jax_tree_numpy(params)), strict=True)
    return jnet, params, pnet


def _engines(weights, route):
    from nerf_replication_tpu.serve import RenderEngine as JaxEngine

    jnet, params, pnet = weights
    opts = HASH_SERVE + ROUTES[route]
    grid = box_grid(16)
    jeng = JaxEngine(jax_make_cfg(LEGO_HASH, opts), jnet, params, near=NEAR,
                     far=FAR, grid=grid, bbox=BBOX)
    peng = RenderEngine(make_cfg(LEGO_HASH, opts), pnet, near=NEAR, far=FAR,
                        grid=grid, bbox=BBOX, device="cpu")
    return jeng, peng


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_hash_engine_matches_jax_engine(weights, route):
    jeng, peng = _engines(weights, route)
    assert peng.buckets == tuple(jeng.buckets) == (64,)
    assert peng.stats()["route"] == peng.march_options.march_fused
    rays = sample_rays(50, seed=11)
    for tier in TIERS:
        ref = jeng.render_request(rays, NEAR, FAR, tier=tier, emit=False)
        out = peng.render_request(rays, NEAR, FAR, tier=tier)
        assert out["tier"] == tier
        atol, datol = _tol(tier)
        for k, tol in (("rgb_map_f", atol), ("acc_map_f", atol),
                       ("depth_map_f", datol)):
            assert out[k].shape == np.asarray(ref[k]).shape, (tier, k)
            np.testing.assert_allclose(out[k], np.asarray(ref[k]), rtol=0,
                                       atol=tol, err_msg=f"{tier} {k}")
    js, ps = jeng.stats(), peng.stats()
    assert (ps["march"] is None) == (js["march"] is None)
    if js["march"] is not None:
        assert ps["march"]["chunks"] == js["march"]["chunks"]
        for k in ("candidates_per_chunk", "samples_out_per_chunk"):
            assert ps["march"][k] == js["march"][k], k
        for k in ("coarse_occ_mean", "overflow_mean", "sweep_efficiency"):
            assert ps["march"][k] == pytest.approx(js["march"][k],
                                                   rel=1e-6), k
    assert ps["n_truncated"] == js["n_truncated"]
    assert ps["n_pad_rays"] == js["n_pad_rays"]


def test_full_route_refused_for_a_hash_network(weights):
    """K5 encodes frequency bands in-kernel: both engines refuse the
    ``full`` route for a learnable encoder when they build it."""
    from nerf_replication_tpu.serve import RenderEngine as JaxEngine

    jnet, params, pnet = weights
    opts = HASH_SERVE + ["task_arg.march_fused", "full",
                         "task_arg.march_coarse_block", "4"]
    with pytest.raises(ValueError, match="learnable encoder"):
        RenderEngine(make_cfg(LEGO_HASH, opts), pnet, NEAR, FAR,
                     grid=box_grid(16), bbox=BBOX, device="cpu")
    with pytest.raises(ValueError):
        JaxEngine(jax_make_cfg(LEGO_HASH, opts), jnet, params, near=NEAR,
                  far=FAR, grid=box_grid(16), bbox=BBOX)


def test_engine_from_cfg_serves_a_fit_ngp_checkpoint(tmp_path, monkeypatch):
    """A 5-step CPU ``fit_ngp`` writes the checkpoint; its live grid
    (``grid_ema > threshold``) becomes the occupancy grid file; the engine
    boots from config with the trained weights and serves the staged
    per-ray route as the trainer's own eval render does."""
    from test_torch_ngp import _ngp_opts

    from nerf_replication_tpu_torch.datasets import make_dataset
    from nerf_replication_tpu_torch.datasets.procedural import generate_scene
    from nerf_replication_tpu_torch.renderer.occupancy import (
        default_grid_path,
        save_occupancy_grid,
    )
    from nerf_replication_tpu_torch.train.ngp import NGPTrainer, fit_ngp

    root = str(tmp_path / "scene")
    generate_scene(root, "procedural", H=16, W=16, n_train=4, n_test=1)
    opts = _ngp_opts(root, str(tmp_path / "out"), [
        "train.epoch", "1", "serve.buckets", "[128]",
        "serve.max_batch_rays", "128"])
    cfg = make_cfg(LEGO_HASH, opts)
    state = fit_ngp(cfg, device="cpu", log=lambda s: None)
    assert state.step == 5
    trainer = NGPTrainer(cfg, state.network)
    grid = (state.grid_ema > trainer.threshold).numpy()
    monkeypatch.chdir(tmp_path)
    save_occupancy_grid(default_grid_path(LEGO_HASH), grid,
                        cfg.train_dataset.scene_bbox, trainer.threshold)
    eng = engine_from_cfg(make_cfg(LEGO_HASH, opts, default_task="run"),
                          cfg_file=LEGO_HASH, device="cpu")
    assert eng.use_grid and eng.stats()["route"] == "off"
    for k, v in state.network.state_dict().items():
        assert torch.equal(eng.network.state_dict()[k], v), k
    batch = make_dataset(cfg, "test").image_batch(0)
    out = eng.render_request(batch["rays"], eng.near, eng.far)
    with torch.no_grad():
        ref = trainer.render_image(state,
                                   {"rays": torch.from_numpy(batch["rays"])})
    for k in ("rgb_map_f", "depth_map_f", "acc_map_f"):
        assert out[k].shape[0] == 256 and np.isfinite(out[k]).all()
        np.testing.assert_array_equal(out[k], ref[k].numpy(), err_msg=k)
