"""Port parity of the volume renderer (renderer/volume.py) and the render
gate: ``raw2outputs``, ``sample_pdf`` (det) and ``render_rays`` coarse +
fine (perturb 0) against the JAX package on the same inputs and weights.

Tolerances: ``raw2outputs`` atol 1e-6 and ``sample_pdf`` atol 4e-6, a few
ulps of samples up to 6 (the same float32 formulas; XLA's cumprod/cumsum
associate differently); ``render_rays``
maps atol 1e-5 (depth 1e-4: t ≈ 2..6 scales the weight error) — the MLP
products sum in another order, and the importance samples inherit that
through the CDF."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import FAR, NEAR, both_cfgs, nets, sample_rays

from nerf_replication_tpu.renderer import volume as jv
from nerf_replication_tpu_torch.renderer import volume as pv
from nerf_replication_tpu_torch.renderer.gate import full_image_render_fn

NET = ["network.nerf.W", "32", "network.nerf.D", "4",
       "network.nerf.skips", "[1]", "task_arg.N_samples", "16",
       "task_arg.N_importance", "24", "task_arg.perturb", "0"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("white", [False, True])
def test_raw2outputs_matches_jax(white):
    rng = np.random.default_rng(0)
    raw = rng.normal(0, 2, (9, 17, 4)).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (9, 17)), -1).astype(np.float32)
    d = rng.normal(0, 1, (9, 3)).astype(np.float32)
    ref = jv.raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d),
                         white_bkgd=white)
    out = pv.raw2outputs(_t(raw), _t(z), _t(d), white_bkgd=white)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


def test_sample_pdf_det_matches_jax():
    rng = np.random.default_rng(1)
    bins = np.sort(rng.uniform(2, 6, (7, 15)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (7, 14)).astype(np.float32)
    w[0] = 0.0  # an all-zero row: the 1e-5 guard makes it uniform
    ref = jv.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 33,
                        det=True)
    out = pv.sample_pdf(None, _t(bins), _t(w), 33, det=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=4e-6)


def test_stratified_z_vals_jitter_stays_in_bins():
    g = torch.Generator().manual_seed(0)
    z0 = pv.stratified_z_vals(None, NEAR, FAR, 3, 8, 0.0)
    np.testing.assert_allclose(
        z0.numpy(), np.asarray(jv.stratified_z_vals(None, NEAR, FAR, 3, 8,
                                                    0.0)), atol=1e-7)
    z = pv.stratified_z_vals(g, NEAR, FAR, 3, 8, 1.0)
    mids = 0.5 * (z0[..., 1:] + z0[..., :-1])
    lo = torch.cat([z0[..., :1], mids], -1)
    hi = torch.cat([mids, z0[..., -1:]], -1)
    assert bool(((z >= lo) & (z <= hi)).all()) and not torch.equal(z, z0)


@pytest.mark.parametrize("fused", [False, True])
def test_render_rays_matches_jax(fused):
    """Coarse + fine, perturb 0, through the plain Network or the fused
    Function (plain K1/K2) against the JAX Renderer."""
    extra = NET + ["network.nerf.fused_trunk", str(fused).lower(),
                   "network.nerf.fused_tile", "64"]
    jnet, params, pnet = nets(extra=extra)
    jcfg, pcfg = both_cfgs(extra)
    rays = sample_rays(40, seed=2)
    jr = jv.Renderer(jcfg, jnet)
    ref = jr.render(params, {"rays": jnp.asarray(rays), "near": NEAR,
                             "far": FAR}, key=None, train=True)
    pr = pv.Renderer(pcfg, pnet)
    with torch.no_grad():
        out = pr.render({"rays": _t(rays), "near": NEAR, "far": FAR},
                        train=True)
    assert set(out) == set(ref)
    for k in ref:
        atol = 1e-4 if k.startswith("depth") else 1e-5
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=atol, err_msg=k)


def test_render_chunked_and_gate_match_one_pass():
    """The gate's chunked render (last chunk padded) equals one pass, and
    matches the JAX render_chunked; the gate's occupancy branch
    (``use_grid``) with no grid loaded renders the same chunked images."""
    extra = NET + ["task_arg.chunk_size", "16"]
    jnet, params, pnet = nets(extra=extra)
    jcfg, pcfg = both_cfgs(extra)
    rays = sample_rays(37, seed=4)
    pr = pv.Renderer(pcfg, pnet)
    render = full_image_render_fn(pcfg, pnet, pr, None)
    out = render({"rays": _t(rays), "near": NEAR, "far": FAR})
    with torch.no_grad():
        one = pr.render({"rays": _t(rays), "near": NEAR, "far": FAR},
                        train=False)
    ref = jv.Renderer(jcfg, jnet).render_chunked(
        params, {"rays": jnp.asarray(rays), "near": NEAR, "far": FAR})
    for k in one:
        assert out[k].shape[0] == 37
        torch.testing.assert_close(out[k], one[k], rtol=0, atol=1e-6)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-4, err_msg=k)
    grid_render = full_image_render_fn(pcfg, pnet, pr, None, use_grid=True)
    for k, v in grid_render({"rays": _t(rays), "near": NEAR,
                             "far": FAR}).items():
        assert torch.equal(v, out[k]), k


def test_render_options_refuse_proposal():
    """``sampling.mode: proposal`` is no longer refused: the options carry
    the JAX package's sampling fields (parity in test_torch_sampling.py)."""
    jcfg, pcfg = both_cfgs(["sampling.mode", "proposal"])
    for train in (True, False):
        po = pv.RenderOptions.from_cfg(pcfg, train=train)
        jo = jv.RenderOptions.from_cfg(jcfg, train=train)
        assert po.sampling.mode == "proposal"
        assert vars(po.sampling) == vars(jo.sampling)
    assert jax is not None
