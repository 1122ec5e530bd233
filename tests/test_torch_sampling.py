"""Port parity of the learned sampler's math (renderer/sampling.py) against
the JAX package on the same seeded numpy inputs: ``resample_pdf`` (det mode,
the anneal, and random mode on the same u draws), ``weights_from_sigma``,
``edges_from_samples``, ``_outer_measure``, ``interlevel_loss`` (values and
gradients), ``SamplingOptions`` and the anneal schedule.

Tolerances: resampled depths atol 4e-6 (a few float32 ulps of depths up to
6: the same formulas, XLA's cumsum associates differently — as
``sample_pdf``'s test), plus, for random draws, that cdf difference carried
through the inverse CDF's slope; weights atol 1e-6; losses rtol 1e-5 and gradients
within 1e-5 of each tensor's largest |value| (sums over bins in another
order). Indices (the outer measure's bisection) are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import both_cfgs

from nerf_replication_tpu.renderer import sampling as js
from nerf_replication_tpu.renderer import volume as jv
from nerf_replication_tpu_torch.renderer import sampling as ps
from nerf_replication_tpu_torch.renderer import volume as pv


def _t(a):
    return torch.from_numpy(np.array(a))


def _histogram(n=9, b=17, seed=1):
    """Sorted bins [n, b] over [2, 6] and weights [n, b - 1] with the edge
    rows: all zero, all mass in the first bin, all in the last."""
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(2, 6, (n, b)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (n, b - 1)).astype(np.float32) ** 3
    w[0] = 0.0
    w[1] = 0.0
    w[1, 0] = 1.0
    w[2] = 0.0
    w[2, -1] = 1.0
    return bins, w


@pytest.mark.parametrize("anneal", [None, 0.0, 0.5, 1.0])
def test_resample_pdf_det_matches_jax(anneal):
    bins, w = _histogram()
    ref = js.resample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 33,
                          det=True, anneal=anneal)
    out = ps.resample_pdf(None, _t(bins), _t(w), 33, det=True, anneal=anneal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=4e-6)
    # samples stay inside the histogram's support
    assert bool((out >= _t(bins)[:, :1]).all())
    assert bool((out <= _t(bins)[:, -1:]).all())


@pytest.mark.parametrize("anneal", [None, 0.25])
def test_resample_pdf_same_draws_match_jax(anneal, monkeypatch):
    """Random mode: the port's u (its generator) handed to the JAX function
    in place of ``jax.random.uniform``'s, so both bisect the same draws —
    u = 0 and u past the cdf's last entry included (the clamps at the
    ends). Tolerance: 4e-6 plus the cdfs' rounding difference carried
    through the inverse CDF's slope (:func:`_slope`)."""
    bins, w = _histogram(seed=2)
    gen = torch.Generator().manual_seed(3)
    u = torch.rand((bins.shape[0], 40), generator=torch.Generator()
                   .manual_seed(3))
    u[:, -1] = 1.0 - 2.0 ** -24  # the largest float32 below 1
    u[:, 0] = 0.0

    def uniform(key, shape, dtype=jnp.float32):
        assert tuple(shape) == tuple(u.shape)
        return jnp.asarray(u.numpy())

    monkeypatch.setattr(jax.random, "uniform", uniform)
    ref = js.resample_pdf(jax.random.PRNGKey(0), jnp.asarray(bins),
                          jnp.asarray(w), 40, anneal=anneal)
    monkeypatch.setattr(torch, "rand", lambda *a, **k: u.clone())
    out = ps.resample_pdf(gen, _t(bins), _t(w), 40, anneal=anneal)
    err = np.abs(out.numpy() - np.asarray(ref))
    assert (err <= 4e-6 + _CDF_ULPS * _slope(bins, w, u.numpy(),
                                             anneal)).all()


# the two cdfs differ by up to 2 float32 ulps of 1 (measured; XLA's cumsum
# associates differently); a draw moves by that times the inverse CDF's
# slope, which is large in the bins that hold only the 1e-5 guard
_CDF_ULPS = 2.0 ** -21


def _slope(bins, w, u, anneal):
    """|dz/du| of the inverse CDF at each draw (float64): the bin's width
    over its cdf step. Unguarded: a step within rounding of resample_pdf's
    1e-5 guard falls on either side of it in float32."""
    w = w.astype(np.float64) + 1e-5
    pdf = w / w.sum(-1, keepdims=True)
    if anneal is not None:
        pdf = anneal * pdf + (1 - anneal) / pdf.shape[-1]
    cdf = np.concatenate([np.zeros_like(pdf[:, :1]), np.cumsum(pdf, -1)], -1)
    out = np.empty(u.shape)
    for r in range(u.shape[0]):
        i = np.clip(np.searchsorted(cdf[r], u[r], "right"), 1, cdf.shape[1] - 1)
        step = cdf[r, i] - cdf[r, i - 1]
        out[r] = (bins[r, i] - bins[r, i - 1]) / step
    return out


def test_resample_pdf_uniform_weights_is_the_midpoint_rule():
    """Det mode on uniform weights (or anneal 0) draws the stratified
    midpoints of the bins' span, as the JAX docstring promises."""
    bins = np.tile(np.linspace(2, 6, 9, dtype=np.float32), (3, 1))
    w = np.ones((3, 8), np.float32)
    mids = 2.0 + 4.0 * (np.arange(16) + 0.5) / 16
    out = ps.resample_pdf(None, _t(bins), _t(w), 16, det=True)
    np.testing.assert_allclose(out.numpy(), np.tile(mids, (3, 1)), atol=2e-6)
    rng = np.random.default_rng(0)
    w2 = rng.uniform(0, 1, (3, 8)).astype(np.float32)
    flat = ps.resample_pdf(None, _t(bins), _t(w2), 16, det=True, anneal=0.0)
    np.testing.assert_allclose(flat.numpy(), np.tile(mids, (3, 1)),
                               atol=2e-6)


def test_weights_from_sigma_value_and_grad_match_jax():
    rng = np.random.default_rng(4)
    sigma = rng.normal(0, 3, (7, 19)).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (7, 19)), -1).astype(np.float32)
    d = rng.normal(0, 1, (7, 3)).astype(np.float32)
    c = rng.normal(0, 1, (7, 19)).astype(np.float32)

    def jf(s):
        return jnp.sum(js.weights_from_sigma(s, jnp.asarray(z),
                                             jnp.asarray(d)) * c)

    ref_w = js.weights_from_sigma(jnp.asarray(sigma), jnp.asarray(z),
                                  jnp.asarray(d))
    ref_g = jax.grad(jf)(jnp.asarray(sigma))
    s = _t(sigma).requires_grad_(True)
    w = ps.weights_from_sigma(s, _t(z), _t(d))
    (w * _t(c)).sum().backward()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(ref_w),
                               rtol=0, atol=1e-6)
    # and the volume renderer's weights on the same density
    raw = np.concatenate([np.zeros((7, 19, 3), np.float32),
                          sigma[..., None]], -1)
    _, _, _, w_vol = pv.raw2outputs(_t(raw), _t(z), _t(d))
    torch.testing.assert_close(w.detach(), w_vol, rtol=0, atol=1e-7)
    g = np.asarray(ref_g)
    assert np.abs(s.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()


def _interlevel_inputs(seed=5, n=6, s=12, p=20):
    rng = np.random.default_rng(seed)
    z_f = np.sort(rng.uniform(2, 6, (n, s)), -1).astype(np.float32)
    z_p = np.sort(rng.uniform(2, 6, (n, p)), -1).astype(np.float32)
    w_f = (rng.uniform(0, 1, (n, s)) ** 2 * 0.3).astype(np.float32)
    w_p = (rng.uniform(0, 1, (n, p)) ** 2 * 0.2).astype(np.float32)
    t_f = np.asarray(js.edges_from_samples(jnp.asarray(z_f)))
    t_p = np.asarray(js.edges_from_samples(jnp.asarray(z_p)))
    return t_f, w_f, t_p, w_p, z_f


def test_edges_and_outer_measure_match_jax():
    t_f, _, t_p, w_p, z_f = _interlevel_inputs()
    np.testing.assert_array_equal(ps.edges_from_samples(_t(z_f)).numpy(),
                                  t_f)
    ref = js._outer_measure(jnp.asarray(t_f), jnp.asarray(t_p),
                            jnp.asarray(w_p))
    out = ps._outer_measure(_t(t_f), _t(t_p), _t(w_p))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    # an upper bound of the envelope's mass inside each interval
    assert bool((out >= -1e-7).all())


@pytest.mark.parametrize("case", ["random", "bounded"])
def test_interlevel_loss_value_and_grad_match_jax(case):
    """The loss and its gradient in the proposal weights; the fine inputs
    get none (detached, as the JAX package's stop_gradient). ``bounded``:
    the proposal carries every fine weight, the loss is exactly 0."""
    t_f, w_f, t_p, w_p, _ = _interlevel_inputs()
    if case == "bounded":
        t_p = np.tile(np.linspace(1.5, 6.5, t_p.shape[-1], dtype=np.float32),
                      (t_p.shape[0], 1))
        w_p = np.full_like(w_p, 1.0)
    jl, (jg_p, jg_f) = jax.value_and_grad(
        lambda wp, wf: js.interlevel_loss(jnp.asarray(t_f), wf,
                                          jnp.asarray(t_p), wp),
        argnums=(0, 1))(jnp.asarray(w_p), jnp.asarray(w_f))
    wp = _t(w_p).requires_grad_(True)
    wf = _t(w_f).requires_grad_(True)
    loss = ps.interlevel_loss(_t(t_f), wf, _t(t_p), wp)
    loss.backward()
    if case == "bounded":
        assert float(loss.detach()) == 0.0 == float(jl)
        assert float(wp.grad.abs().max()) == 0.0
    else:
        assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
        g = np.asarray(jg_p)
        assert np.abs(wp.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()
    assert wf.grad is None and float(np.abs(np.asarray(jg_f)).max()) == 0.0


def test_sampling_options_and_fine_evals_match_jax():
    """``SamplingOptions.from_cfg`` (train and eval), ``fine_evals_per_ray``
    of every mode and the renderer's ``sampling_stats``."""
    for extra in ([], ["sampling.mode", "proposal", "sampling.n_fine", "24"],
                  ["task_arg.N_importance", "0"]):
        jcfg, pcfg = both_cfgs(extra)
        for train in (True, False):
            jo = jv.RenderOptions.from_cfg(jcfg, train=train)
            po = pv.RenderOptions.from_cfg(pcfg, train=train)
            assert vars(po.sampling) == vars(jo.sampling)
            assert po.fine_evals_per_ray == jo.fine_evals_per_ray
    jcfg, pcfg = both_cfgs(["sampling.mode", "proposal"])
    from nerf_replication_tpu.models import make_network as jmake
    from nerf_replication_tpu_torch.models import make_network as pmake

    assert pv.Renderer(pcfg, pmake(pcfg)).sampling_stats() == \
        jv.Renderer(jcfg, jmake(jcfg)).sampling_stats()


def test_anneal_factor_follows_the_jax_schedule():
    """clip(step / anneal_iters, 0, 1) at steps 0, anneal_iters / 2 and
    past it; None without a step or with anneal_iters <= 0."""
    for step in (0, 500, 999, 1000, 2500):
        ref = jnp.clip(jnp.asarray(step, jnp.float32) / 1000.0, 0.0, 1.0)
        assert float(ps.anneal_factor(step, 1000)) == float(ref)
    assert ps.anneal_factor(None, 1000) is None
    assert ps.anneal_factor(10, 0) is None
