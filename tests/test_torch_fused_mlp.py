"""Port parity of the fused MLP (ops/fused_mlp.py): the plain versions of K1
and K2, run through ``FusedMLPFunction`` (autograd), against the JAX
``fused_mlp_raw`` and its custom VJP under the Pallas interpreter, as
``tests/test_fused_mlp.py`` runs it.

D=4, W=128, skip after layer 1, 63/27-wide encodings, a ragged row count
against both the 64-row tile and the host padding (M = 185, tile 64), the
f32 and the bf16 families. Checked: raw, dx, dv and the gradient of every
parameter of the branch (after the flatten's transposes, pads and casts).
Tolerances: f32 raw atol 1e-5, gradients within 1e-5 of the largest |value|
of their tensor (sums over rows in another order than XLA's); bf16 raw atol
2e-3 and gradients within 1e-2 (an f32 activation that differs by an ulp
can round to the neighbouring bf16 value and carry that through the chain;
the weight gradients are rounded to bf16 on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import jax_tree_numpy, nets

from nerf_replication_tpu.ops.fused_mlp import (
    fused_mlp_raw as jax_fused_mlp_raw,
    fused_spec_for as jax_spec_for,
)
from nerf_replication_tpu_torch.ops import fused_mlp as fmlp

NET = ["network.nerf.W", "128", "network.nerf.D", "4",
       "network.nerf.skips", "[1]"]
M, TILE = 185, 64


@pytest.fixture(scope="module")
def setup():
    jnet, params, pnet = nets(extra=NET, seed=1)
    # non-zero biases (init leaves them zero) so every bias path is held
    rng = np.random.default_rng(11)
    tree = jax_tree_numpy(params)
    for layers in tree["params"].values():
        for leaf in layers.values():
            leaf["bias"] = rng.normal(0, 0.05, leaf["bias"].shape).astype(
                np.float32)
    from nerf_replication_tpu_torch.convert import params_from_jax

    pnet.load_state_dict(params_from_jax(tree), strict=True)
    params = jax.tree.map(jnp.asarray, tree)
    pts = rng.uniform(-1.5, 1.5, (M, 3)).astype(np.float32)
    d = rng.normal(0, 1, (M, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x_enc = pnet.xyz_encoder(torch.from_numpy(pts)).numpy()
    d_enc = pnet.dir_encoder(torch.from_numpy(d)).numpy()
    ct = rng.normal(0, 1, (M, 4)).astype(np.float32)
    return jnet, params, pnet, x_enc, d_enc, ct


def _run(setup, dtype):
    jnet, params, pnet, x_enc, d_enc, ct = setup
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    jspec = jax_spec_for(jnet.clone(compute_dtype=jd))
    branch = params["params"]["fine"]
    raw_j, vjp = jax.vjp(
        lambda b, x, d: jax_fused_mlp_raw(jspec, b, x, d, tile=TILE),
        branch, jnp.asarray(x_enc), jnp.asarray(d_enc))
    g_branch, g_x, g_d = vjp(jnp.asarray(ct))

    pspec = fmlp.fused_spec_for(pnet.clone(td))
    pnet.zero_grad()
    x = torch.from_numpy(x_enc).requires_grad_(True)
    d = torch.from_numpy(d_enc).requires_grad_(True)
    raw_p = fmlp.fused_mlp_raw(pspec, pnet.fine, x, d, tile=TILE)
    raw_p.backward(torch.from_numpy(ct))
    grads = {}
    for name, layer in pnet.fine.named_children():
        grads[name] = (layer.weight.grad.T.numpy(), layer.bias.grad.numpy())
    return (np.asarray(raw_j), np.asarray(g_x), np.asarray(g_d),
            jax_tree_numpy(g_branch)), (raw_p.detach().numpy(),
                                        x.grad.numpy(), d.grad.numpy(), grads)


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max()) / max(
        float(np.abs(b).max()), 1e-30)


@pytest.mark.parametrize("dtype,raw_tol,rel_tol", [
    ("float32", 1e-5, 1e-5), ("bfloat16", 2e-3, 1e-2)])
def test_k1_k2_plain_match_jax_vjp(setup, dtype, raw_tol, rel_tol):
    (raw_j, gx_j, gd_j, gb_j), (raw_p, gx_p, gd_p, gb_p) = _run(setup, dtype)
    assert raw_p.shape == (M, 4)
    np.testing.assert_allclose(raw_p, raw_j, rtol=0, atol=raw_tol)
    assert _rel(gx_p, gx_j) <= rel_tol
    assert _rel(gd_p, gd_j) <= rel_tol
    assert set(gb_p) == set(gb_j)
    for name, (gw, gb) in gb_p.items():
        assert gw.shape == gb_j[name]["kernel"].shape, name
        assert _rel(gw, np.asarray(gb_j[name]["kernel"], np.float32)) \
            <= rel_tol, name
        assert _rel(gb, np.asarray(gb_j[name]["bias"], np.float32)) \
            <= rel_tol, name


def test_plain_backward_is_autograd_of_the_forward(setup):
    """``backward_tile`` (the K2 plain version) equals autograd through
    ``forward_tile`` (f32): the same chain, the same products."""
    _, _, pnet, x_enc, d_enc, ct = setup
    spec = fmlp.fused_spec_for(pnet)
    x = fmlp._pad_cols(torch.from_numpy(x_enc), spec.c_in_pad)
    v = fmlp._pad_cols(torch.from_numpy(d_enc), spec.c_views_pad)
    draw = fmlp._pad_cols(torch.from_numpy(ct), 8)
    flat = [t.detach().requires_grad_(True)
            for t in spec.flatten_params(pnet.fine)]
    xr, vr = x.clone().requires_grad_(True), v.clone().requires_grad_(True)
    fmlp.forward_tile(spec, xr, vr, flat).backward(draw)
    dx, dv, grads = fmlp.backward_tile(spec, x, v, draw,
                                       [t.detach() for t in flat])
    torch.testing.assert_close(dx, xr.grad, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(dv, vr.grad, rtol=1e-6, atol=1e-7)
    for g, t in zip(grads, flat):
        torch.testing.assert_close(g, t.grad, rtol=1e-6, atol=1e-7)


def test_wrappers_pad_and_skip_rows(setup):
    """K1/K2 wrappers on CPU tensors: rows past ``m`` give raw 0 and dx/dv
    0; dx/dv are None unless asked for; no kernel launch is counted."""
    _, _, pnet, x_enc, d_enc, ct = setup
    spec = fmlp.fused_spec_for(pnet)
    x = fmlp._pad_rows(fmlp._pad_cols(torch.from_numpy(x_enc),
                                      spec.c_in_pad), 256)
    v = fmlp._pad_rows(fmlp._pad_cols(torch.from_numpy(d_enc),
                                      spec.c_views_pad), 256)
    draw = fmlp._pad_rows(fmlp._pad_cols(torch.from_numpy(ct), 8), 256)
    flat = [t.detach() for t in spec.flatten_params(pnet.fine)]
    before = dict(fmlp.LAUNCHES)
    raw = fmlp.mlp_forward(spec, x, v, flat, M)
    dx, dv, grads = fmlp.mlp_backward(spec, x, v, draw, flat, M)
    none_x, none_v, grads2 = fmlp.mlp_backward(spec, x, v, draw, flat, M,
                                               want_dx=False, want_dv=False)
    assert fmlp.LAUNCHES == before
    assert raw.shape == (256, 8) and float(raw[M:].abs().max()) == 0.0
    assert float(dx[M:].abs().max()) == 0.0 and dv.shape == v.shape
    assert none_x is None and none_v is None
    for a, b in zip(grads, grads2):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="x must be"):
        fmlp.mlp_forward(spec, x[:, :10], v, flat, M)
