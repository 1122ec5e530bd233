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
the weight gradients are rounded to bf16 on both sides).

The masked path (K3a/K3b, ``fused_mlp_raw_masked``) under a sorted valid
prefix, a random 60% and an all-invalid mask, f32 at the same tolerances:
invalid rows give raw 0 exactly and all-invalid gives zero gradients.

K2's two kernels through their plain versions in turn (K2a's
``backward_rows``, K2b's chunked ``weight_grads``), f32 and bf16, unmasked
and masked, against ``backward_tile`` and the JAX custom VJP."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import jax_tree_numpy, nets

from nerf_replication_tpu.ops.fused_mlp import (
    fused_mlp_raw as jax_fused_mlp_raw,
    fused_mlp_raw_masked as jax_masked,
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


# -- the masked MLP (K3a/K3b plain versions) -------------------------------

def _mask(kind: str, m: int) -> np.ndarray:
    rng = np.random.default_rng(21)
    if kind == "sorted":  # the packed stream: a valid prefix
        return (np.arange(m) < m // 5).astype(np.float32)
    if kind == "random":
        return (rng.random(m) < 0.6).astype(np.float32)
    return np.zeros(m, np.float32)


@pytest.mark.parametrize("kind", ["sorted", "random", "all_invalid"])
def test_masked_fused_mlp_matches_jax_vjp(setup, kind):
    """``fused_mlp_raw_masked`` (plain K3a forward, K3b backward through
    autograd) against the JAX one and its custom VJP under the Pallas
    interpreter: raw, dx, dv and every parameter gradient. Invalid rows
    give raw 0 exactly; all-invalid gives zero gradients exactly."""
    jnet, params, pnet, x_enc, d_enc, ct = setup
    valid = _mask(kind, M)
    jspec = jax_spec_for(jnet)
    raw_j, vjp = jax.vjp(
        lambda b, x, d: jax_masked(jspec, b, x, d, jnp.asarray(valid),
                                   tile=TILE),
        params["params"]["fine"], jnp.asarray(x_enc), jnp.asarray(d_enc))
    g_branch, g_x, g_d = vjp(jnp.asarray(ct))
    g_branch = jax_tree_numpy(g_branch)

    pspec = fmlp.fused_spec_for(pnet)
    pnet.zero_grad()
    x = torch.from_numpy(x_enc).requires_grad_(True)
    d = torch.from_numpy(d_enc).requires_grad_(True)
    raw = fmlp.fused_mlp_raw_masked(pspec, pnet.fine, x, d,
                                    torch.from_numpy(valid), tile=TILE)
    raw.backward(torch.from_numpy(ct))
    assert not raw.detach()[valid == 0].any()
    np.testing.assert_allclose(raw.detach().numpy(), np.asarray(raw_j),
                               rtol=0, atol=1e-5)
    if kind == "all_invalid":
        assert float(x.grad.abs().max()) == 0.0
        for p in pnet.fine.parameters():
            assert float(p.grad.abs().max()) == 0.0
        return
    assert _rel(x.grad.numpy(), np.asarray(g_x)) <= 1e-5
    assert _rel(d.grad.numpy(), np.asarray(g_d)) <= 1e-5
    for name, layer in pnet.fine.named_children():
        ref = g_branch[name]
        assert _rel(layer.weight.grad.T.numpy(), ref["kernel"]) <= 1e-5, name
        assert _rel(layer.bias.grad.numpy(), ref["bias"]) <= 1e-5, name


def test_masked_wrappers_are_unmasked_times_valid(setup):
    """On CPU tensors: K3a's plain version is K1's times the bit, K3b's is
    K2's with ``draw × valid``; no launch is counted."""
    _, _, pnet, x_enc, d_enc, ct = setup
    spec = fmlp.fused_spec_for(pnet)
    x = fmlp._pad_rows(fmlp._pad_cols(torch.from_numpy(x_enc),
                                      spec.c_in_pad), 256)
    v = fmlp._pad_rows(fmlp._pad_cols(torch.from_numpy(d_enc),
                                      spec.c_views_pad), 256)
    draw = fmlp._pad_rows(fmlp._pad_cols(torch.from_numpy(ct), 8), 256)
    valid = fmlp._pad_rows(torch.from_numpy(_mask("random", M)), 256)
    flat = [t.detach() for t in spec.flatten_params(pnet.fine)]
    before = dict(fmlp.LAUNCHES)
    raw_m = fmlp.mlp_forward(spec, x, v, flat, M, valid=valid)
    raw = fmlp.mlp_forward(spec, x, v, flat, M)
    assert torch.equal(raw_m, raw * valid[:, None])
    dx_m, dv_m, g_m = fmlp.mlp_backward(spec, x, v, draw, flat, M,
                                        valid=valid)
    dx, dv, g = fmlp.mlp_backward(spec, x, v, draw * valid[:, None], flat, M)
    assert torch.equal(dx_m, dx) and torch.equal(dv_m, dv)
    for a, b in zip(g_m, g):
        assert torch.equal(a, b)
    assert fmlp.LAUNCHES == before
    with pytest.raises(ValueError, match="valid"):
        fmlp.mlp_forward(spec, x, v, flat, M, valid=valid[:10])


# -- K2's two phases (K2a rows, K2b weight gradients), plain ----------------

# K2b's row ranges in a chunked run: the 64-row tiles of two chunks of 128
# rows (the second one ragged), each tile a split
K2B_BOUNDS = [(0, 64), (64, 128), (128, 185)]


@pytest.mark.parametrize("dtype,masked", [
    ("float32", False), ("float32", True), ("bfloat16", False),
    ("bfloat16", True)])
def test_k2a_k2b_plain_phases_match(setup, dtype, masked):
    """The plain versions of K2's kernels in turn: K2a's (``backward_rows``:
    dx, dv and the operands it writes to its scratch — the activations and
    the masked per-layer cotangents) and K2b's (``weight_grads``: ``t_dot``
    and column sums over row ranges, summed in order; here split at tile
    and chunk boundaries). Held against ``backward_tile`` (dx/dv equal,
    gradients within 1e-6 of max|value|: only the order of the row sums
    differs) and, through the flatten's VJP, against the JAX custom VJP
    under the Pallas interpreter at the file's tolerances (f32 1e-5 of
    max|value|, bf16 1e-2); masked: the K3b cotangent draw × valid."""
    jnet, params, pnet, x_enc, d_enc, ct = setup
    rel_tol = 1e-5 if dtype == "float32" else 1e-2
    valid = _mask("random", M) if masked else None
    jspec = jax_spec_for(jnet.clone(
        compute_dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32))
    if masked:
        def apply(b, x, d):
            return jax_masked(jspec, b, x, d, jnp.asarray(valid), tile=TILE)
    else:
        def apply(b, x, d):
            return jax_fused_mlp_raw(jspec, b, x, d, tile=TILE)
    _, vjp = jax.vjp(apply, params["params"]["fine"], jnp.asarray(x_enc),
                     jnp.asarray(d_enc))
    g_branch, g_x, g_d = vjp(jnp.asarray(ct))
    g_branch = jax_tree_numpy(g_branch)

    spec = fmlp.fused_spec_for(pnet.clone(getattr(torch, dtype)))
    x = fmlp._pad_cols(torch.from_numpy(x_enc), spec.c_in_pad)
    v = fmlp._pad_cols(torch.from_numpy(d_enc), spec.c_views_pad)
    draw = fmlp._pad_cols(torch.from_numpy(ct), 8)
    if masked:
        draw = draw * torch.from_numpy(valid)[:, None]
    pnet.zero_grad()
    flat = spec.flatten_params(pnet.fine)
    ws = [t.detach() for t in flat]
    dx, dv, rows = fmlp.backward_rows(spec, x, v, draw, ws)
    assert len(rows["dz"]) == spec.D and len(rows["acts"]) == spec.D + 2
    grads = fmlp.weight_grads(spec, rows, K2B_BOUNDS)
    rdx, rdv, rgrads = fmlp.backward_tile(spec, x, v, draw, ws)
    assert torch.equal(dx, rdx) and torch.equal(dv, rdv)
    for g, r in zip(grads, rgrads):
        assert g.shape == r.shape and _rel(g.numpy(), r.numpy()) <= 1e-6
    if masked:  # invalid rows carry no cotangent
        assert not dx[torch.from_numpy(valid) == 0].any()

    torch.autograd.backward(flat, [g.to(t.dtype) for g, t in zip(grads,
                                                                 flat)])
    assert _rel(dx[:, :x_enc.shape[1]].numpy(), np.asarray(g_x)) <= rel_tol
    assert _rel(dv[:, :d_enc.shape[1]].numpy(), np.asarray(g_d)) <= rel_tol
    for name, layer in pnet.fine.named_children():
        ref = g_branch[name]
        assert _rel(layer.weight.grad.T.numpy(),
                    np.asarray(ref["kernel"], np.float32)) <= rel_tol, name
        assert _rel(layer.bias.grad.numpy(),
                    np.asarray(ref["bias"], np.float32)) <= rel_tol, name
