"""Port parity of the tri-plane and time-conditioned encoders
(``models/encoding/triplane.py`` and ``dynamic.py``).

Each encoder is built by both packages' ``get_encoder`` from the same config
(4 levels x 2 features, 2^12 rows, base resolution 4, finest 16, 3 frames),
the JAX parameters carried over with ``convert.params_from_jax`` (strict),
and fed the same seeded ``[4, 16, 4]`` points (xyz a little beyond the bbox,
integer frame indices). Forward within 1e-6 of max|out| of the jitted JAX
module; gradients of ``sum(out · G)`` with respect to every parameter and
to the points within 1e-5 of each gradient's max — or, where JAX's own
jitted and eager runs are further apart, within twice their distance (see
the test). The JAX encoders are XLA, so they run as they are; the port's
hash grids take the plain K6/K6b on the CPU, dx included. Also: ``tv_loss``,
the clip-tie gradient, the nine type names and the 7-column rays through the
NeRF network's render.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import jax_tree_numpy

from nerf_replication_tpu.config.node import ConfigNode as JaxNode
from nerf_replication_tpu.models.encoding import get_encoder as jax_get_encoder
from nerf_replication_tpu_torch.config.node import ConfigNode
from nerf_replication_tpu_torch.convert import params_from_jax
from nerf_replication_tpu_torch.models.encoding import get_encoder

N_FRAMES = 3
SMALL = {"num_levels": 2, "level_dim": 2, "base_resolution": 4,
         "log2_hashmap_size": 12, "desired_resolution": 16,
         "num_frames": N_FRAMES}
BBOX = [[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]]
ENCODERS = {
    "triplane": ("triplane", {"bbox": BBOX}),
    "latent": ("cuda_hashgrid_latent", {"bbox": BBOX}),
    "4d": ("cuda_hashgrid_4d", {}),
    "coef": ("cuda_hashgrid_coef", {}),  # built with 2 basis grids here
    "dnerf": ("dnerf", {}),
    "motion2d": ("cuda_motion2d", {}),
    "dnerf_ngp": ("cuda_dnerf_ngp_tensorf", {}),
}
TOL_FWD = 1e-6
TOL_GRAD = 1e-5


def _cfg(enc_type, extra):
    d = {"type": enc_type, "input_dim": 3, **SMALL, **extra}
    return JaxNode(d), ConfigNode(d)


def _points(seed=0, shape=(4, 16)):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.7, 1.7, shape + (3,))
    t = rng.integers(0, N_FRAMES, shape + (1,)).astype(np.float64)
    return np.concatenate([xyz, t], -1).astype(np.float32)


def _pair(name, seed=0):
    enc_type, extra = ENCODERS[name]
    jcfg, pcfg = _cfg(enc_type, extra)
    jmod, jdim = jax_get_encoder(jcfg)
    pmod, pdim = get_encoder(pcfg)
    assert jdim == pdim
    if name == "coef":  # two basis grids keep XLA's compile short
        jmod = jmod.clone(basis_num=2)
        pmod = type(pmod)(pmod.num_frames, BBOX, basis_num=2,
                          hash_kwargs=pmod.hash_kwargs)
    x = _points(seed)
    dim_in = 3 if name == "triplane" else 4
    params = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x[..., :dim_in]))
    pmod.load_state_dict(params_from_jax(jax_tree_numpy(params)), strict=True)
    return jmod, params, pmod, x[..., :dim_in]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _tol(base, jit_val, eager_val) -> float:
    """The stated bound, or twice JAX's own jit-vs-eager distance."""
    return max(base, 2 * _rel(eager_val, jit_val))


def _jax_grads(jmod, params, x, g, jit):
    fn = jax.grad(lambda p, v: jnp.sum(jmod.apply(p, v) * g), argnums=(0, 1))
    gp, gx = (jax.jit(fn) if jit else fn)(params, jnp.asarray(x))
    return params_from_jax(jax_tree_numpy(gp)), np.asarray(gx)


@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_forward_and_grads_match_jax(name):
    """Held to the jitted JAX module. The bound is the stated one (1e-6 of
    max|out|, 1e-5 of each gradient's max) or, where larger, twice the
    distance between JAX's own jitted and eager runs (computed only when
    the stated bound is missed): where XLA folds the bbox normalization
    into each level's scale, or a deformation MLP feeds the hash, the two
    JAX runs round the points differently and differ by up to 8e-5
    themselves."""
    jmod, params, pmod, x = _pair(name)
    out_j = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out_p = pmod(xt)
    assert out_p.shape == out_j.shape
    err = _rel(out_p.detach().numpy(), out_j)
    if err > TOL_FWD:
        out_e = np.asarray(jmod.apply(params, jnp.asarray(x)))
        assert err <= _tol(TOL_FWD, out_j, out_e), name

    g = np.random.default_rng(5).normal(size=out_j.shape).astype(np.float32)
    want, gx = _jax_grads(jmod, params, x, g, jit=True)
    torch.sum(out_p * torch.from_numpy(g)).backward()
    got = dict(pmod.named_parameters())
    assert set(want) == set(got)
    got["x"], want["x"] = xt, torch.from_numpy(gx)
    eager = None
    for key, ref in want.items():
        assert got[key].grad is not None, key
        err = _rel(got[key].grad.numpy(), ref.numpy())
        if err > TOL_GRAD:
            if eager is None:
                eager, gx_e = _jax_grads(jmod, params, x, g, jit=False)
                eager["x"] = torch.from_numpy(gx_e)
            assert err <= _tol(TOL_GRAD, ref.numpy(), eager[key].numpy()), \
                (name, key)


def test_dnerf_ngp_tv_loss_matches_jax():
    jmod, params, pmod, x = _pair("dnerf_ngp", seed=1)
    def tv(p, v):
        return jmod.apply(p, v, method=jmod.tv_loss)

    xj = jnp.asarray(x)
    tv_j = float(jax.jit(tv)(params, xj))
    tv_p = pmod.tv_loss(torch.from_numpy(x))
    assert _rel(float(tv_p.detach()), tv_j) <= _tol(
        TOL_FWD, tv_j, float(tv(params, xj)))
    tv_p.backward()
    grad = jax.grad(tv)
    ref = params_from_jax(jax_tree_numpy(jax.jit(grad)(params, xj)))
    err = _rel(pmod.feat.grad.numpy(), ref["feat"].numpy())
    if err > TOL_GRAD:  # JAX's own jit-vs-eager distance as the bound
        ref_e = params_from_jax(jax_tree_numpy(grad(params, xj)))
        assert err <= _tol(TOL_GRAD, ref["feat"].numpy(),
                           ref_e["feat"].numpy())


def test_clip_tie_gradient_is_jax_not_clamp():
    """``jnp.clip`` is min(max(·)): at x == lo or x == hi JAX hands half
    the gradient through, ``torch.clamp`` all of it. The port's clips
    (``hashgrid.clip``) give JAX's gradient; inside the bbox and strictly
    outside it every version agrees."""
    from nerf_replication_tpu.models.encoding.hashgrid import (
        normalize_bbox as jax_normalize,
    )
    from nerf_replication_tpu_torch.models.encoding.hashgrid import clip

    x = np.array([-1.5, -0.3, 1.5, 2.0, -2.0], np.float32)
    gj = np.asarray(jax.grad(lambda v: jnp.sum(
        jax_normalize(v, (-1.5, 1.5))))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    lo, hi = torch.tensor(-1.5), torch.tensor(1.5)
    (clip(xt, lo, hi) - lo).mul(1.0 / (3.0 + 1e-6)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), gj, rtol=1e-6)
    xc = torch.from_numpy(x).requires_grad_(True)
    torch.clamp(xc, -1.5, 1.5).mul(1.0 / (3.0 + 1e-6)).sum().backward()
    tie = np.abs(x) == 1.5
    np.testing.assert_allclose(xc.grad.numpy()[tie], 2 * gj[tie], rtol=1e-6)
    np.testing.assert_array_equal(xc.grad.numpy()[~tie], xt.grad.numpy()[~tie])
    # the deformation path's tie: a point on the bbox face at frame 0 goes
    # through the hash's clip at exactly 0 — the port's dx is JAX's there
    jmod, params, pmod, _ = _pair("dnerf")
    face = np.array([[[-1.5, 0.2, 0.4, 0.0], [0.1, 1.5, -0.3, 0.0]]],
                    np.float32)
    g_j = np.asarray(jax.jit(jax.grad(
        lambda v: jnp.sum(jmod.apply(params, v))))(jnp.asarray(face)))
    ft = torch.from_numpy(face).requires_grad_(True)
    pmod(ft).sum().backward()
    assert _rel(ft.grad.numpy(), g_j) <= TOL_GRAD


def test_get_encoder_builds_every_type():
    from nerf_replication_tpu.models.encoding import (
        _DYNAMIC_TYPES as JAX_TYPES,
    )
    from nerf_replication_tpu_torch.models.encoding import _DYNAMIC_TYPES

    assert _DYNAMIC_TYPES == JAX_TYPES
    for enc_type in ["triplane", "cuda_triplane", *_DYNAMIC_TYPES]:
        jcfg, pcfg = _cfg(enc_type, {})
        jmod, jdim = jax_get_encoder(jcfg)
        pmod, pdim = get_encoder(pcfg)
        assert type(pmod).__name__ == type(jmod).__name__
        assert pdim == jdim == pmod.out_dim


def test_seeded_init_is_reproducible():
    """reset_parameters draws every table and Dense layer from the
    generator: the same seed gives the same encoder, the tables within
    ±1e-4."""
    _, pcfg = _cfg("cuda_hashgrid_coef", {})
    a, _ = get_encoder(pcfg)
    b, _ = get_encoder(pcfg)
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    for (k, va), (_, vb) in zip(a.state_dict().items(),
                                b.state_dict().items()):
        assert torch.equal(va, vb), k
    assert float(a.coefs.embeddings.detach().abs().max()) <= 1e-4
    assert float(a.coef_hidden.weight.std()) > 0


def test_seven_column_rays_render_through_latent_network():
    """The light-stage network (hash ⊕ latent, D 3 W 32) renders 7-column
    rays as JAX does: the renderer puts the frame index on every sample;
    latent_t[t] picks the truncated index."""
    from test_torch_helpers import both_cfgs

    from nerf_replication_tpu.models import make_network as jax_make_network
    from nerf_replication_tpu.models.nerf.network import (
        init_params as jax_init_params,
    )
    from nerf_replication_tpu.renderer.volume import (
        RenderOptions as JOptions,
        render_rays as jax_render_rays,
    )
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.renderer.volume import (
        RenderOptions,
        render_rays,
    )

    opts = ["network.xyz_encoder.type", "cuda_hashgrid_latent",
            "network.xyz_encoder.num_frames", str(N_FRAMES),
            "network.xyz_encoder.num_levels", "4",
            "network.xyz_encoder.log2_hashmap_size", "12",
            "network.xyz_encoder.base_resolution", "4",
            "network.xyz_encoder.desired_resolution", "32",
            "network.xyz_encoder.bbox", "[[-1.5,-1.5,-1.5],[1.5,1.5,1.5]]",
            "network.nerf.W", "32", "network.nerf.D", "3",
            "network.nerf.skips", "[1]", "task_arg.N_samples", "8",
            "task_arg.N_importance", "8", "task_arg.perturb", "0",
            "task_arg.raw_noise_std", "0"]
    jcfg, pcfg = both_cfgs(opts)
    jnet = jax_make_network(jcfg)
    params = jax_init_params(jnet, jax.random.PRNGKey(0))
    pnet = make_network(pcfg)
    pnet.load_state_dict(params_from_jax(jax_tree_numpy(params)), strict=True)
    rng = np.random.default_rng(2)
    rays = np.concatenate([
        np.tile([0.0, 0.0, 4.0], (16, 1)),
        np.array([0.0, 0.0, -1.0]) + rng.normal(0, 0.15, (16, 3)),
        rng.uniform(0, N_FRAMES - 0.01, (16, 1))], -1).astype(np.float32)
    jout = jax.jit(lambda p, r: jax_render_rays(
        lambda pts, vd, model: jnet.apply(p, pts, vd, model=model), r, 2.0,
        6.0, None, JOptions.from_cfg(jcfg, train=False)))(
            params, jnp.asarray(rays))
    pout = render_rays(lambda pts, vd, model: pnet(pts, vd, model=model),
                       torch.from_numpy(rays), 2.0, 6.0, None,
                       RenderOptions.from_cfg(pcfg, train=False))
    for k in ("rgb_map_c", "rgb_map_f", "acc_map_f"):
        np.testing.assert_allclose(pout[k].detach().numpy(),
                                   np.asarray(jout[k]), atol=1e-5)


@pytest.mark.parametrize("d", [2, 4])
def test_k6b_corner_pair_keys_hold_at_d2_and_d4(d):
    """K6b's corner-pair keys (``scatter_level`` of ``csrc/hash_encode.cu``
    at C = 2, emulated as ``tests/test_torch_hash_kernels.py`` does at D =
    3) at D = 2 and 4, dense levels included, where ``(res + 1)^D`` strides
    differ: a dim-0 pair (b, b + 1) is one key only where its rows share an
    aligned row pair (``r0 ^ r1 == 1``), so the sums stay right whatever
    the stride. dtable within 1e-5 (relative Frobenius) of float64, and
    some pairs do share a row pair on a dense level and on a hashed one."""
    from test_torch_hash_kernels import KEY_NONE, KEY_PAIR, LANES, _fro, \
        reduce_peers
    from test_torch_hashgrid import _oracle64

    from nerf_replication_tpu_torch.models.encoding import hashgrid as phg
    from nerf_replication_tpu_torch.ops import hash_encode as he

    # base 3: (3 + 1)^D rows, a multiple of 8, so level 0 is dense
    geo = phg.level_geometry(d, 3, 2.0, 3, 12)
    assert not geo[3][0] and geo[3][-1]
    rng = np.random.default_rng(d)
    x = rng.random((203, d), dtype=np.float32)  # a ragged last warp
    table = rng.uniform(-1, 1, (geo[0][-1], 2)).astype(np.float32)
    g = rng.normal(0, 1, (x.shape[0], 3 * 2)).astype(np.float32)
    ref_dt, _, _ = _oracle64(x, g, table, geo)
    n = x.shape[0]
    n_pad = -(-n // 32) * 32
    valid = (np.arange(n_pad) < n).reshape(-1, 32)
    none = KEY_NONE | np.broadcast_to(LANES, valid.shape)
    dt = torch.zeros(table.shape, dtype=torch.float32)
    xt = torch.from_numpy(x)
    pairs = []
    for lvl, (off, size, scale, res, hashed) in enumerate(
            phg.geometry_levels(geo)):
        pos_grid, frac = phg.level_terms(xt, scale)
        g_l = torch.from_numpy(g[:, lvl * 2:(lvl + 1) * 2])

        def corner(bits):
            idx = phg._corner_index(he._corners(pos_grid, bits), res, size,
                                    hashed) + off
            wg = (phg.corner_weight(frac, bits)[:, None] * g_l).numpy()
            return (np.pad(idx.numpy(), (0, n_pad - n)).reshape(-1, 32),
                    np.pad(wg, ((0, n_pad - n), (0, 0))).reshape(-1, 32, 2))

        level_pairs = 0
        for b in range(0, 1 << d, 2):
            (r0, v0), (r1, v1) = corner(b), corner(b + 1)
            pair = valid & ((r0 ^ r1) == 1)
            odd = ((r0 & 1) == 1)[..., None]
            lo = np.where(pair[..., None] & odd, v1, v0)
            hi = np.where(pair[..., None], np.where(odd, v0, v1), 0.0)
            key = np.where(valid, np.where(pair, KEY_PAIR | (r0 >> 1), r0),
                           none)
            sums, lead = reduce_peers(
                key, np.concatenate([lo, hi], -1).astype(np.float32))
            lead &= valid
            base = np.where(pair, r0 & ~1, r0)
            dt.index_add_(0, torch.from_numpy(base[lead]),
                          torch.from_numpy(sums[lead][:, :2]))
            both = lead & pair
            dt.index_add_(0, torch.from_numpy(base[both] + 1),
                          torch.from_numpy(sums[both][:, 2:]))
            own = valid & ~pair
            sums1, lead1 = reduce_peers(np.where(own, r1, none), v1)
            lead1 &= own
            dt.index_add_(0, torch.from_numpy(r1[lead1]),
                          torch.from_numpy(sums1[lead1]))
            level_pairs += int(pair.sum())
        pairs.append(level_pairs)
    assert _fro(dt.numpy(), ref_dt) <= 1e-5
    assert pairs[0] > 0 and pairs[-1] > 0, pairs
