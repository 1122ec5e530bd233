"""Port parity of the hash-grid encoders: the plain versions of kernels K6
(forward) and K6b (backward), the cell-packed encoder, both encoders inside
the NeRF Network, and the weights carried across from Flax.

* K6 plain (``ops.hash_encode.forward_plain`` under ``hashgrid.hash_encode``)
  against JAX ``hash_encode`` (eager and jitted) and ``pallas_hash_encode``
  in interpret mode, over ``tests/test_pallas_hash.py``'s five geometry
  cases (one with a dense level), table uniform in [−1, 1]: atol 1e-5.
* On cell faces and at lego_hash's finer levels: both encoders equal the
  forward inside the jitted JAX train step (inputs passed as arguments, as
  the trainer's are) to 1e-6, cell choice included: the step contracts
  ``pos = x·scale + 0.5`` into an FMA, where JAX run eagerly rounds twice —
  the test tells the two apart.
* K6b plain (dtable, dx) and the JAX VJP (``_encode_with_per_level_bwd``)
  against a float64 ``np.add.at`` oracle, each within its own bound: the
  port sums in float32 in order (≤ 1e-6 of max|dtable|); JAX's dtable is a
  difference of float32 prefix sums over each level's sorted rows, off by up
  to ~eps·|prefix| (bound: 4·2^-24 of the level's Σ|w·g|); dx within 1e-5
  of max|dx| on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import both_cfgs, jax_tree_numpy, nets

from nerf_replication_tpu.models.encoding import hashgrid as jhg
from nerf_replication_tpu.models.encoding import packed_hash as jph
from nerf_replication_tpu.models.encoding.pallas_hash import (
    pallas_hash_encode,
)
from nerf_replication_tpu_torch.models.encoding import get_encoder
from nerf_replication_tpu_torch.models.encoding import hashgrid as phg
from nerf_replication_tpu_torch.models.encoding import packed_hash as pph
from nerf_replication_tpu_torch.ops import hash_encode as he

CASES = [
    # (D, L, C, scale, base_res, log2_T) of tests/test_pallas_hash.py
    (3, 4, 2, 1.5, 4, 8),
    (3, 6, 2, 1.39, 16, 11),  # lego_hash geometry, shrunk table
    (2, 3, 4, 2.0, 4, 9),
    (4, 2, 2, 1.5, 3, 10),
    (3, 2, 2, 2.0, 1, 8),  # level 0 is dense: (1+1)^3 = 8 = slice size
]
EPS32 = 2.0 ** -24
HASH_NET = ["network.xyz_encoder.type", "hashgrid",
            "network.xyz_encoder.num_levels", "4",
            "network.xyz_encoder.log2_hashmap_size", "10",
            "network.xyz_encoder.base_resolution", "4",
            "network.xyz_encoder.desired_resolution", "32",
            "network.xyz_encoder.bbox", "[[-1.5,-1.5,-1.5],[1.5,1.5,1.5]]",
            "network.nerf.W", "32", "network.nerf.D", "3",
            "network.nerf.skips", "[1]"]


def _inputs(case, n=300, seed=0):
    d, lvls, c, scale, base, log2_t = case
    geo = phg.level_geometry(d, lvls, scale, base, log2_t)
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (geo[0][-1], c)).astype(np.float32)
    x = rng.uniform(0, 1, (n, d)).astype(np.float32)
    return geo, table, x


@pytest.mark.parametrize("case", CASES)
def test_plain_k6_matches_jax(case):
    d, lvls, c, scale, base, log2_t = case
    geo, table, x = _inputs(case)
    assert tuple(map(list, geo)) == tuple(map(list, jhg.level_geometry(
        d, lvls, scale, base, log2_t)))
    if case == CASES[-1]:
        assert not geo[3][0], "dense-level coverage case regressed"
    args = (d, lvls, scale, base, log2_t)
    got = phg.hash_encode(torch.from_numpy(x), torch.from_numpy(table),
                          *args).numpy()
    xj, tj = jnp.asarray(x), jnp.asarray(table)
    refs = {
        "eager": jhg.hash_encode(xj, tj, *args),
        "jit": jax.jit(lambda a, t: jhg.hash_encode(a, t, *args))(xj, tj),
        "pallas": pallas_hash_encode(xj, tj, *args, block_size=128,
                                     interpret=True),
    }
    for name, ref in refs.items():
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5,
                                   err_msg=name)


# six levels from lego_hash's base 16 up to its finest scale, 1023
LEGO_LEVELS = (3, 6, float(2 ** (np.log2(1024 / 16) / 5)), 16, 11)


def _face_points(scales, d, n_random=400, seed=1):
    """Points whose first coordinate puts ``x·scale + 0.5`` (one FMA)
    exactly on an integer — a cell face — at some level, then random
    points (at lego_hash's finer levels an FMA and two roundings give
    ``pos`` an ulp apart on ~1 point in 30)."""
    xs = []
    for s in scales:
        s32 = np.float32(s)
        for k in range(1, int(s) + 1, max(1, int(s) // 16)):
            x = np.float32((k - 0.5) / np.float64(s32))
            for _ in range(16):
                f = np.float32(np.float64(x) * np.float64(s32) + 0.5)
                if f == k:
                    xs.append(x)
                    break
                x = np.nextafter(x, np.float32(2.0 if f < k else -1.0),
                                 dtype=np.float32)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (len(xs) + n_random, d)).astype(np.float32)
    pts[:len(xs), 0] = xs
    return pts, len(xs)


def test_plain_encoders_round_pos_as_the_jitted_train_step():
    """On cell faces and at lego_hash's levels (scale up to 1023), both
    encoders equal what the jitted JAX train step computes (the forward
    inside ``jax.jit(jax.value_and_grad(...))`` with x an argument) to
    1e-6 — its pos is one FMA. JAX run eagerly rounds pos twice: that is
    off by more than 3e-6 here (an ulp of pos ~1000 moves frac by 6e-5),
    so the test tells the two roundings apart. For the packed grid the
    field jumps at a face: a different cell would be off by the table's
    scale."""
    args = LEGO_LEVELS
    geo = phg.level_geometry(*args)
    pgeo = pph.packed_level_geometry(*args)
    x, n_face = _face_points(geo[1], 3)
    assert n_face > 80
    rng = np.random.default_rng(2)
    g = jnp.asarray(rng.normal(0, 1, (x.shape[0], 12)).astype(np.float32))
    xj = jnp.asarray(x)
    for port_fn, jax_fn, shape in (
            (phg.hash_encode, jhg._encode_with_per_level_bwd,
             (geo[0][-1], 2)),
            (pph.packed_hash_encode, jph.packed_hash_encode_vjp,
             (pgeo[0][-1], 16))):
        table = rng.uniform(-1, 1, shape).astype(np.float32)
        tj = jnp.asarray(table)

        def loss(t, a, gg, jax_fn=jax_fn):
            out = jax_fn(a, t, *args)
            return jnp.sum(out * gg), out

        (_, step_out), _ = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            tj, xj, g)
        eager = jax_fn(xj, tj, *args)
        got = port_fn(torch.from_numpy(x), torch.from_numpy(table),
                      *args).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(step_out), rtol=0,
                                   atol=1e-6)
        assert np.abs(np.asarray(eager) - got).max() > 3e-6


def _index64(corner, res, size, hashed):
    primes = jhg._PRIMES
    idx = np.zeros(corner.shape[0], np.uint64)
    stride = 1
    for dd in range(corner.shape[1]):
        cd = corner[:, dd].astype(np.uint64)
        if hashed:
            idx ^= (cd * np.uint64(primes[dd])) & np.uint64(0xFFFFFFFF)
        else:
            idx = (idx + cd * np.uint64(stride)) & np.uint64(0xFFFFFFFF)
            stride *= res + 1
    return (idx % np.uint64(size)).astype(np.int64)


def _oracle64(x, g, table, geo):
    """Float64 dtable (``np.add.at``) and closed-form dx of the float32
    positions, plus each level's Σ|w·g| (the magnitude of JAX's prefix
    sums)."""
    offsets, scales, resolutions, use_hash = geo
    n, d = x.shape
    c = table.shape[1]
    dt = np.zeros(table.shape, np.float64)
    dx = np.zeros((n, d))
    mags = []
    for lvl, s in enumerate(scales):
        s32 = np.float32(s)
        # pos as the function defines it (float32, one FMA), the rest in
        # float64
        pos32 = np.float32(x.astype(np.float64) * np.float64(s32) + 0.5)
        grid = np.floor(pos32).astype(np.int64)
        frac = (pos32 - grid).astype(np.float64)
        g_l = g[:, lvl * c:(lvl + 1) * c].astype(np.float64)
        mag = 0.0
        for b in range(1 << d):
            sel = np.array([(b >> dd) & 1 for dd in range(d)])
            fac = np.where(sel, frac, 1.0 - frac)
            idx = _index64(grid + sel, resolutions[lvl],
                           offsets[lvl + 1] - offsets[lvl], use_hash[lvl])
            idx = idx + offsets[lvl]
            upd = np.prod(fac, -1)[:, None] * g_l
            mag += np.abs(upd).sum()
            np.add.at(dt, idx, upd)
            rowg = (table[idx].astype(np.float64) * g_l).sum(-1)
            for dd in range(d):
                other = np.prod(np.delete(fac, dd, axis=1), -1)
                dx[:, dd] += np.float64(s32) * (1.0 if sel[dd] else -1.0) \
                    * other * rowg
        mags.append(mag)
    return dt, dx, max(mags)


@pytest.mark.parametrize("case", [CASES[1], CASES[2]])
def test_plain_k6b_and_jax_vjp_against_float64(case):
    d, lvls, c, scale, base, log2_t = case
    geo, table, x = _inputs(case, n=400, seed=3)
    g = np.random.default_rng(4).normal(
        0, 1, (x.shape[0], lvls * c)).astype(np.float32)
    ref_dt, ref_dx, mag = _oracle64(x, g, table, geo)
    dt, dx = he.backward_plain(torch.from_numpy(x), torch.from_numpy(g),
                               torch.from_numpy(table), geo, want_dx=True)
    args = (d, lvls, scale, base, log2_t)

    @jax.jit
    def vjp(a, t, gg):
        return jax.vjp(lambda a_, t_: jhg._encode_with_per_level_bwd(
            a_, t_, *args), a, t)[1](gg)

    jdx, jdt = (np.asarray(a) for a in vjp(jnp.asarray(x),
                                            jnp.asarray(table),
                                            jnp.asarray(g)))
    top_dt, top_dx = np.abs(ref_dt).max(), np.abs(ref_dx).max()
    assert np.abs(dt.numpy() - ref_dt).max() <= 1e-6 * top_dt
    assert np.abs(jdt - ref_dt).max() <= 4 * EPS32 * mag
    assert np.abs(dx.numpy() - ref_dx).max() <= 1e-5 * top_dx
    assert np.abs(jdx - ref_dx).max() <= 1e-5 * top_dx
    # the autograd Function routes the same plain backward
    xt = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    (he.encode(xt, tt, geo) * torch.from_numpy(g)).sum().backward()
    assert torch.equal(tt.grad, dt) and torch.equal(xt.grad, dx)


def test_geometry_matches_jax_and_the_lego_hash_table():
    """Both layouts' level geometry equals the JAX package's; lego_hash's
    full table is 5,738,832 entries × 2 with 14 of its 16 levels hashed."""
    for case in CASES:
        d, lvls, c, scale, base, log2_t = case
        args = (d, lvls, scale, base, log2_t)
        assert pph.packed_level_geometry(*args) == \
            jph.packed_level_geometry(*args)
    _, pcfg = both_cfgs(["network.xyz_encoder.type", "hashgrid",
                         "network.xyz_encoder.num_levels", "16",
                         "network.xyz_encoder.log2_hashmap_size", "19",
                         "network.xyz_encoder.desired_resolution", "1024",
                         "network.xyz_encoder.bbox",
                         "[[-1.5,-1.5,-1.5],[1.5,1.5,1.5]]"])
    enc, out_dim = get_encoder(pcfg.network.xyz_encoder)
    assert out_dim == 32
    assert tuple(enc.embeddings.shape) == (5_738_832, 2)
    assert sum(enc.geometry[3]) == 14
    jenc = jhg.HashGridEncoder(num_levels=16, log2_hashmap_size=19,
                               desired_resolution=1024)
    assert jenc.n_entries == enc.n_entries
    assert enc.scale_factor == jenc.scale_factor


@pytest.mark.parametrize("enc_type", ["hashgrid", "hashgrid_packed"])
def test_encoder_in_network_matches_flax(enc_type):
    """The Flax Network with a hash encoder and the port's on the same
    carried weights: raw outputs of coarse and fine within 1e-6, and the
    table's and every MLP weight's gradient after one loss within 1e-5 of
    that tensor's max |grad| (float32 sums in another order)."""
    extra = list(HASH_NET)
    extra[1] = enc_type
    jnet, params, pnet = nets(extra=extra)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1.6, 1.6, (8, 5, 3)).astype(np.float32)
    dirs = rng.normal(0, 1, (8, 3)).astype(np.float32)
    tgt = rng.normal(0, 1, (8, 5, 4)).astype(np.float32)
    pj, dj = jnp.asarray(pts), jnp.asarray(dirs)
    for model in ("coarse", "fine"):
        jr = np.asarray(jax.jit(lambda p, a, b, m=model: jnet.apply(
            p, a, b, model=m))(params, pj, dj))
        pr = pnet(torch.from_numpy(pts), torch.from_numpy(dirs),
                  model=model).detach().numpy()
        np.testing.assert_allclose(pr, jr, rtol=0, atol=1e-6, err_msg=model)
    jg = jax_tree_numpy(jax.jit(jax.grad(lambda p, a, b, t: jnp.sum(
        (jnet.apply(p, a, b, model="fine") - t) ** 2)))(
            params, pj, dj, jnp.asarray(tgt)))["params"]
    loss = ((pnet(torch.from_numpy(pts), torch.from_numpy(dirs),
                  model="fine") - torch.from_numpy(tgt)) ** 2).sum()
    loss.backward()
    pairs = [(pnet.xyz_encoder.embeddings.grad.numpy(),
              jg["xyz_encoder"]["embeddings"])]
    for name, leaf in jg["fine"].items():
        mod = getattr(pnet.fine, name)
        pairs += [(mod.weight.grad.numpy().T, leaf["kernel"]),
                  (mod.bias.grad.numpy(), leaf["bias"])]
    for a, b in pairs:
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1e-12)
    assert pnet.coarse.pts_linear_0.weight.grad is None


def test_packed_encode_and_backward_match_jax():
    """The packed encoder (f32 and bf16 gather rows) and its closed-form
    backward against the JAX custom VJP: outputs within 1e-6, dtable within
    1e-5 of max|dtable| (JAX's prefix-sum histogram against index_add_),
    dx within 1e-5 of max|dx|."""
    d, lvls, c, scale, base, log2_t = CASES[1]
    args = (d, lvls, scale, base, log2_t)
    geo = pph.packed_level_geometry(*args)
    rng = np.random.default_rng(5)
    table = rng.uniform(-1, 1, (geo[0][-1], 8 * c)).astype(np.float32)
    x = rng.uniform(0, 1, (200, d)).astype(np.float32)
    g = rng.normal(0, 1, (200, lvls * c)).astype(np.float32)
    for gather in ("float32", "bfloat16"):
        @jax.jit
        def fwd_bwd(a, t, gg, gather=gather):
            out, vjp = jax.vjp(lambda a_, t_: jph.packed_hash_encode_vjp(
                a_, t_, *args, gather), a, t)
            return out, vjp(gg)

        out, (jdx, jdt) = fwd_bwd(jnp.asarray(x), jnp.asarray(table),
                                  jnp.asarray(g))
        jdx, jdt = np.asarray(jdx), np.asarray(jdt)
        xt = torch.from_numpy(x).requires_grad_()
        tt = torch.from_numpy(table).requires_grad_()
        got = pph.packed_hash_encode(xt, tt, *args, gather)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                                   rtol=0, atol=1e-6, err_msg=gather)
        (got * torch.from_numpy(g)).sum().backward()
        for a, b in ((tt.grad.numpy(), jdt), (xt.grad.numpy(), jdx)):
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), gather


def test_indexed_row_sum_matches_np_add_at():
    from nerf_replication_tpu_torch.ops.histogram import indexed_row_sum

    rng = np.random.default_rng(6)
    idx = rng.integers(0, 37, 1000)
    rows = rng.normal(0, 1, (1000, 5)).astype(np.float32)
    ref = np.zeros((40, 5))
    np.add.at(ref, idx, rows.astype(np.float64))
    got = indexed_row_sum(torch.from_numpy(idx), torch.from_numpy(rows), 40)
    assert got.dtype == torch.float32 and tuple(got.shape) == (40, 5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    assert not got[37:].any()  # empty buckets stay exactly zero


@pytest.mark.parametrize("enc_type", ["hashgrid", "hashgrid_packed"])
def test_params_from_jax_carries_the_table(enc_type):
    """``{"xyz_encoder": {"embeddings": ...}}`` lands untransposed at
    ``xyz_encoder.embeddings``; every leaf is accounted for."""
    extra = list(HASH_NET)
    extra[1] = enc_type
    _, params, pnet = nets(extra=extra)
    tree = jax_tree_numpy(params)["params"]
    table = tree["xyz_encoder"]["embeddings"]
    assert table.shape[1] == (2 if enc_type == "hashgrid" else 16)
    np.testing.assert_array_equal(
        pnet.state_dict()["xyz_encoder.embeddings"].numpy(), table)
    n_leaves = sum(len(v) if "embeddings" in v else 2 * len(v)
                   for v in tree.values())
    assert n_leaves == len(pnet.state_dict())


def test_dispatch_refusals_and_kernel_checks():
    """A hash grid without bbox is refused; the triplane and dynamic
    encoders build; the wrappers check shapes before any kernel
    (the kernels take D ≤ 4, C ≤ 8, L ≤ 32 — checked for CUDA tensors
    only, the plain version takes any)."""
    _, pcfg = both_cfgs(["network.xyz_encoder.type", "hashgrid"])
    with pytest.raises(ValueError, match="bbox"):
        get_encoder(pcfg.network.xyz_encoder)
    for typ, cls in (("triplane", "TriPlaneEncoder"),
                     ("dnerf", "DNeRFEncoder")):
        _, pcfg = both_cfgs(["network.xyz_encoder.type", typ,
                             "network.xyz_encoder.log2_hashmap_size", "10",
                             "network.xyz_encoder.num_levels", "2"])
        assert type(get_encoder(pcfg.network.xyz_encoder)[0]).__name__ == cls
    geo, table, x = _inputs(CASES[0], n=8)
    with pytest.raises(ValueError, match="rows"):
        he.hash_encode_fwd(torch.from_numpy(x), torch.zeros(5, 2), geo)
    with pytest.raises(ValueError, match="g must be"):
        he.hash_encode_bwd(torch.from_numpy(x), torch.zeros(8, 3),
                           torch.from_numpy(table), geo)
    # the plain version takes widths the kernels refuse
    wide = torch.zeros(table.shape[0], 3)
    assert tuple(he.hash_encode_fwd(torch.from_numpy(x), wide, geo).shape) \
        == (8, 4 * 3)
    assert he.LAUNCHES == {"hash_encode_fwd": 0, "hash_encode_bwd": 0}


def test_init_and_bf16_clone_share_the_table():
    """init_params draws the table uniform in ±1e-4 from the generator
    (the same seed, the same table); a bf16-compute clone shares the table
    and the encoder's output stays float32."""
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.models.nerf.network import init_params

    _, pcfg = both_cfgs(HASH_NET)
    nets_ = [make_network(pcfg) for _ in range(2)]
    for net in nets_:
        init_params(net, torch.Generator().manual_seed(3))
    t = nets_[0].xyz_encoder.embeddings
    assert torch.equal(t, nets_[1].xyz_encoder.embeddings)
    assert float(t.detach().abs().max()) <= 1e-4
    assert float(t.detach().std()) > 3e-5
    bf = nets_[0].clone(torch.bfloat16)
    assert bf.xyz_encoder.embeddings is t
    pts = torch.rand(4, 3, 3) * 2 - 1
    assert bf.xyz_encoder(pts).dtype == torch.float32
    raw = bf(pts, torch.randn(4, 3), model="fine")
    assert raw.shape == (4, 3, 4) and torch.isfinite(raw).all()
