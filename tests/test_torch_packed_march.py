"""Port parity of the staged occupancy marches: ``renderer/accelerated.py``
(``occupancy_sweep``, ``march_rays_accelerated``) and
``renderer/packed_march.py`` (flat, hierarchical and bbox-clipped packed
march, ``return_samples``) against the JAX package on the same inputs and
weights (D=4, W=32; a 16³ grid; rays from a numpy seed), and the packed
march through the masked fused apply (K3a/K3b's plain versions; their own
parity with JAX is in ``test_torch_fused_mlp.py``).

The JAX marches run under ``jax.jit``, as ``Renderer.render_accelerated``
runs them: XLA then evaluates the march positions and points as fused
multiply-adds, which the port reproduces. Tolerances: voxel ids, validity,
``truncated``, ``overflow_frac`` and the traversal counts exact; maps
``atol 1e-5`` (the MLP products sum in another order; the per-ray march's
depth 1e-4); the sweep's returned
positions within one float32 ulp of 6 (XLA materializes them unfused beside
the fused points); the compositing alone (an MLP-free apply) 1e-5 against
JAX's float32 sums and 1e-5 against a float64 composite."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (
    BBOX,
    FAR,
    NEAR,
    jax_tree_numpy,
    nets,
)

from nerf_replication_tpu.renderer.accelerated import (
    MarchOptions as JaxMarchOptions,
    march_rays_accelerated as jax_accel,
    occupancy_sweep as jax_sweep,
)
from nerf_replication_tpu.renderer.packed_march import (
    march_rays_packed as jax_packed,
)
from nerf_replication_tpu_torch.ops import fused_mlp as fmlp
from nerf_replication_tpu_torch.renderer import accelerated as pa
from nerf_replication_tpu_torch.renderer import packed_march as pm
from nerf_replication_tpu_torch.renderer.accelerated import MarchOptions
from nerf_replication_tpu_torch.renderer.occupancy import world_to_voxel

BASE = dict(step_size=0.0625, max_samples=24, chunk_size=64)


def _grid(res=16, seed=0):
    """A ball plus scattered voxels: rays cross several occupied runs."""
    c = (np.arange(res) + 0.5) / res * 2.0 - 1.0
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    g = (x * x + y * y + z * z) < 0.55 ** 2
    return g | (np.random.default_rng(seed).random(g.shape) < 0.08)


def _rays(n=48, seed=3, n_zero=4):
    """Rays from around (0, 0, 4) into the bbox (unit directions, so t in
    [NEAR, FAR] crosses it), zero-direction padding at the end."""
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.8, (n, 3)) + np.array([0.0, 0.0, 4.0])
    d = rng.normal(0, 0.4, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d], -1).astype(np.float32)
    rays[n - n_zero:] = 0.0
    return rays


def _opts(**kw):
    o = dict(BASE, **kw)
    return JaxMarchOptions(**o), MarchOptions(**o)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def setup():
    jnet, params, pnet = nets(seed=2)
    # non-zero biases, so densities are not all near zero
    rng = np.random.default_rng(5)
    tree = jax_tree_numpy(params)
    for layers in tree["params"].values():
        for leaf in layers.values():
            leaf["bias"] = rng.normal(0, 0.3, leaf["bias"].shape).astype(
                np.float32)
    from nerf_replication_tpu_torch.convert import params_from_jax

    pnet.load_state_dict(params_from_jax(tree), strict=True)
    params = jax.tree.map(jnp.asarray, tree)
    return jnet, params, pnet


def _applies(jnet, params, pnet):
    def japply(pts, vd, model, valid=None):
        return jnet.apply(params, pts, vd, model=model)

    def papply(pts, vd, model):
        return pnet(pts, vd, model=model)

    return japply, papply


def _zero_applies():
    """MLP-free applies for the voxel-id checks: σ = 1 everywhere."""
    def japply(pts, vd, model, valid=None):
        return jnp.ones(pts.shape[:-1] + (4,), jnp.float32)

    def papply(pts, vd, model):
        return torch.ones(pts.shape[:-1] + (4,))

    return japply, papply


def _jax_run(fn, rays, grid):
    return jax.tree.map(np.asarray, jax.jit(fn)(
        jnp.asarray(rays), jnp.asarray(grid), jnp.asarray(BBOX)))


def _assert_march(ref, out, exact=(), atol=1e-5, depth_atol=1e-5):
    for k, tol in (("rgb_map_f", atol), ("acc_map_f", atol),
                   ("depth_map_f", depth_atol)):
        np.testing.assert_allclose(out[k].detach().numpy(), ref[k], rtol=0,
                                   atol=tol, err_msg=k)
    for k in ("truncated",) + tuple(exact):
        np.testing.assert_array_equal(np.asarray(out[k]), ref[k], err_msg=k)


def test_occupancy_sweep_matches_jax():
    """Flat and per-ray (clip) sweeps: voxel ids and occupancy exact;
    positions within one ulp."""
    rays, grid = _rays(), _grid()
    t0 = np.linspace(2.2, 3.0, rays.shape[0]).astype(np.float32)
    step_r = np.linspace(0.01, 0.02, rays.shape[0]).astype(np.float32)
    step_r[-3:] = 0.0  # degenerate spans are unoccupied
    for spans in (None, (t0, step_r)):
        def jf(r, g, b, spans=spans):
            sp = None if spans is None else tuple(map(jnp.asarray, spans))
            ts, flat, occ, _ = jax_sweep(r, NEAR, FAR, g, b, 0.0625, sp)
            return ts, flat, occ

        ts_j, flat_j, occ_j = _jax_run(jf, rays, grid)
        sp = None if spans is None else tuple(map(_t, spans))
        ts, flat, occ, n = pa.occupancy_sweep(
            _t(rays), NEAR, FAR, _t(grid), _t(BBOX), 0.0625, sp)
        assert n == 64
        np.testing.assert_array_equal(flat.numpy(), flat_j)
        np.testing.assert_array_equal(occ.numpy(), occ_j)
        np.testing.assert_allclose(ts.numpy(), ts_j, rtol=0, atol=4.8e-7)
        assert not occ.numpy()[-4:].any()  # zero-direction padding rays


def test_march_rays_accelerated_matches_jax(setup):
    """The per-ray [N, K] march with a K that truncates: maps to 1e-5
    (depth 1e-4: the K-slot sums carry the MLP's summation order into t ≈
    2..6, as in test_torch_eval.py; measured 1.5e-5 on one ray), truncated
    and the return_samples outputs exact (sigma to 1e-5)."""
    jnet, params, pnet = setup
    japply, papply = _applies(jnet, params, pnet)
    rays, grid = _rays(), _grid()
    jo, po = _opts(max_samples=10)
    ref = _jax_run(lambda r, g, b: jax_accel(japply, r, NEAR, FAR, g, b, jo,
                                             return_samples=True), rays, grid)
    with torch.no_grad():
        out = pa.march_rays_accelerated(papply, _t(rays), NEAR, FAR,
                                        _t(grid), _t(BBOX), po,
                                        return_samples=True)
    real = slice(0, rays.shape[0] - 4)
    _assert_march({k: v[real] for k, v in ref.items()},
                  {k: v[real] for k, v in out.items()},
                  exact=("sample_flat", "sample_valid"), depth_atol=1e-4)
    np.testing.assert_allclose(out["sample_sigma"][real].numpy(),
                               ref["sample_sigma"][real], rtol=0, atol=1e-5)
    assert out["sample_flat"].dtype == torch.int32
    assert 0 < int(out["truncated"].sum()) < rays.shape[0]


def test_march_rays_accelerated_refuses_packed_knobs():
    """The three refusals of the JAX per-ray march."""
    _, papply = _zero_applies()
    rays, grid = _rays(8), _grid()
    for kw, match in ((dict(clip_bbox=True), "clip"),
                      (dict(coarse_block=4), "coarse_block"),
                      (dict(march_fused="gather"), "march_fused")):
        with pytest.raises(ValueError, match=match):
            pa.march_rays_accelerated(papply, _t(rays), NEAR, FAR, _t(grid),
                                      _t(BBOX), MarchOptions(**dict(BASE, **kw)))


PACKED = {
    "flat": ({}, 24),
    "overflow": ({}, 1),  # the stream cap drops samples
    "hier": (dict(coarse_block=4), 24),
    "hier_kc1": (dict(coarse_block=4, coarse_cap=1), 24),
    "clip": (dict(clip_bbox=True), 24),
    "hier_clip": (dict(coarse_block=4, clip_bbox=True), 16),
    "hier_overflow": (dict(coarse_block=4), 1),
    "clip_overflow": (dict(clip_bbox=True), 8),
    "hier_clip_kc1": (dict(coarse_block=4, coarse_cap=1, clip_bbox=True), 16),
}


@pytest.mark.parametrize("case", sorted(PACKED))
def test_march_rays_packed_matches_jax(setup, case):
    """Flat, hierarchical and clipped packed marches, with return_samples:
    maps to 1e-5; truncated, overflow_frac, the traversal counts and the
    stream's voxel ids and validity exact. Then the compositing alone, to
    1e-5, through an MLP-free apply."""
    jnet, params, pnet = setup
    japply, papply = _applies(jnet, params, pnet)
    kw, cap = PACKED[case]
    rays, grid = _rays(), _grid()
    jo, po = _opts(**kw)
    ref = _jax_run(lambda r, g, b: jax_packed(
        japply, r, NEAR, FAR, g, b, jo, cap_avg=cap, return_samples=True),
        rays, grid)
    with torch.no_grad():
        out = pm.march_rays_packed(papply, _t(rays), NEAR, FAR, _t(grid),
                                   _t(BBOX), po, cap_avg=cap,
                                   return_samples=True)
    valid = ref["sample_valid"] > 0
    assert float(out["march_samples_out"]) > 0  # the rays cross the grid
    _assert_march(ref, out, exact=(
        "overflow_frac", "march_candidates", "march_samples_out",
        "march_coarse_occ", "sample_flat", "sample_valid"))
    np.testing.assert_allclose(out["sample_sigma"].numpy()[valid],
                               ref["sample_sigma"][valid], rtol=0, atol=1e-5)
    if case.endswith("overflow"):
        assert float(out["overflow_frac"]) > 0.1
        assert bool(out["truncated"].any())
    if case.endswith("kc1"):
        assert bool(out["truncated"].any())  # the K_c interval clip

    # with an MLP-free apply (σ and colour from the point, the same float32
    # expression on both sides) only the compositing differs — the port's
    # float64 prefix sums against JAX's float32 cumsum / segment_sum over up
    # to ~60 samples a ray: rgb and acc within 1e-5 (measured 4.3e-6),
    # depth (up to FAR) within 1e-5 · FAR; the port's own float64 exactness
    # is held in test_composite_transmittance_is_exact_deep_in_a_long_stream
    def jfree(pts, vd, model, valid=None):
        return jnp.concatenate([pts, 2.0 + pts[..., :1] * pts[..., 1:2]], -1)

    def pfree(pts, vd, model):
        return torch.cat([pts, 2.0 + pts[..., :1] * pts[..., 1:2]], -1)

    ref = _jax_run(lambda r, g, b: jax_packed(jfree, r, NEAR, FAR, g, b, jo,
                                              cap_avg=cap), rays, grid)
    out = pm.march_rays_packed(pfree, _t(rays), NEAR, FAR, _t(grid),
                               _t(BBOX), po, cap_avg=cap)
    _assert_march(ref, out, exact=("overflow_frac",), atol=1e-5,
                  depth_atol=1e-5 * FAR)


def _grazing(rays: torch.Tensor, ts: torch.Tensor, res: int) -> torch.Tensor:
    """[N] bool: rays with a march point whose voxel differs between ``o +
    d·t`` rounded twice and as one fused multiply-add — points within an
    ulp of a voxel face."""
    o, d = rays[:, None, 0:3], rays[:, None, 3:6]
    ts = ts if ts.dim() == 2 else ts[None, :]
    bbox = _t(BBOX)
    a = world_to_voxel(o + d * ts[..., None], bbox, res)
    b = world_to_voxel(pa._fma(d, ts[..., None], o), bbox, res)
    return (a != b).any(-1).any(-1)


def _face_rays(res: int, step: float, clip: bool, n: int = 4000):
    """Rays built so that one march point lands on an x face of the grid
    (in exact arithmetic): direction mostly -z, the origin's x solved from
    the point's march position, so the float32 point straddles the face."""
    rng = np.random.default_rng(11 + clip)
    d = np.concatenate([rng.normal(0, 0.2, (n, 2)), -np.ones((n, 1))], -1)
    o = np.concatenate([rng.uniform(-1.0, 1.0, (n, 2)),
                        4.0 + rng.uniform(0, 0.3, (n, 1))], -1)
    rays = torch.from_numpy(np.concatenate([o, d], -1).astype(np.float32))
    n_steps = pa.n_march_steps(NEAR, FAR, step)
    s_idx = torch.arange(n_steps, dtype=torch.float32)
    spans = None
    if clip:  # the z slab binds, so moving o.x leaves the span as it is
        t0, t1 = pm._ray_bbox_spans(rays[:, :3], rays[:, 3:], _t(BBOX),
                                    NEAR, FAR)
        spans = (t0, (t1 - t0) * (1.0 / torch.tensor(float(n_steps))))
    ts = pa.march_positions(s_idx, NEAR, step, spans).expand(n, n_steps)
    s = torch.from_numpy(rng.integers(n_steps // 4, 3 * n_steps // 4, n))
    t = ts[torch.arange(n), s].double()
    face = -1.5 + torch.from_numpy(rng.integers(8, res - 8, n)) * (3.0 / res)
    rays[:, 0] = (face - rays[:, 3].double() * t).float()
    return rays, ts


def test_grazing_rays_pick_the_voxels_jax_picks():
    """Rays that graze voxel faces (a march point within an ulp of a face
    of a 128³ grid at step 0.005; kept only where rounding the point twice
    and once pick different voxels): every packed admission (flat,
    hierarchical, clip) and the per-ray march choose the same voxel ids and
    occupancy as the jitted JAX marches."""
    japply, papply = _zero_applies()
    res, step = 128, 0.005
    n = pa.n_march_steps(NEAR, FAR, step)
    grid = np.random.default_rng(12).random((res,) * 3) < 0.5
    for label, clip, kw in (("flat", False, {}),
                            ("hier", False, dict(coarse_block=8)),
                            ("clip", True, dict(clip_bbox=True))):
        cand, ts = _face_rays(res, step, clip)
        rays = cand[_grazing(cand, ts, res)].numpy()
        assert rays.shape[0] >= 10, (label, rays.shape)
        jo, po = _opts(step_size=step, max_samples=n, **kw)
        ref = _jax_run(lambda r, g, b: jax_packed(
            japply, r, NEAR, FAR, g, b, jo, cap_avg=n, return_samples=True),
            rays, grid)
        out = pm.march_rays_packed(papply, _t(rays), NEAR, FAR, _t(grid),
                                   _t(BBOX), po, cap_avg=n,
                                   return_samples=True)
        for k in ("sample_flat", "sample_valid", "march_samples_out"):
            np.testing.assert_array_equal(np.asarray(out[k]), ref[k],
                                          err_msg=f"{label} {k}")
        if label == "flat":
            ref = _jax_run(lambda r, g, b: jax_accel(
                japply, r, NEAR, FAR, g, b, jo, return_samples=True),
                rays, grid)
            out = pa.march_rays_accelerated(papply, _t(rays), NEAR, FAR,
                                            _t(grid), _t(BBOX), po,
                                            return_samples=True)
            for k in ("sample_flat", "sample_valid"):
                np.testing.assert_array_equal(out[k].numpy(), ref[k],
                                              err_msg=f"per-ray {k}")


def test_stream_order_is_the_stable_partition():
    """The port's compaction order equals a stable sort on
    ``where(occ, idx, T + idx)`` (the JAX key)."""
    occ = torch.from_numpy(np.random.default_rng(4).random(997) < 0.3)
    idx = torch.arange(997)
    key = torch.where(occ, idx, 997 + idx)
    assert torch.equal(pm._stream_order(occ), torch.argsort(key, stable=True))


def test_composite_transmittance_is_exact_deep_in_a_long_stream():
    """A stream whose prefix of τ grows to ~5e4 (8192 rays of 64 occupied
    samples, as a trained chunk does): every ray's maps equal a per-ray
    float64 composite of the same raw within 1e-5, the last ray's too. A
    float32 ``e − e0`` there keeps ~4e-3 of absolute precision and would
    miss by ~1e-3."""
    n, c = 8192, 64
    rng = np.random.default_rng(6)
    o = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    t = np.broadcast_to(np.float32(NEAR) + 0.05 * np.arange(c, dtype=np.float32),
                        (n, c)).copy()
    dist = np.full((n, c), 0.05, np.float32) * np.linalg.norm(
        d, axis=-1, keepdims=True)
    seen = {}

    def apply(pts, vd, model):
        # σ in [0.5, 2.5]: τ per ray stays below the ERT cut
        raw = torch.cat([pts[..., :3], 1.5 + torch.sin(3 * pts[..., :1])], -1)
        seen["raw"] = raw[:, 0].double().numpy()
        return raw

    _, opts = _opts()
    out, _ = pm._composite_stream(
        apply, _t(o), _t(d), torch.ones((n, c), dtype=torch.bool), _t(t),
        _t(dist), opts, n * c)
    raw = seen["raw"].reshape(n, c, 4)
    tau = np.maximum(raw[..., 3], 0) * dist.astype(np.float64)
    trans = np.exp(-(np.cumsum(tau, -1) - tau))
    w = trans * (1 - np.exp(-tau)) * (trans >= opts.transmittance_threshold)
    acc = w.sum(-1)
    rgb = (w[..., None] / (1 + np.exp(-raw[..., :3]))).sum(1) + (1 - acc)[:, None]
    for k, ref in (("rgb_map_f", rgb), ("acc_map_f", acc),
                   ("depth_map_f", (w * t).sum(-1))):
        np.testing.assert_allclose(out[k].numpy(), ref, rtol=0, atol=1e-5,
                                   err_msg=k)


def test_proposal_packed_raises():
    with pytest.raises(NotImplementedError, match="slice 5"):
        pm.march_rays_proposal_packed(None, None, NEAR, FAR, None, None, None,
                                      None)


# -- the packed march through the masked fused apply ------------------------

def test_packed_march_through_the_masked_apply():
    """The production seam: ``make_fused_apply`` advertises
    ``supports_valid_mask``, the packed march streams its occupancy bit
    into it, and the image equals the packed march through the plain
    Network (which masks the same rows outside)."""
    from nerf_replication_tpu_torch.config import make_cfg
    from test_torch_helpers import LEGO

    net = ["network.nerf.W", "128", "network.nerf.D", "4",
           "network.nerf.skips", "[1]"]
    pnet = nets(extra=net, seed=1)[2]
    cfg = make_cfg(LEGO, net + ["network.nerf.fused_tile", "64"])
    fused = fmlp.make_fused_apply(pnet, cfg)
    assert fused.supports_valid_mask
    rays, grid = _rays(), _grid()
    _, po = _opts(coarse_block=4)
    with torch.no_grad():
        a = pm.march_rays_packed(fused, _t(rays), NEAR, FAR, _t(grid),
                                 _t(BBOX), po, cap_avg=16)
        b = pm.march_rays_packed(lambda p, vd, m: pnet(p, vd, model=m),
                                 _t(rays), NEAR, FAR, _t(grid), _t(BBOX), po,
                                 cap_avg=16)
    for k in ("rgb_map_f", "depth_map_f", "acc_map_f"):
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0,
                                   atol=2e-5, err_msg=k)
    assert torch.equal(a["truncated"], b["truncated"])
