"""Port parity of the fused march (ops/fused_march.py): the plain versions
of K4 (DDA + gather) and K5 (the whole march) against the JAX package's
production bodies (``lax.map``; the JAX tests hold them bitwise to the
Pallas kernels), plus the edge cases of the JAX fused-march tests.

Tolerances: K4 is exact (same float32 operations in the same order); K5 maps
``atol 1e-5`` (depth ``1e-4``: t ≈ 2..6 scales the weight error) — the MLP
products and the K-slot sums run in another order than XLA's; ``truncated``
and the traversal stats are exact (they are counts)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import BBOX, FAR, NEAR, box_grid, nets, sample_rays

from nerf_replication_tpu.ops.fused_march import (
    fused_dda_gather as jax_dda,
    march_rays_fused as jax_march_gather,
    march_rays_fused_full as jax_march_full,
)
from nerf_replication_tpu.ops.fused_mlp import fused_spec_for as jax_spec_for
from nerf_replication_tpu.renderer.accelerated import (
    MarchOptions as JaxMarchOptions,
)
from nerf_replication_tpu_torch.ops.fused_march import (
    LAUNCHES,
    FusedWeights,
    fused_dda_gather,
    march_rays_fused,
    march_rays_fused_full,
)
from nerf_replication_tpu_torch.ops.fused_mlp import fused_spec_for
from nerf_replication_tpu_torch.renderer.accelerated import MarchOptions

OPT = dict(step_size=0.25, max_samples=64, white_bkgd=True, chunk_size=64,
           coarse_block=4, coarse_cap=3, fused_block=64)


def _opts(**kw):
    o = dict(OPT, **kw)
    return JaxMarchOptions(**o), MarchOptions(**o)


@pytest.fixture(scope="module")
def setup():
    jnet, params, pnet = nets()
    rays = sample_rays(64)
    grid = box_grid(16)
    return jnet, params, pnet, rays, grid


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _dda_pair(rays, grid, jo, po):
    ref = jax_dda(jnp.asarray(rays), NEAR, FAR, jnp.asarray(grid),
                  jnp.asarray(BBOX), jo)
    out = fused_dda_gather(_t(rays), NEAR, FAR, _t(grid), _t(BBOX), po)
    return ref, out


def _assert_dda_exact(ref, out):
    for k in ("t_sel", "valid", "flat_sel", "n_occ", "n_blk"):
        np.testing.assert_array_equal(np.asarray(ref[k]), out[k].numpy(),
                                      err_msg=k)
    # dist = step·sqrt(|d|²): XLA's CPU code for the 3-term sum matches no
    # fixed order of float32 operations (measured: off by one ulp on ~1% of
    # rays against every order tried), so dist is held to one ulp
    np.testing.assert_allclose(out["dist"].numpy(), np.asarray(ref["dist"]),
                               rtol=2.0 ** -23, atol=0)


@pytest.mark.parametrize("case", ["generous", "compact", "k_c_1", "lego"])
def test_k4_plain_matches_jax_exactly(setup, case):
    """K4 plain vs the JAX body: exact on t_sel/valid/flat_sel/n_occ/n_blk,
    on the uncompacted (K = C), compacted (K < C) and K_c-clipped paths,
    and at the lego march (step 0.005, r = 8, K_c = 25, K = 192 < C = 200)
    on a 128³ ball grid."""
    _, _, _, rays, grid = setup
    if case == "lego":
        c = (np.arange(128) + 0.5) / 128 * 2.0 - 1.0
        x, y, z = np.meshgrid(c, c, c, indexing="ij")
        grid = (x * x + y * y + z * z) < 0.46 ** 2
        jo = JaxMarchOptions(step_size=0.005, max_samples=192,
                             coarse_block=8, fused_block=256)
        po = MarchOptions(step_size=0.005, max_samples=192, coarse_block=8,
                          fused_block=256)
        ref, out = _dda_pair(sample_rays(96, seed=5), grid, jo, po)
        _assert_dda_exact(ref, out)
        assert out["t_sel"].shape == (96, 192)
        assert int(out["n_occ"].max()) > 192  # the second compaction cuts
        return
    kw = {"generous": {}, "compact": {"max_samples": 4},
          "k_c_1": {"coarse_cap": 1}}[case]
    jo, po = _opts(**kw)
    ref, out = _dda_pair(rays, grid, jo, po)
    _assert_dda_exact(ref, out)
    assert int(out["n_occ"].sum()) > 0


def _full_pair(jnet, params, pnet, rays, grid, jo, po, model="fine",
               dtype=torch.float32):
    jnet_d = jnet if dtype == torch.float32 else jnet.clone(
        compute_dtype=jnp.bfloat16)
    pnet_d = pnet if dtype == torch.float32 else pnet.clone(dtype)
    ref = jax_march_full(
        jax_spec_for(jnet_d), jnet.xyz_encoder, jnet.dir_encoder,
        params["params"][model], jnp.asarray(rays), NEAR, FAR,
        jnp.asarray(grid), jnp.asarray(BBOX), jo,
    )
    w = FusedWeights(fused_spec_for(pnet_d), getattr(pnet, model))
    with torch.no_grad():
        out = march_rays_fused_full(w, pnet.xyz_encoder, pnet.dir_encoder,
                                    _t(rays), NEAR, FAR, _t(grid), _t(BBOX),
                                    po)
    return ref, out


def _assert_maps_close(ref, out, atol=1e-5, depth_atol=1e-4):
    for k, tol in (("rgb_map_f", atol), ("acc_map_f", atol),
                   ("depth_map_f", depth_atol)):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=tol, err_msg=k)
    np.testing.assert_array_equal(out["truncated"].numpy(),
                                  np.asarray(ref["truncated"]))
    for k in ("march_samples_out", "march_coarse_occ", "march_candidates",
              "overflow_frac"):
        assert float(out[k]) == float(ref[k]), k


@pytest.mark.parametrize("case", ["generous", "compact", "k_c_1", "coarse"])
def test_k5_plain_matches_jax(setup, case):
    """K5 plain vs ``march_rays_fused_full`` (f32): maps to 1e-5, truncated
    and march stats exact — including the compact (K < C) and K_c-clip
    paths that flag truncation."""
    jnet, params, pnet, rays, grid = setup
    kw = {"generous": {}, "compact": {"max_samples": 4},
          "k_c_1": {"coarse_cap": 1}, "coarse": {}}[case]
    jo, po = _opts(**kw)
    model = "coarse" if case == "coarse" else "fine"
    ref, out = _full_pair(jnet, params, pnet, rays, grid, jo, po, model)
    _assert_maps_close(ref, out)
    if case in ("compact", "k_c_1"):
        assert bool(out["truncated"].any())


def test_k5_plain_bf16_family(setup):
    """The bf16 family (bf16 operands, f32 accumulation, f32 heads) follows
    the JAX tile's rounding points. Tolerance 2e-3: a float32 ulp of
    difference in an activation can flip its rounding to the next bf16
    value (2^-8 relative), which then propagates through later layers."""
    jnet, params, pnet, rays, grid = setup
    jo, po = _opts()
    ref, out = _full_pair(jnet, params, pnet, rays, grid, jo, po,
                          dtype=torch.bfloat16)
    _assert_maps_close(ref, out, atol=2e-3, depth_atol=1e-2)


def test_k5_all_empty_grid(setup):
    """An all-carved grid admits nothing: pure white background, zero
    samples, no truncation — port and JAX alike."""
    jnet, params, pnet, rays, grid = setup
    jo, po = _opts()
    empty = np.zeros_like(grid)
    ref, out = _full_pair(jnet, params, pnet, rays, empty, jo, po)
    _assert_maps_close(ref, out)
    np.testing.assert_array_equal(out["rgb_map_f"].numpy(), 1.0)
    np.testing.assert_array_equal(out["acc_map_f"].numpy(), 0.0)
    assert float(out["march_samples_out"]) == 0.0


def test_k5_pad_rays_are_inert(setup):
    """Zero-direction padding rays admit nothing and leave the real rays'
    maps bitwise unchanged."""
    jnet, params, pnet, rays, grid = setup
    _, po = _opts()
    w = FusedWeights(fused_spec_for(pnet), pnet.fine)
    padded = np.concatenate([rays, np.zeros((32, 6), np.float32)], 0)
    with torch.no_grad():
        base = march_rays_fused_full(w, pnet.xyz_encoder, pnet.dir_encoder,
                                     _t(rays), NEAR, FAR, _t(grid), _t(BBOX),
                                     po)
        out = march_rays_fused_full(w, pnet.xyz_encoder, pnet.dir_encoder,
                                    _t(padded), NEAR, FAR, _t(grid),
                                    _t(BBOX), po, k_tile=8)
    n = rays.shape[0]
    for k in ("rgb_map_f", "depth_map_f", "acc_map_f"):
        assert torch.equal(out[k][:n], base[k]), k
    assert not bool(out["truncated"][n:].any())
    np.testing.assert_array_equal(out["rgb_map_f"][n:].numpy(), 1.0)
    assert float(out["march_samples_out"]) == float(base["march_samples_out"])


def test_k5_ert_terminated_rays(setup):
    """Early ray termination on an opaque network (alpha bias +50: rays die
    on their first occupied sample): port and JAX agree, ERT-terminated
    rays are not 'truncated', and the composite equals a no-threshold march
    to within the threshold."""
    jnet, params, pnet, rays, grid = setup
    import jax

    params_o = jax.tree.map(lambda a: a, params)
    fine = dict(params_o["params"]["fine"])
    fine["alpha_linear"] = {"kernel": fine["alpha_linear"]["kernel"],
                            "bias": jnp.full((1,), 50.0, jnp.float32)}
    params_o = {"params": {**params_o["params"], "fine": fine}}
    with torch.no_grad():
        pnet.fine.alpha_linear.bias.fill_(50.0)
    try:
        jo, po = _opts(transmittance_threshold=1e-4)
        ref, out = _full_pair(jnet, params_o, pnet, rays, grid, jo, po)
        _assert_maps_close(ref, out)
        jo0, po0 = _opts(transmittance_threshold=0.0)
        _, out0 = _full_pair(jnet, params_o, pnet, rays, grid, jo0, po0)
    finally:
        with torch.no_grad():
            pnet.fine.alpha_linear.bias.zero_()
    for k in ("rgb_map_f", "acc_map_f"):
        np.testing.assert_allclose(out[k].numpy(), out0[k].numpy(),
                                   atol=2e-4, err_msg=k)
    hit = out["acc_map_f"].numpy() > 0.5
    assert hit.any()
    assert not bool(out["truncated"].any())


def test_gather_route_matches_jax(setup):
    """Stage (a): K4 plain traversal + the plain Network on the valid slots
    vs ``march_rays_fused`` with the Flax network (f32, atol 1e-5)."""
    jnet, params, pnet, rays, grid = setup
    jo, po = _opts(max_samples=8)

    def japply(pts, vd, model, valid=None):
        return jnet.apply(params, pts, vd, model=model)

    ref = jax_march_gather(japply, jnp.asarray(rays), NEAR, FAR,
                           jnp.asarray(grid), jnp.asarray(BBOX), jo)
    with torch.no_grad():
        out = march_rays_fused(
            lambda p, v, m: pnet(p, v, model=m), _t(rays), NEAR, FAR,
            _t(grid), _t(BBOX), po)
    _assert_maps_close(ref, out)


def test_full_width_k5_plain_matches_jax():
    """Lego width (D=8, W=256, skip 4, 63/27-wide encodings) on ≤ 64 rays:
    the plain K5 holds to the JAX body at f32 tolerance."""
    jnet, params, pnet = nets(extra=())
    rays = sample_rays(48, seed=3)
    grid = box_grid(16)
    jo, po = _opts()
    ref, out = _full_pair(jnet, params, pnet, rays, grid, jo, po)
    _assert_maps_close(ref, out)


def test_cpu_tensors_never_launch(setup):
    """On CPU tensors the wrappers run the plain versions: no launch is
    counted, and no CUDA library is loaded."""
    jnet, params, pnet, rays, grid = setup
    before = dict(LAUNCHES)
    _, po = _opts()
    fused_dda_gather(_t(rays), NEAR, FAR, _t(grid), _t(BBOX), po)
    assert LAUNCHES == before
    from nerf_replication_tpu_torch.ops import kernels

    assert kernels._libs == {}


def test_march_requires_coarse_block(setup):
    _, _, pnet, rays, grid = setup
    _, po = _opts(coarse_block=0)
    with pytest.raises(ValueError, match="coarse_block"):
        fused_dda_gather(_t(rays), NEAR, FAR, _t(grid), _t(BBOX), po)


def test_statics_match_jax():
    """The fused statics (S, S_c, K_c, C, K, compact) of the lego serving
    configuration are the JAX package's."""
    from nerf_replication_tpu.ops.fused_march import _statics_for as jst
    from nerf_replication_tpu_torch.ops.fused_march import _statics_for as pst

    o = dict(step_size=0.005, max_samples=192, coarse_block=8)
    a = jst(128, 32, NEAR, FAR, JaxMarchOptions(**o))
    b = pst(128, 32, NEAR, FAR, MarchOptions(**o))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (b.n_steps, b.s_c, b.k_c, b.c_total, b.k_sel, b.compact) == (
        800, 100, 25, 200, 192, True)
