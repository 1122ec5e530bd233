"""Port parity of the fused march with ``march_clip_bbox`` (per-ray bbox
spans divided into S steps): the plain versions of K4 and K5 against the
JAX package's bodies.

XLA evaluates the JAX expression ``(t1 - t0) / S`` as a product with the
float32 reciprocal of S and, in this graph, contracts the sample points
``o + d·t`` into a fused multiply-add; the port does the same, so K4's
outputs are exact (t_sel/valid/flat_sel/n_occ/n_blk; dist to one ulp, as in
``tests/test_torch_fused_march.py``), on rays that graze voxel faces and on
zero-direction and axis-aligned rays. K5's maps are held to 1e-5 (depth
1e-4), its traversal stats exactly."""

import numpy as np

from test_torch_fused_march import (  # noqa: F401  (setup is a fixture)
    _assert_dda_exact,
    _assert_maps_close,
    _dda_pair,
    _full_pair,
    _opts,
    setup,
)


def test_k4_clip_plain_matches_jax_exactly(setup):
    _, _, _, rays, grid = setup
    rng = np.random.default_rng(9)
    o = rng.normal(0, 1.5, (192, 3)) + np.array([0.0, 0.0, 4.0])
    d = rng.normal(0, 0.3, (192, 3)) - o
    crays = np.concatenate([rays, np.concatenate([o, d], -1)],
                           0).astype(np.float32)
    crays[-4:, 3:] = 0.0  # zero-direction padding rays
    crays[-5, 3:] = [0.0, 0.0, -1.0]  # axis-aligned: the 1e-12 guard
    jo, po = _opts(clip_bbox=True, max_samples=8)
    ref, out = _dda_pair(crays, grid, jo, po)
    _assert_dda_exact(ref, out)
    assert int((out["n_occ"] > 0).sum()) > 40


def test_k5_clip_plain_matches_jax(setup):
    jnet, params, pnet, rays, grid = setup
    jo, po = _opts(clip_bbox=True)
    ref, out = _full_pair(jnet, params, pnet, rays, grid, jo, po)
    _assert_maps_close(ref, out)
    assert float(out["march_samples_out"]) > 0
