"""K4's warp traversal (``csrc/fused_dda.cu``) on the CPU: the premise of its
coarse-block shortcut, and an emulation of the kernel held to the plain
version and the JAX package.

* The shortcut's premise: along a ray, every axis's fine voxel id, and its
  parent coarse cell, is monotone in the march step s, for both rounding
  chains of the position (``o + d·t``, and the ``clip_bbox`` fused
  multiply-add with a per-ray step), direction components 0 and negative
  among them.
* ``tools/dda_emulate.emulate_k4`` (the kernel's decisions step by step:
  end-cell shortcut, ballot-prefix compaction of blocks and candidates,
  padding) bitwise equal to ``dda_block_plain`` on the fused-march cases
  (uncompacted, compacted, K_c-clipped, bbox-clipped, lego statics), on
  rays that graze coarse faces, run along axes or are zero; and exact against the JAX ``fused_dda_gather`` at
  the lego statics (``dist`` to one ulp, as the other K4 tests hold it).
* The work counts at the serving slice's geometry (a 32x32 view of the same
  camera, the 128³ ball grid): the positions phase A evaluates with the
  shortcut and in the CTA traversal, and the 32-byte sectors each kernel's
  stores touch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_march import _assert_dda_exact
from test_torch_helpers import BBOX, FAR, NEAR, box_grid, sample_rays

from nerf_replication_tpu.ops.fused_march import fused_dda_gather as jax_dda
from nerf_replication_tpu.renderer.accelerated import (
    MarchOptions as JaxMarchOptions,
)
from nerf_replication_tpu_torch.ops import fused_march as fm
from nerf_replication_tpu_torch.renderer.accelerated import MarchOptions
from nerf_replication_tpu_torch.renderer.occupancy import world_to_voxel
from nerf_replication_tpu_torch.tools import dda_emulate as emu
from nerf_replication_tpu_torch.tools.slice_inputs import (
    ball_grid,
    edge_rays,
    view_rays,
)

OPT = dict(step_size=0.25, max_samples=64, white_bkgd=True, chunk_size=64,
           coarse_block=4, coarse_cap=3, fused_block=64)
LEGO = dict(step_size=0.005, max_samples=192, coarse_block=8,
            fused_block=256)
CASES = {
    "generous": (OPT, "box"),
    "compact": (dict(OPT, max_samples=4), "box"),
    "k_c_1": (dict(OPT, coarse_cap=1), "box"),
    "clip": (dict(OPT, step_size=0.05, max_samples=32, clip_bbox=True), "box"),
    "lego": (LEGO, "ball"),
}


def _prepared(rays, grid, **kw):
    return fm._prepare(torch.from_numpy(rays), NEAR, FAR,
                       torch.from_numpy(grid), torch.from_numpy(BBOX),
                       MarchOptions(**kw))


def _assert_bitwise(out, ref, label):
    for name, a, b in zip(("t_sel", "valid", "flat_sel", "n_occ", "n_blk",
                           "dist"), out, ref):
        assert a.dtype == b.dtype and torch.equal(a, b), (label, name)


@pytest.mark.parametrize("clip", [False, True])
def test_voxel_ids_are_monotone_along_a_ray(clip):
    """Each axis's fine voxel id and parent cell never turn back along a
    ray: seeded rays from everywhere around the bbox, directions with
    components exactly 0 and of either sign, both rounding chains of the
    position (with clip, the per-ray step of the bbox span)."""
    rng = np.random.default_rng(3 + clip)
    n = 3000
    o = rng.uniform(-5.0, 5.0, (n, 3))
    d = rng.normal(0.0, 1.0, (n, 3))
    d[rng.random((n, 3)) < 0.15] = 0.0  # zero components
    d[::50] = 0.0
    rays = np.concatenate([o, d], -1).astype(np.float32)
    rays = np.concatenate([rays, edge_rays(600, seed=4)], 0)
    st, rays_t, _, _, bbox = _prepared(
        rays, box_grid(128), **dict(LEGO, clip_bbox=clip, step_size=0.0125))
    _, _, t0, step_r, _, _ = emu._setup(st, rays_t, bbox)
    s = torch.arange(st.n_steps).expand(rays_t.shape[0], -1)
    t = fm._march_t(s.to(torch.float32), step_r, t0)
    assert bool((torch.diff(t, dim=-1) >= 0).all())
    vox = world_to_voxel(fm._march_pts(st, rays_t[:, :3], rays_t[:, 3:],
                                       t), bbox, st.resolution)
    for ids in (vox, vox // st.factor):
        step = torch.diff(ids, dim=1)  # [B, S-1, 3]
        up = (step >= 0).all(1)
        down = (step <= 0).all(1)
        assert bool((up | down).all())
    # the set is not trivial: ids do move, on many rays and every axis
    assert bool(((vox[:, -1] - vox[:, 0]) != 0).any(0).all())


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulation_matches_plain_bitwise(case):
    """The kernel's traversal as emulated equals the plain version on all
    six outputs, and its shortcut evaluated fewer positions than the CTA
    traversal's walk of each block."""
    kw, grid_kind = CASES[case]
    if grid_kind == "ball":
        rays, grid = sample_rays(96, seed=5), ball_grid()
    else:
        rays, grid = sample_rays(64), box_grid(16)
    st, rays_t, g, c, bbox = _prepared(rays, grid, **kw)
    ref = fm.dda_block_plain(st, rays_t, g, c, bbox)
    out, counts = emu.emulate_k4(st, rays_t, g, c, bbox)
    _assert_bitwise(out, ref, case)
    assert int(ref[3].sum()) > 0
    assert counts["positions"] < counts["positions_cta"]


@pytest.mark.parametrize("case", ["compact", "uncompacted", "clip"])
def test_emulation_on_edge_rays(case):
    """Rays grazing coarse-cell faces, axis-aligned and diagonal rays and
    zero rays, on the ball grid: the shortcut decides blocks exactly
    (bitwise the plain version), and it did take the shortcut. (At step
    0.03, S = 134: the last block holds 6 of r = 8 positions.)"""
    kw = {"compact": LEGO,
          "uncompacted": dict(LEGO, step_size=0.03, max_samples=256),
          "clip": dict(LEGO, step_size=0.01, max_samples=64,
                       clip_bbox=True)}[case]
    rays = edge_rays(300, seed=11)
    st, rays_t, g, c, bbox = _prepared(rays, ball_grid(), **kw)
    assert st.compact == (case != "uncompacted")
    assert case != "uncompacted" or st.n_steps % st.r
    ref = fm.dda_block_plain(st, rays_t, g, c, bbox)
    out, counts = emu.emulate_k4(st, rays_t, g, c, bbox)
    _assert_bitwise(out, ref, case)
    assert int((ref[3] > 0).sum()) > 50
    assert counts["positions"] < counts["positions_cta"]


def test_ballot_ranks_are_march_order_ranks():
    """Per-pass ballot words and prefix popcounts give every set bit its
    exclusive rank in march order (any length, ragged last pass)."""
    rng = np.random.default_rng(0)
    for n in (1, 31, 32, 33, 100, 200):
        bits = torch.from_numpy(rng.random((17, n)) < 0.4)
        rank, total, per_pass = emu.ballot_ranks(bits)
        b64 = bits.to(torch.int64)
        assert torch.equal(rank[bits], (torch.cumsum(b64, -1) - b64)[bits])
        assert torch.equal(total, b64.sum(-1))
        assert per_pass.shape == (17, -(-n // 32))
    w = torch.from_numpy(rng.integers(0, 2**32, 1000, dtype=np.int64))
    ref = torch.tensor([bin(int(x)).count("1") for x in w])
    assert torch.equal(emu.popc(w), ref)


def test_emulation_matches_jax_at_lego():
    """The emulated kernel against the JAX ``fused_dda_gather`` at the lego
    statics (S = 800, r = 8, K_c = 25, K = 192 < C) on the ball grid:
    exact, ``dist`` to one ulp."""
    rays, grid = sample_rays(96, seed=5), ball_grid()
    ref = jax_dda(jnp.asarray(rays), NEAR, FAR, jnp.asarray(grid),
                  jnp.asarray(BBOX), JaxMarchOptions(**LEGO))
    st, rays_t, g, c, bbox = _prepared(rays, grid, **LEGO)
    (t_sel, valid, flat_sel, n_occ, n_blk, dist), _ = emu.emulate_k4(
        st, rays_t, g, c, bbox)
    _assert_dda_exact(ref, {"t_sel": t_sel, "valid": valid,
                            "flat_sel": flat_sel, "n_occ": n_occ,
                            "n_blk": n_blk, "dist": dist})
    assert int(n_occ.max()) > st.k_sel  # the second compaction cuts


def test_work_counts_at_the_serving_geometry():
    """At the serving slice's camera and grid (a 32x32 view, 1024 rays):
    the shortcut evaluates the first position of each block (and of one
    block past the last) and the other positions of the blocks it leaves
    undecided, under a quarter of the CTA traversal's positions; the warp
    kernel's stores touch within 10% of the outputs' sectors, the CTA
    kernel's ~10x as many."""
    rays = view_rays(30.0, 32)
    st, rays_t, g, c, bbox = _prepared(rays, ball_grid(), **LEGO)
    assert (st.n_steps, st.s_c, st.k_c, st.k_sel) == (800, 100, 25, 192)
    _, counts = emu.emulate_k4(st, rays_t, g, c, bbox)
    assert counts["rays_live"] == rays_t.shape[0]
    firsts = counts["rays_live"] * (st.s_c + 1)
    assert counts["positions"] == 174_103
    assert firsts < counts["positions"] < 2 * firsts
    assert counts["positions_cta"] == 780_535
    assert 4 * counts["positions"] < counts["positions_cta"]
    assert counts["sectors"] <= 1.1 * counts["sectors_min"]
    assert counts["sectors_cta"] >= 10 * counts["sectors_min"]
