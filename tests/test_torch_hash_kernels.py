"""The hash-encoder kernels' CPU side: the kernels' level descriptor, the
main path's point sets, and the plain K6 / K6b on them against the JAX
package and a float64 oracle.

* ``HashDescC``: the layout of ``struct HashDesc`` and lego_hash's levels
  in it; ``touched_rows`` (the rows the kernels' bounds count) against a
  set of the corner rows.
* ``tools/slice_inputs.ngp_points`` (the NGP warm step's ray-ordered
  points) and ``cell_points`` (the contention set).
* The plain K6 on both point sets and on a ragged uniform one at a small geometry against JAX
  ``hash_encode`` (jitted, inputs passed as arguments: the train step's
  rounding) and ``pallas_hash_encode`` in interpret mode: atol 1e-6. The
  plain K6b (dtable, dx) against a float64 ``np.add.at`` oracle (dtable
  within 1e-5 in relative Frobenius norm — the card's gate — dx within 1e-5
  of max|dx|) and JAX's VJP against the same oracle (its float32 prefix
  sums: 4·2^-24 of the level's Σ|w·g|).
* A numpy emulation of K6b's warp aggregation (``reduce_peers`` of
  ``csrc/hash_encode.cu``, bit for bit in its lane logic): each group's
  lowest lane ends with the group's sum; the group sums, scattered with
  ``index_add_``, hold the float64 oracle within 1e-5 (Frobenius); so do
  the kernel's keys as ``scatter_level`` forms them (a dim-0 corner pair
  whose rows share an aligned row pair is one key and one 2C-wide add,
  lanes past the last point a group of their own), which at the contention
  set's level 0 leave at most two adds a corner pair a warp.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hashgrid import EPS32, _oracle64

from nerf_replication_tpu.models.encoding import hashgrid as jhg
from nerf_replication_tpu.models.encoding.pallas_hash import (
    pallas_hash_encode,
)
from nerf_replication_tpu_torch.models.encoding import hashgrid as phg
from nerf_replication_tpu_torch.ops import hash_encode as he
from nerf_replication_tpu_torch.tools.slice_inputs import (
    cell_points,
    ngp_points,
)

LEGO_HASH = (3, 16, float(2 ** (np.log2(1024 / 16) / 15)), 16, 19)
# lego_hash's base and growth at six levels and a 2^11 table
SMALL = (3, 6, 1.39, 16, 11)
C = 2
TOL_FRO = 1e-5


def test_desc_is_the_kernels_struct_with_lego_hash_levels():
    geo = phg.level_geometry(*LEGO_HASH)
    desc = he._desc(geo)
    # struct HashDesc: levels, then five 32-wide arrays
    assert ctypes.sizeof(he.HashDescC) == 4 + 5 * he.MAX_LEVELS * 4
    assert he._desc(geo) is desc, "one descriptor per geometry"
    offsets, scales, resolutions, hashed = geo
    assert desc.levels == 16
    assert list(desc.offset[:16]) == list(offsets[:16])
    assert list(desc.size[:16]) == [b - a for a, b in
                                    zip(offsets, offsets[1:])]
    assert list(desc.resolution[:16]) == [int(r) for r in resolutions]
    # levels 3 and 4 dense, the rest hashed
    assert list(desc.hashed[:16]) == [1] * 3 + [0] * 2 + [1] * 11
    assert list(desc.hashed[:16]) == [int(bool(h)) for h in hashed]
    assert all(np.float32(desc.scale[lvl]) == np.float32(scales[lvl])
               for lvl in range(16))
    # the kernel's row-pair keys need slice offsets that are multiples of 8
    assert offsets[-1] == 5738832 and all(o % 8 == 0 for o in offsets)


def test_touched_rows_counts_distinct_corner_rows():
    geo = phg.level_geometry(*SMALL)
    x = np.random.default_rng(3).random((500, 3), dtype=np.float32)
    rows = set()
    for off, size, scale, res, hashed in phg.geometry_levels(geo):
        pos_grid, _ = phg.level_terms(torch.from_numpy(x), scale)
        for bits in range(8):
            rows |= set((phg._corner_index(he._corners(pos_grid, bits), res,
                                           size, hashed) + off).tolist())
    assert he.touched_rows(torch.from_numpy(x), geo) == len(rows)
    # every point in one level-0 cell: that level's 8 rows
    level0 = ([0, geo[0][1]], geo[1][:1], geo[2][:1], geo[3][:1])
    assert he.touched_rows(torch.from_numpy(cell_points(64, geo[1][0])),
                           level0) == 8


def test_ngp_points_are_seeded_ray_major_and_in_the_unit_cube():
    x = ngp_points(0)
    assert x.shape == (131072, 3) and x.dtype == np.float32
    assert x.min() >= 0.0 and x.max() <= 1.0
    assert np.array_equal(x, ngp_points(0))
    assert not np.array_equal(x, ngp_points(1))
    # ray-major: within a ray, the steps between samples that lie inside
    # the bbox (no coordinate clipped) are one and the same vector
    r = x.reshape(1024, 128, 3).astype(np.float64)
    inside = np.all((r > 1e-5) & (r < 1.0 - 1e-5), -1)
    both = inside[:, 1:] & inside[:, :-1]
    steps = np.diff(r, axis=1)
    first = np.argmax(both, axis=1)
    ref = steps[np.arange(1024), first][:, None, :]
    assert both.sum() > 0.5 * both.size
    assert np.abs(steps - ref)[both].max() < 1e-5
    # depths 2..6 in 127 steps over a 3-wide bbox, times |d| >= 1 (the
    # camera's directions are not normalized; a 200-pixel view's corner
    # ray is 1.2 long)
    step = np.linalg.norm(ref[:, 0], axis=-1)[both.any(1)] / (4 / 127 / 3)
    assert step.min() >= 1.0 - 1e-5 and step.max() <= 1.2


def test_cell_points_share_one_cell_at_level_0_only():
    geo = phg.level_geometry(*LEGO_HASH)
    x = cell_points(16384, geo[1][0])
    for lvl, expect_one in ((0, True), (4, False)):
        pos = phg.level_terms(torch.from_numpy(x), geo[1][lvl])[0]
        cells = torch.unique(pos, dim=0).shape[0]
        assert (cells == 1) == expect_one, (lvl, cells)


def _points(kind: str, geo):
    if kind == "ray":
        return ngp_points(0, n_rays=16)  # 2,048 points
    if kind == "uniform":  # ragged: the last warp holds 25 points
        return np.random.default_rng(4).random((2041, 3), dtype=np.float32)
    return cell_points(2048, geo[1][0])


def _table(geo, seed=5):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (geo[0][-1], C)).astype(np.float32)


@pytest.mark.parametrize("kind", ["ray", "cell", "uniform"])
def test_plain_k6_on_main_path_points_matches_jax(kind):
    geo = phg.level_geometry(*SMALL)
    x, table = _points(kind, geo), _table(geo)
    got = phg.hash_encode(torch.from_numpy(x), torch.from_numpy(table),
                          *SMALL).numpy()
    assert torch.equal(he.hash_encode_fwd(torch.from_numpy(x),
                                          torch.from_numpy(table), geo),
                       torch.from_numpy(got))
    xj, tj = jnp.asarray(x), jnp.asarray(table)
    refs = {
        "jit": jax.jit(lambda a, t: jhg.hash_encode(a, t, *SMALL))(xj, tj),
        "pallas": pallas_hash_encode(xj, tj, *SMALL, block_size=128,
                                     interpret=True),
    }
    for name, ref in refs.items():
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-6,
                                   err_msg=name)


def _fro(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("kind", ["ray", "cell", "uniform"])
def test_plain_k6b_on_main_path_points_against_float64_and_jax(kind):
    geo = phg.level_geometry(*SMALL)
    x, table = _points(kind, geo), _table(geo)
    g = np.random.default_rng(6).normal(
        0, 1, (x.shape[0], SMALL[1] * C)).astype(np.float32)
    ref_dt, ref_dx, mag = _oracle64(x, g, table, geo)
    dt, dx = he.hash_encode_bwd(torch.from_numpy(x), torch.from_numpy(g),
                                torch.from_numpy(table), geo, want_dx=True)
    assert _fro(dt.numpy(), ref_dt) <= TOL_FRO
    assert np.abs(dx.numpy() - ref_dx).max() <= 1e-5 * np.abs(ref_dx).max()

    @jax.jit
    def vjp(a, t, gg):
        return jax.vjp(lambda a_, t_: jhg._encode_with_per_level_bwd(
            a_, t_, *SMALL), a, t)[1](gg)

    jdx, jdt = (np.asarray(v) for v in vjp(jnp.asarray(x),
                                            jnp.asarray(table),
                                            jnp.asarray(g)))
    assert np.abs(jdt - ref_dt).max() <= 4 * EPS32 * mag
    assert np.abs(jdx - ref_dx).max() <= 1e-5 * np.abs(ref_dx).max()


# --- K6b's warp aggregation, emulated ---------------------------------------

LANES = np.arange(32, dtype=np.int64)
MASK32 = 0xFFFFFFFF


def _ffs(v: np.ndarray) -> np.ndarray:
    """CUDA ``__ffs``: 1 + the index of the lowest set bit, 0 for 0."""
    low = v & -v
    out = np.zeros(v.shape, np.int64)
    nz = low != 0
    out[nz] = np.log2(low[nz]).astype(np.int64) + 1
    return out


def _popc(v: np.ndarray) -> np.ndarray:
    return np.array([bin(int(a)).count("1") for a in v.ravel()],
                    np.int64).reshape(v.shape)


def reduce_peers(rows: np.ndarray, v: np.ndarray):
    """``reduce_peers`` of ``csrc/hash_encode.cu`` on warps ``rows [W,
    32]`` (``__match_any_sync`` on the row), values ``v [W, 32, C]``
    float32: the values after the reduction and each lane's leader flag."""
    w = rows.shape[0]
    same = rows[:, :, None] == rows[:, None, :]
    peers = (same * (1 << LANES)).sum(-1)  # [W, 32] lane masks
    below = (1 << LANES) - 1
    rest = peers & ((0xFFFFFFFE << LANES) & MASK32)
    rank = _popc(peers & below)
    v = v.copy()
    while np.any(rest):  # __any_sync over each warp: all warps together
        nxt = _ffs(rest)
        src = np.where(nxt > 0, nxt - 1, LANES)
        t = v[np.arange(w)[:, None], src]  # __shfl_sync reads, then adds
        v = np.where((nxt > 0)[..., None], v + t, v).astype(np.float32)
        done = ((rank & 1) * (1 << LANES)).sum(-1, keepdims=True)
        rest = rest & ~done & MASK32
        rank = rank >> 1
    return v, (peers & below) == 0


def test_reduce_peers_leaves_each_group_sum_with_its_lowest_lane():
    rng = np.random.default_rng(7)
    # few distinct rows (deep groups), runs (a ray's samples), all distinct
    rows = np.concatenate([rng.integers(0, 3, (40, 32)),
                           np.repeat(rng.integers(0, 99, (40, 8)), 4, 1),
                           np.tile(LANES, (4, 1)),
                           np.zeros((4, 32), np.int64)])
    v = rng.normal(0, 1, rows.shape + (2,)).astype(np.float32)
    out, lead = reduce_peers(rows, v)
    for wi in range(rows.shape[0]):
        for r in np.unique(rows[wi]):
            lanes = np.nonzero(rows[wi] == r)[0]
            assert lead[wi, lanes].tolist() == [True] + [False] * (
                len(lanes) - 1)
            np.testing.assert_allclose(out[wi, lanes[0]],
                                       v[wi, lanes].astype(np.float64)
                                       .sum(0), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["ray", "cell"])
def test_warp_grouped_dtable_against_float64(kind):
    """K6b's sums as the kernel groups them: per warp of 32 consecutive
    points, per level and corner, the peers' sums by ``reduce_peers``, each
    group's sum added once (``index_add_``, float32)."""
    geo = phg.level_geometry(*SMALL)
    x, table = _points(kind, geo), _table(geo)
    n = x.shape[0]
    g = np.random.default_rng(8).normal(
        0, 1, (n, SMALL[1] * C)).astype(np.float32)
    ref_dt, _, _ = _oracle64(x, g, table, geo)
    dt = torch.zeros(table.shape, dtype=torch.float32)
    xt = torch.from_numpy(x)
    for lvl, (off, size, scale, res, hashed) in enumerate(
            phg.geometry_levels(geo)):
        pos_grid, frac = phg.level_terms(xt, scale)
        g_l = torch.from_numpy(g[:, lvl * C:(lvl + 1) * C])
        for bits in range(8):
            idx = phg._corner_index(he._corners(pos_grid, bits), res, size,
                                    hashed) + off
            wg = (phg.corner_weight(frac, bits)[:, None] * g_l).numpy()
            rows = idx.numpy().reshape(-1, 32)
            sums, lead = reduce_peers(rows, wg.reshape(-1, 32, C))
            if kind == "cell" and lvl == 0:
                assert lead.sum() == rows.shape[0]  # one row a warp
            dt.index_add_(0, torch.from_numpy(rows[lead]),
                          torch.from_numpy(sums[lead]))
    assert _fro(dt.numpy(), ref_dt) <= TOL_FRO


KEY_PAIR = 1 << 31  # kPairKey: an aligned row pair's key
KEY_NONE = 0xFFFFFFE0  # kNoKey | lane: a lane past the last point


@pytest.mark.parametrize("kind", ["ray", "cell", "uniform"])
def test_corner_pair_keys_dtable_against_float64(kind):
    """``scatter_level`` of ``csrc/hash_encode.cu`` at C = 2, emulated: per
    warp of 32 consecutive points (the tail padded with lanes of no point),
    level and dim-0 corner pair (b, b + 1), one key for both corners where
    their rows share an aligned row pair (r0 ^ r1 == 1), summed by
    ``reduce_peers`` over 2C values and added once; else r0's key, then r1's
    in a second round. The float32 sums hold the float64 oracle."""
    geo = phg.level_geometry(*SMALL)
    x, table = _points(kind, geo), _table(geo)
    n = x.shape[0]
    g = np.random.default_rng(9).normal(
        0, 1, (n, SMALL[1] * C)).astype(np.float32)
    ref_dt, _, _ = _oracle64(x, g, table, geo)
    n_pad = -(-n // 32) * 32
    valid = (np.arange(n_pad) < n).reshape(-1, 32)
    none = KEY_NONE | np.broadcast_to(LANES, valid.shape)
    dt = torch.zeros(table.shape, dtype=torch.float32)
    xt = torch.from_numpy(x)
    pairs = adds = 0
    for lvl, (off, size, scale, res, hashed) in enumerate(
            phg.geometry_levels(geo)):
        pos_grid, frac = phg.level_terms(xt, scale)
        g_l = torch.from_numpy(g[:, lvl * C:(lvl + 1) * C])

        def corner(bits):
            idx = phg._corner_index(he._corners(pos_grid, bits), res, size,
                                    hashed) + off
            wg = (phg.corner_weight(frac, bits)[:, None] * g_l).numpy()
            return (np.pad(idx.numpy(), (0, n_pad - n)).reshape(-1, 32),
                    np.pad(wg, ((0, n_pad - n), (0, 0))).reshape(-1, 32, C))

        level_adds = 0
        for b in range(0, 8, 2):
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
                          torch.from_numpy(sums[lead][:, :C]))
            both = lead & pair
            dt.index_add_(0, torch.from_numpy(base[both] + 1),
                          torch.from_numpy(sums[both][:, C:]))
            own = valid & ~pair
            sums1, lead1 = reduce_peers(np.where(own, r1, none), v1)
            lead1 &= own
            dt.index_add_(0, torch.from_numpy(r1[lead1]),
                          torch.from_numpy(sums1[lead1]))
            pairs += int(pair.sum())
            level_adds += int(lead.sum() + lead1.sum())
        if kind == "cell" and lvl == 0:
            # one cell a warp: one or two adds a corner pair
            assert level_adds <= 2 * 4 * valid.shape[0]
        adds += level_adds
    assert _fro(dt.numpy(), ref_dt) <= TOL_FRO
    corners = n * SMALL[1] * 8
    # some corner pairs share a row pair, and lanes share rows
    assert 0 < pairs < corners // 2 and adds < corners
