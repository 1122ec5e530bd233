"""K4 (``csrc/fused_dda.cu``: a warp a ray, ballot compaction, the exact
coarse-block shortcut) against its plain version, on the card.

Needs an NVIDIA card and ``nvcc``; skips elsewhere. It imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_dda.py -q

K4 must equal ``dda_block_plain`` bit for bit on all six outputs (t_sel,
valid, flat_sel, n_occ, n_blk, dist): on rays that graze coarse-cell faces,
run along axes, cross cell corners diagonally or are zero
(``tools/slice_inputs.edge_rays``), in the compacted (K < K_c·r),
uncompacted (K = K_c·r), bbox-clipped and K_c = 1 modes (the last at K = 6,
where the valid row takes byte stores; it and the uncompacted one at S =
134, a last block of 6 of r = 8 positions), on the 128³ ball grid; at ragged
ray counts (1, 31, 33 and 16,384 + 5: a CTA holds 8 rays); and two
launches give bitwise-equal outputs."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nerf_replication_tpu_torch.ops import fused_march as fm  # noqa: E402
from nerf_replication_tpu_torch.renderer.accelerated import MarchOptions  # noqa: E402
from nerf_replication_tpu_torch.tools.slice_inputs import (  # noqa: E402
    ball_grid,
    edge_rays,
    view_rays,
)

pytestmark = pytest.mark.cuda

BBOX = [[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]]
LEGO = dict(step_size=0.005, max_samples=192, coarse_block=8)
MODES = {
    "compact": LEGO,
    "uncompacted": dict(LEGO, step_size=0.03, max_samples=256),
    "clip": dict(LEGO, step_size=0.01, max_samples=64, clip_bbox=True),
    "k_c_1": dict(LEGO, step_size=0.03, max_samples=6, coarse_cap=1),
}
NAMES = ("t_sel", "valid", "flat_sel", "n_occ", "n_blk", "dist")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, rays, **kw):
    return fm._prepare(torch.from_numpy(rays).to(dev), 2.0, 6.0,
                       torch.from_numpy(ball_grid()).to(dev),
                       torch.tensor(BBOX, device=dev), MarchOptions(**kw))


def _assert_exact(ker, ref, label):
    torch.cuda.synchronize()
    for name, a, b in zip(NAMES, ker, ref):
        assert a.dtype == b.dtype and torch.equal(a, b), (
            label, name, int((a != b).sum()))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_k4_edge_rays_match_plain(dev, mode):
    """Grazing, axis-aligned, corner-diagonal, zero and view rays in every
    traversal mode: bitwise the plain version."""
    st, rays, g, c, bbox = _inputs(dev, edge_rays(2400, seed=21),
                                   **MODES[mode])
    assert st.compact == (mode != "uncompacted")
    ker = fm.dda_block(st, rays, g, c, bbox)
    ref = fm.dda_block_plain(st, rays, g, c, bbox)
    _assert_exact(ker, ref, mode)
    assert int((ref[3] > 0).sum()) > 100
    assert not bool(ref[3][4::6].any())  # the zero rays admit nothing


@pytest.mark.parametrize("n", [1, 31, 33, 16384 + 5])
def test_k4_ragged_counts_match_plain(dev, n):
    """Ray counts that leave the last CTA partly empty, on the serving
    camera's rays (and edge rays past 16,384): bitwise the plain version;
    two launches bitwise equal."""
    rays = view_rays(30.0, 128)
    if n > rays.shape[0]:
        rays = np.concatenate([rays, edge_rays(n - rays.shape[0], seed=5)])
    idx = np.random.default_rng(n).permutation(rays.shape[0])[:n]
    st, rays_t, g, c, bbox = _inputs(dev, rays[np.sort(idx)], **LEGO)
    first = fm.dda_block(st, rays_t, g, c, bbox)
    second = fm.dda_block(st, rays_t, g, c, bbox)
    ref = fm.dda_block_plain(st, rays_t, g, c, bbox)
    _assert_exact(first, ref, n)
    _assert_exact(second, first, (n, "relaunch"))
