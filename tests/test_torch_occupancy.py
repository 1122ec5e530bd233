"""Port parity of the occupancy grid: the ``.npz`` pyramid artifact reads
back identically across the two packages (both directions, checksum sidecar
included), the coarse level and world→voxel lookup match exactly, and the
bake at R=8 marks the same voxels."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import BBOX, ROOT, both_cfgs, nets

from nerf_replication_tpu.renderer import occupancy as jocc
from nerf_replication_tpu_torch.renderer import occupancy as pocc


def _random_grid(res=16, seed=0, p=0.2):
    return np.random.default_rng(seed).random((res, res, res)) < p


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_cross_read(tmp_path, writer):
    """A pyramid written by either package loads identically in both
    (same keys, same levels, same bbox, checksum verified)."""
    grid = _random_grid(16)
    path = str(tmp_path / "occupancy_grid.npz")
    save = jocc.save_occupancy_grid if writer == "jax" else \
        pocc.save_occupancy_grid
    save(path, grid, BBOX, 0.5)
    assert os.path.exists(path + ".sha256")
    jl, jb = jocc.load_occupancy_pyramid(path)
    pl, pb = pocc.load_occupancy_pyramid(path)
    assert len(jl) == len(pl) == 3
    for a, b in zip(jl, pl):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jb, pb)
    np.testing.assert_array_equal(pl[0], grid)
    with np.load(path) as z:
        assert sorted(z.files) == ["bbox", "grid", "level_1", "level_2",
                                   "pyramid_factors", "pyramid_version",
                                   "threshold"]


def test_repo_grid_artifact_loads_in_both():
    """The JAX-baked lego grid shipped under logs/ loads the same in the
    port."""
    path = os.path.join(ROOT, "logs", "lego", "occupancy_grid.npz")
    jl, jb = jocc.load_occupancy_pyramid(path)
    pl, pb = pocc.load_occupancy_pyramid(path)
    for a, b in zip(jl, pl):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jb, pb)


def test_corrupt_artifact_raises_oserror(tmp_path):
    path = str(tmp_path / "g.npz")
    pocc.save_occupancy_grid(path, _random_grid(8), BBOX, 0.5)
    with open(path, "r+b") as f:
        f.seek(40)
        f.write(b"\x00" * 16)
    with pytest.raises(OSError, match="checksum"):
        pocc.load_occupancy_pyramid(path)
    # a torn archive without a sidecar is still refused
    os.remove(path + ".sha256")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)
    with pytest.raises(OSError, match="corrupt"):
        pocc.load_occupancy_pyramid(path)


@pytest.mark.parametrize("res,factor", [(16, 4), (18, 4), (16, 2)])
def test_coarse_from_grid_matches_jax(res, factor):
    grid = _random_grid(res, seed=res, p=0.05)
    ref = np.asarray(jocc.coarse_from_grid(jnp.asarray(grid), factor))
    out = pocc.coarse_from_grid(torch.from_numpy(grid), factor).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(pocc.build_pyramid(grid)[-1 if factor == 4
                                                           else 1], ref)


@pytest.mark.parametrize("res", [16, 128])
def test_world_to_voxel_matches_jax(res):
    """Exact voxel ids on points inside and outside the bbox."""
    pts = np.random.default_rng(res).uniform(-1.7, 1.7, (20000, 3)).astype(
        np.float32)
    ref = np.asarray(jocc.world_to_voxel(jnp.asarray(pts), jnp.asarray(BBOX),
                                         res))
    out = pocc.world_to_voxel(torch.from_numpy(pts), torch.from_numpy(BBOX),
                              res).numpy()
    np.testing.assert_array_equal(out, ref)


def test_bake_occupancy_grid_matches_jax():
    """R=8 bake from the coarse network with zero viewdirs: the same voxels
    (threshold chosen so both occupied and empty voxels exist)."""
    opts = ["network.nerf.W", "32", "network.nerf.D", "4",
            "network.nerf.skips", "[1]",
            "task_arg.occupancy_grid_res", "8",
            "task_arg.occupancy_grid_threshold", "0.05",
            "task_arg.occupancy_grid_batch_size", "100"]
    jnet, params, pnet = nets(extra=opts)
    jcfg, pcfg = both_cfgs(opts)
    ref = jocc.bake_occupancy_grid(params, jnet, jcfg)
    out = pocc.bake_occupancy_grid(pnet, pcfg, device="cpu")
    assert out.shape == (8, 8, 8) and out.dtype == bool
    assert 0 < out.sum() < out.size
    np.testing.assert_array_equal(out, ref)


def test_default_grid_path_matches_jax():
    cfg = os.path.join(ROOT, "configs", "nerf", "lego.yaml")
    assert pocc.default_grid_path(cfg) == jocc.default_grid_path(cfg)
