"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Needs an NVIDIA card and ``nvcc``; skips elsewhere. It imports no JAX, so it
runs on a machine without it (``--noconftest`` skips the JAX-side test
harness):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Covers the paths chip_smoke.py's lego run does not: the uncompacted
(K = K_c·r) and bbox-clipped traversals, zero padding rays, a ragged last
CTA, and a small non-lego width. K4 is exact; K5 maps are held to 1e-5
(f32, summation order) and 1e-3 (bf16 operands)."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nerf_replication_tpu_torch.config import make_cfg  # noqa: E402
from nerf_replication_tpu_torch.models import make_network  # noqa: E402
from nerf_replication_tpu_torch.models.nerf.network import init_params  # noqa: E402
from nerf_replication_tpu_torch.ops import fused_march as fm  # noqa: E402
from nerf_replication_tpu_torch.ops.fused_mlp import fused_spec_for  # noqa: E402
from nerf_replication_tpu_torch.renderer.accelerated import MarchOptions  # noqa: E402

LEGO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "nerf", "lego.yaml")
BBOX = [[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]]

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rays(n, seed, n_zero=0):
    rng = np.random.default_rng(seed)
    o = np.tile([0.0, 0.0, 4.0], (n, 1)) + rng.normal(0, 0.05, (n, 3))
    d = np.array([0.0, 0.0, -1.0]) + rng.normal(0, 0.2, (n, 3))
    rays = np.concatenate([o, d], -1).astype(np.float32)
    rays[n - n_zero:] = 0.0
    return torch.from_numpy(rays)


def _grid(res, seed):
    rng = np.random.default_rng(seed)
    g = np.zeros((res, res, res), bool)
    lo, hi = res // 4, 3 * res // 4
    g[lo:hi, lo:hi, lo:hi] = rng.random((hi - lo,) * 3) < 0.6
    return torch.from_numpy(g)


CASES = {
    "uncompacted": dict(step_size=0.05, max_samples=400, coarse_block=4),
    "compact": dict(step_size=0.02, max_samples=24, coarse_block=8),
    "clip": dict(step_size=0.05, max_samples=32, coarse_block=4,
                 clip_bbox=True),
    "k_c_1": dict(step_size=0.05, max_samples=16, coarse_block=4,
                  coarse_cap=1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_k4_kernel_matches_plain(dev, case):
    opts = MarchOptions(**CASES[case])
    rays = _rays(301, seed=1, n_zero=13).to(dev)
    st, rays, g, c, bbox = fm._prepare(
        rays, 2.0, 6.0, _grid(32, 2).to(dev),
        torch.tensor(BBOX, device=dev), opts)
    ker = fm.dda_block(st, rays, g, c, bbox)
    ref = fm.dda_block_plain(st, rays, g, c, bbox)
    torch.cuda.synchronize()
    for name, a, b in zip(("t_sel", "valid", "flat_sel", "n_occ", "n_blk",
                           "dist"), ker, ref):
        assert torch.equal(a, b), (case, name)
    assert int(ref[3].sum()) > 0


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_kernel_matches_plain(dev, case, dtype):
    cfg = make_cfg(LEGO, ["network.nerf.W", "64", "network.nerf.D", "4",
                          "network.nerf.skips", "[1]"])
    net = make_network(cfg)
    init_params(net, torch.Generator().manual_seed(3))
    with torch.no_grad():
        net.fine.alpha_linear.bias.fill_(2.0)  # some rays terminate
    net = net.to(dev)
    td = getattr(torch, dtype)
    spec = fused_spec_for(net.clone(td))
    weights = fm.FusedWeights(spec, net.fine)
    opts = MarchOptions(**CASES[case])
    rays = _rays(301, seed=4, n_zero=13).to(dev)
    st, rays, g, c, bbox = fm._prepare(
        rays, 2.0, 6.0, _grid(32, 5).to(dev),
        torch.tensor(BBOX, device=dev), opts)
    with torch.inference_mode():
        ker = fm.march_full_block(st, weights, net.xyz_encoder,
                                  net.dir_encoder, 2, rays, g, c, bbox)
        ref = fm.march_full_plain(st, spec, net.xyz_encoder, net.dir_encoder,
                                  2, rays, g, c, bbox, weights.flat)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == "float32" else 1e-3
    for i, name in enumerate(("rgb", "depth", "acc")):
        t = tol * (10 if name == "depth" else 1)
        err = float((ker[i] - ref[i]).abs().max())
        assert err <= t, (case, name, err)
    assert torch.equal(ker[4], ref[4]) and torch.equal(ker[5], ref[5])
    assert int((ker[3] != ref[3]).sum()) <= 1
    if case != "k_c_1":  # one kept block is too short to turn opaque
        assert float(ref[2].max()) > 0.5  # the opaque bias finishes rays


def test_engine_launches_kernels(dev):
    from nerf_replication_tpu_torch.serve import RenderEngine

    cfg = make_cfg(LEGO, ["network.nerf.W", "64", "network.nerf.D", "4",
                          "network.nerf.skips", "[1]",
                          "task_arg.march_coarse_block", "8",
                          "task_arg.march_fused", "full",
                          "serve.buckets", "[4096]"])
    net = make_network(cfg)
    init_params(net, torch.Generator().manual_seed(0))
    fm.reset_launch_counts()
    eng = RenderEngine(cfg, net, 2.0, 6.0, grid=_grid(128, 1).cpu().numpy(),
                       bbox=np.asarray(BBOX, np.float32), device="cuda")
    n0 = fm.LAUNCHES["fused_march_full"]
    out = eng.render_request(_rays(1000, 9).numpy(), 2.0, 6.0, tier="bf16")
    assert fm.LAUNCHES["fused_march_full"] == n0 + 1
    assert np.isfinite(out["rgb_map_f"]).all()
