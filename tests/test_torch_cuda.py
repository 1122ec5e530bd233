"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Needs an NVIDIA card and ``nvcc``; skips elsewhere. It imports no JAX, so it
runs on a machine without it (``--noconftest`` skips the JAX-side test
harness):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Covers the paths chip_smoke.py's lego run does not: the uncompacted
(K = K_c·r) and bbox-clipped traversals, zero padding rays, a ragged last
CTA, and a small non-lego width. K4 is exact; K5 maps are held to 1e-5
(f32, summation order) and 1e-3 (bf16 operands).

K1/K2 (the fused MLP) against their plain versions at W = 64 and 256, skip
after layer 1 and 4, both families, fewer rows than one 64-row tile and a
row count that is not a multiple of 64; and K2's persistent grid (several
tiles per CTA) against K2 over chunks of one tile per CTA. Tolerances: f32
raw atol 1e-5 and dx, dv and every weight gradient within 1e-4 of the
largest |value| of that tensor (summation order); bf16 raw within 5e-3 of
max |raw|, and — because an activation that differs by an ulp can round to
another bf16 value or take the other side of a relu, which changes that
row's backward by a whole term — at most 5% of the dx/dv rows off by more
than 5e-3 of the max and each weight gradient within 5e-2 in relative
Frobenius norm. The chunked comparison is exact on dx/dv (a row's
arithmetic does not depend on its CTA) and within 1e-5 on dW/db."""

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
def test_k5_kernel_matches_plain(dev, case):
    for dtype in ("float32", "bfloat16"):
        _k5_case(dev, case, dtype)


def _k5_case(dev, case, dtype):
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


def _mlp_case(dev, W, D, skip, dtype, m, seed):
    from nerf_replication_tpu_torch.ops.fused_mlp import FusedSpec

    td = getattr(torch, dtype)
    cfg = make_cfg(LEGO, ["network.nerf.W", str(W), "network.nerf.D",
                          str(D), "network.nerf.skips", f"[{skip}]"])
    net = make_network(cfg)
    init_params(net, torch.Generator().manual_seed(seed))
    with torch.no_grad():  # non-zero biases reach every bias path
        for p in net.fine.parameters():
            if p.dim() == 1:
                p.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(
                    seed + p.numel()))
    net = net.to(dev)
    spec = fused_spec_for(net.clone(td))
    assert isinstance(spec, FusedSpec)
    rng = np.random.default_rng(seed)
    x = torch.zeros((m + 5, spec.c_in_pad))
    x[:, :spec.c_in] = torch.from_numpy(rng.normal(0, 1, (m + 5, spec.c_in)))
    v = torch.zeros((m + 5, spec.c_views_pad))
    v[:, :spec.c_views] = torch.from_numpy(
        rng.normal(0, 1, (m + 5, spec.c_views)))
    draw = torch.from_numpy(rng.normal(0, 1, (m + 5, 8)).astype(np.float32))
    draw[m:] = 0.0
    flat = [t.detach() for t in spec.flatten_params(net.fine)]
    return spec, x.to(dev), v.to(dev), draw.to(dev), flat


def _rel_err(a, b):
    scale = max(float(b.abs().max()), 1e-30)
    return float((a - b).abs().max()) / scale


MLP_CASES = [(64, 4, 1, 37), (64, 4, 1, 64 * 3 + 5), (256, 8, 4, 20),
             (256, 8, 4, 64 * 5 + 13)]


@pytest.mark.parametrize("W,D,skip,m", MLP_CASES)
def test_k1_k2_kernel_match_plain(dev, W, D, skip, m):
    for dtype in ("float32", "bfloat16"):
        _k1_k2_case(dev, W, D, skip, m, dtype)


def _k1_k2_case(dev, W, D, skip, m, dtype):
    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp

    spec, x, v, draw, flat = _mlp_case(dev, W, D, skip, dtype, m, seed=W + m)
    n0 = dict(fmlp.LAUNCHES)
    raw = fmlp.mlp_forward(spec, x, v, flat, m)
    dx, dv, grads = fmlp.mlp_backward(spec, x, v, draw, flat, m)
    torch.cuda.synchronize()
    assert fmlp.LAUNCHES["fused_mlp_fwd"] == n0["fused_mlp_fwd"] + 1
    assert fmlp.LAUNCHES["fused_mlp_bwd"] == n0["fused_mlp_bwd"] + 1
    ref_raw = fmlp.forward_tile(spec, x[:m], v[:m], flat)
    rdx, rdv, rgrads = fmlp.backward_tile(spec, x[:m], v[:m], draw[:m], flat)
    assert float(raw[m:].abs().max()) == 0.0
    assert float(raw[:m, 4:].abs().max()) == 0.0
    assert float(dx[m:].abs().max()) == 0.0
    for g, r in zip(grads, rgrads):
        assert g.shape == r.shape
    if dtype == "float32":
        assert float((raw[:m] - ref_raw).abs().max()) <= 1e-5
        for a, b in [(dx[:m], rdx), (dv[:m], rdv), *zip(grads, rgrads)]:
            assert _rel_err(a, b) <= 1e-4
        return
    assert _rel_err(raw[:m], ref_raw) <= 5e-3
    for a, b in ((dx[:m], rdx), (dv[:m], rdv)):
        off = ((a - b).abs() > 5e-3 * float(b.abs().max())).any(-1)
        assert float(off.float().mean()) <= 0.05
    for g, r in zip(grads, rgrads):
        assert float((g - r).norm()) <= 5e-2 * float(r.norm())


def test_k2_persistent_grid_matches_one_tile_per_cta(dev):
    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp

    chunk = fmlp._backward_ctas(dev, 10**9) * 64
    m = 2 * chunk + 3 * 64 + 7  # CTAs with three and with two tiles
    for dtype in ("float32", "bfloat16"):
        spec, x, v, draw, flat = _mlp_case(dev, 64, 4, 1, dtype, m, seed=5)
        dx, dv, grads = fmlp.mlp_backward(spec, x, v, draw, flat, m)
        parts = [fmlp.mlp_backward(spec, x[i:i + chunk], v[i:i + chunk],
                                   draw[i:i + chunk], flat,
                                   min(chunk, m - i))
                 for i in range(0, m, chunk)]
        rows = [min(chunk, m - i) for i in range(0, m, chunk)]
        assert torch.equal(
            torch.cat([p[0][:r] for p, r in zip(parts, rows)]), dx[:m])
        assert torch.equal(
            torch.cat([p[1][:r] for p, r in zip(parts, rows)]), dv[:m])
        for j, g in enumerate(grads):
            assert _rel_err(g, sum(p[2][j] for p in parts)) <= 1e-5, \
                (dtype, j)


def test_k2_skips_dx_dv_and_is_deterministic(dev):
    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp

    spec, x, v, draw, flat = _mlp_case(dev, 64, 4, 1, "float32", 700, seed=2)
    dx, dv, g1 = fmlp.mlp_backward(spec, x, v, draw, flat, 700,
                                   want_dx=False, want_dv=False)
    _, _, g2 = fmlp.mlp_backward(spec, x, v, draw, flat, 700)
    assert dx is None and dv is None
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


def test_fused_train_steps_are_finite(dev, tmp_path):
    """Two steps of the fused trainer on the card (lego width, a 32x32
    procedural scene): finite losses, both MLP kernels launched."""
    from nerf_replication_tpu_torch.datasets.procedural import generate_scene
    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp
    from nerf_replication_tpu_torch.train.trainer import fit

    root = str(tmp_path / "data")
    generate_scene(root, "procedural", H=32, W=32, n_train=4, n_test=1)
    out = str(tmp_path / "out")
    cfg = make_cfg(LEGO, [
        "scene", "procedural", "exp_name", "card",
        "train_dataset.data_root", root, "test_dataset.data_root", root,
        "train_dataset.H", "32", "train_dataset.W", "32",
        "test_dataset.H", "32", "test_dataset.W", "32",
        "network.nerf.fused_trunk", "true", "network.nerf.fused_tile", "512",
        "ep_iter", "2", "train.epoch", "1", "log_interval", "1",
        "eval_ep", "100", "save_ep", "100", "save_latest_ep", "100",
        "trained_model_dir", out + "/trained", "record_dir", out + "/record",
        "result_dir", out + "/result", "trained_config_dir", out + "/cfg"])
    rows = []
    fmlp.reset_launch_counts()
    fit(cfg, device="cuda", emit=rows.append, log=lambda s: None)
    losses = [r["stats"]["loss"] for r in rows]
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    assert fmlp.LAUNCHES["fused_mlp_fwd"] > 0
    assert fmlp.LAUNCHES["fused_mlp_bwd"] > 0
