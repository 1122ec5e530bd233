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
row count that is not a multiple of 64; and K2 (and K3b) in its default row
chunks and splits against K2 with a forced small chunk and one split a
chunk, at M = 333, 65,573 (lego width) and a ragged last chunk. Tolerances: f32
raw atol 1e-5 and dx, dv and every weight gradient within 1e-4 of the
largest |value| of that tensor (summation order); bf16 raw within 5e-3 of
max |raw|, and — because an activation that differs by an ulp can round to
another bf16 value or take the other side of a relu, which changes that
row's backward by a whole term — at most 5% of the dx/dv rows off by more
than 5e-3 of the max and each weight gradient within 5e-2 in relative
Frobenius norm. The chunked comparison is exact on dx/dv (a row's
arithmetic does not depend on its chunk) and within 1e-5 on dW/db; two calls
give bitwise-equal dW/db.

K3a/K3b (the masked MLP) in the same cases under three masks — sorted
valid-first (the packed stream), random 60%, all invalid: K3a's invalid rows
exactly 0 and its valid rows bitwise K1's; K3b's dx/dv bitwise K2's under
``draw × valid`` and its dW/db within 1e-5 of them (the same products, dead
tiles skipped, so the splits group the rows differently); both against
their plain versions at the K1/K2 tolerances; all invalid gives exactly zero
gradients (every split of a chunk without live tiles writes a zero
partial).

K6/K6b (the hash encoder, ``csrc/hash_encode.cu``) against their plain
versions over every (D, C) the kernels take, a dense level among them, and
at lego_hash's full table (16 levels, 5,738,832 x 2): uniform points at N =
131,072; the NGP warm step's 131,072 ray-ordered points
(``slice_inputs.ngp_points``); the contention set (16,384 points inside one
level-0 cell, ``cell_points``); ragged N = 1, 31, 33 and 131,077. K6
equals its plain version bit for bit (its float operations are spelled out
as the plain version rounds them); K6b's dtable within 1e-5 in relative Frobenius
norm of a float64 reference (float32 atomics add in another order each
launch) and dx within 1e-5 of max|dx|. A few NGP steps on the card
(per-ray and packed march) launch both."""

import contextlib
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


@contextlib.contextmanager
def _step_rows():
    """The ``step`` telemetry rows emitted inside the block (a row tap)."""
    from nerf_replication_tpu_torch.obs import add_row_tap, remove_row_tap

    rows = []

    def tap(row):
        if row["kind"] == "step":
            rows.append(row)

    add_row_tap(tap)
    try:
        yield rows
    finally:
        remove_row_tap(tap)


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
        for kind in ("sorted", "random", "all_invalid"):
            _k3_case(dev, W, D, skip, m, dtype, kind)


def _mask(kind, m, n, seed):
    """[n] float32 0/1 over the first m real rows."""
    valid = torch.zeros(n)
    if kind == "sorted":  # the packed stream: a valid prefix of ~5%
        valid[:max(1, m // 20)] = 1.0
    elif kind == "random":
        g = torch.Generator().manual_seed(seed)
        valid[:m] = (torch.rand(m, generator=g) < 0.6).float()
    return valid


def _k3_case(dev, W, D, skip, m, dtype, kind):
    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp

    spec, x, v, draw, flat = _mlp_case(dev, W, D, skip, dtype, m, seed=W + m)
    valid = _mask(kind, m, x.shape[0], W + m).to(dev)
    n0 = dict(fmlp.LAUNCHES)
    raw_m = fmlp.mlp_forward(spec, x, v, flat, m, valid=valid)
    dx_m, dv_m, g_m = fmlp.mlp_backward(spec, x, v, draw, flat, m,
                                        valid=valid)
    raw = fmlp.mlp_forward(spec, x, v, flat, m)
    dx, dv, g = fmlp.mlp_backward(spec, x, v, draw * valid[:, None], flat, m)
    torch.cuda.synchronize()
    assert fmlp.LAUNCHES["fused_mlp_fwd_masked"] == \
        n0["fused_mlp_fwd_masked"] + 1
    assert fmlp.LAUNCHES["fused_mlp_bwd_masked"] == \
        n0["fused_mlp_bwd_masked"] + 1
    ok = valid > 0
    assert not raw_m[~ok].any(), (kind, "K3a invalid rows")
    assert torch.equal(raw_m[ok], raw[ok]), (kind, "K3a vs K1")
    assert torch.equal(dx_m, dx) and torch.equal(dv_m, dv), (kind, "dx/dv")
    for a, b in zip(g_m, g):
        assert _rel_err(a, b) <= 1e-5, (kind, dtype)
    if kind == "all_invalid":
        assert not dx_m.any() and not dv_m.any()
        assert not any(t.any() for t in g_m)
        return
    ref = fmlp.forward_tile(spec, x[:m], v[:m], flat) * valid[:m, None]
    rdx, rdv, rg = fmlp.backward_tile(spec, x[:m], v[:m],
                                      draw[:m] * valid[:m, None], flat)
    if dtype == "float32":
        assert float((raw_m[:m] - ref).abs().max()) <= 1e-5
        for a, b in [(dx_m[:m], rdx), (dv_m[:m], rdv), *zip(g_m, rg)]:
            assert _rel_err(a, b) <= 1e-4, kind
        return
    assert _rel_err(raw_m[:m], ref) <= 5e-3
    for a, b in zip(g_m, rg):
        assert float((a - b).norm()) <= 5e-2 * float(b.norm())


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


# (W, D, skip, M, forced chunk rows): fewer rows than a chunk, lego width at
# the smoke's M = 65,573, and an M whose last chunk is ragged
CHUNK_CASES = [(64, 4, 1, 333, 128), (256, 8, 4, 65536 + 37, 8192),
               (64, 4, 1, 2 * 4096 + 3 * 64 + 7, 4096)]


@pytest.mark.parametrize("W,D,skip,m,chunk", CHUNK_CASES)
def test_k2_chunks_and_splits_match(dev, W, D, skip, m, chunk):
    """K2 (and K3b under three masks) over all rows in its default chunks
    and splits against K2 with a forced small chunk and one split a chunk:
    dx/dv bitwise (a row's arithmetic does not depend on its chunk), dW/db
    within 1e-5 of max|value| (the order of the float32 sums); a second
    call gives bitwise-equal dW/db (no atomics)."""
    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp

    for dtype in ("float32", "bfloat16"):
        spec, x, v, draw, flat = _mlp_case(dev, W, D, skip, dtype, m, seed=5)
        for kind in (None, "sorted", "random", "all_invalid"):
            valid = None if kind is None else \
                _mask(kind, m, x.shape[0], m).to(dev)
            dx, dv, g = fmlp.mlp_backward(spec, x, v, draw, flat, m,
                                          valid=valid)
            _, _, g2 = fmlp.mlp_backward(spec, x, v, draw, flat, m,
                                         valid=valid)
            cdx, cdv, cg = fmlp.mlp_backward(spec, x, v, draw, flat, m,
                                             valid=valid, chunk_rows=chunk,
                                             splits=1)
            case = (dtype, kind)
            assert torch.equal(cdx, dx) and torch.equal(cdv, dv), case
            for a, b, c in zip(g, g2, cg):
                assert torch.equal(a, b), case
                assert _rel_err(c, a) <= 1e-5, case


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
    fmlp.reset_launch_counts()
    with _step_rows() as rows:
        fit(cfg, device="cuda", log=lambda s: None)
    losses = [r["stats"]["loss"] for r in rows]
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    assert fmlp.LAUNCHES["fused_mlp_fwd"] > 0
    assert fmlp.LAUNCHES["fused_mlp_bwd"] > 0


LEGO_HASH = (3, 16, 2, float(2 ** (np.log2(1024 / 16) / 15)), 16, 19)
HASH_CASES = [
    # (D, L, C, per-level scale, base resolution, log2 T, N, points)
    (3, 4, 2, 1.5, 4, 8, 3000, "uniform"),
    (3, 6, 2, 1.39, 16, 11, 3001, "uniform"),
    (2, 3, 4, 2.0, 4, 9, 777, "uniform"),
    (4, 2, 2, 1.5, 3, 10, 513, "uniform"),
    (3, 2, 2, 2.0, 1, 8, 100, "uniform"),  # level 0 dense
    (3, 3, 1, 1.5, 4, 9, 1000, "uniform"),
    (2, 2, 8, 2.0, 4, 8, 999, "uniform"),
    LEGO_HASH + (131072, "uniform"),
    # the main path's order: the NGP warm step's ray-ordered points
    LEGO_HASH + (131072, "ray"),
    # contention: every point in one level-0 cell
    LEGO_HASH + (16384, "cell"),
    (3, 4, 2, 1.5, 4, 8, 3000, "cell"),
    # ragged N
    LEGO_HASH + (1, "uniform"),
    LEGO_HASH + (31, "uniform"),
    LEGO_HASH + (33, "uniform"),
    LEGO_HASH + (131072 + 5, "uniform"),
]


def test_k6_k6b_kernel_match_plain(dev):
    from nerf_replication_tpu_torch.models.encoding.hashgrid import (
        level_geometry,
    )
    from nerf_replication_tpu_torch.ops import hash_encode as he
    from nerf_replication_tpu_torch.tools.slice_inputs import (
        cell_points,
        ngp_points,
    )

    for d, lvls, c, scale, base, log2_t, n, points in HASH_CASES:
        geo = level_geometry(d, lvls, scale, base, log2_t)
        gen = torch.Generator(device=dev).manual_seed(n)
        table = torch.rand((geo[0][-1], c), generator=gen, device=dev) * 2 - 1
        x = torch.rand((n, d), generator=gen, device=dev)
        if points == "ray":
            x = torch.from_numpy(ngp_points(0)).to(dev)
        elif points == "cell":
            x = torch.from_numpy(cell_points(n, geo[1][0], d)).to(dev)
        assert x.shape == (n, d)
        g = torch.randn((n, lvls * c), generator=gen, device=dev)
        before = dict(he.LAUNCHES)
        out = he.hash_encode_fwd(x, table, geo)
        ref = he.forward_plain(x, table, geo)
        dt, dx = he.hash_encode_bwd(x, g, table, geo, want_dx=True)
        _, rdx = he.backward_plain(x, g, table, geo, want_dx=True)
        torch.cuda.synchronize()
        assert he.LAUNCHES["hash_encode_fwd"] == before["hash_encode_fwd"] + 1
        assert he.LAUNCHES["hash_encode_bwd"] == before["hash_encode_bwd"] + 1
        case = (d, lvls, c, n, points)
        assert torch.equal(out, ref), case
        ref_dt, _ = he.backward_plain(x, g, table, geo, want_dx=False,
                                      accum=torch.float64)
        assert float((dt.double() - ref_dt).norm()) <= 1e-5 * float(
            ref_dt.norm()), case
        assert float((dx - rdx).abs().max()) <= 1e-5 * float(
            rdx.abs().max()), case
        # without dx the table gradient is the same kernel's
        dt2, none = he.hash_encode_bwd(x, g, table, geo)
        assert none is None
        assert float((dt2 - dt).norm()) <= 1e-5 * float(dt.norm()), case


def test_ngp_train_steps_launch_k6_k6b(dev, tmp_path):
    """A few NGP steps on the card (lego_hash at a small table, a 32x32
    procedural scene), warm then march, per-ray and packed: finite losses
    and K6/K6b launched."""
    from nerf_replication_tpu_torch.datasets.procedural import generate_scene
    from nerf_replication_tpu_torch.ops import hash_encode as he
    from nerf_replication_tpu_torch.train.trainer import fit

    root = str(tmp_path / "data")
    generate_scene(root, "procedural", H=32, W=32, n_train=4, n_test=1)
    hash_cfg = os.path.join(os.path.dirname(LEGO), "lego_hash.yaml")
    for packed in ("false", "true"):
        out = str(tmp_path / f"out_{packed}")
        cfg = make_cfg(hash_cfg, [
            "scene", "procedural", "exp_name", "card",
            "train_dataset.data_root", root, "test_dataset.data_root", root,
            "train_dataset.H", "32", "train_dataset.W", "32",
            "test_dataset.H", "32", "test_dataset.W", "32",
            "network.xyz_encoder.log2_hashmap_size", "14",
            "task_arg.ngp_training", "true", "task_arg.ngp_packed_march",
            packed, "task_arg.ngp_warmup_steps", "2",
            "task_arg.ngp_warmup_max", "2", "task_arg.N_rays", "256",
            "ep_iter", "4", "train.epoch", "1", "log_interval", "1",
            "eval_ep", "1", "save_ep", "1", "save_latest_ep", "1",
            "trained_model_dir", os.path.join(out, "trained"),
            "record_dir", os.path.join(out, "record"),
            "result_dir", os.path.join(out, "result"),
            "trained_config_dir", os.path.join(out, "config")])
        he.reset_launch_counts()
        with _step_rows() as rows:
            state = fit(cfg, device="cuda", log=lambda s: None)
        torch.cuda.synchronize()
        assert state.step == 4
        assert [r["stats"]["warm"] for r in rows] == [True, True, False, False]
        assert all(np.isfinite(r["stats"]["loss"]) for r in rows)
        assert he.LAUNCHES["hash_encode_fwd"] > 0
        assert he.LAUNCHES["hash_encode_bwd"] > 0
