"""Port parity of the occupancy-accelerated eval: ``Renderer.render_accelerated``
on every route, its truncation report, the eval / bake / check CLIs
(``python -m nerf_replication_tpu_torch.run --type evaluate``, ``train
--test``, ``occupancy_grid``, ``check_grid``) and the serving engine's
staged (``march_fused off``) and grid-less routes — against the JAX package
on the same weights, grid file and rays (D=4, W=32; a 16³ grid; a 16×16
procedural scene for the CLIs).

Tolerances: maps ``atol 1e-5`` (depth 1e-4 where the per-ray march's K-slot
sums carry the MLP's summation order into t ≈ 2..6); the chunked render
(no grid) 1e-3 to 2e-3 (depth 10×), since an importance sample that
inherits that order can cross a density step; the bf16 tier 2e-2 as in
``test_torch_serve.py``; truncation counts and traversal stats exact."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (
    BBOX,
    FAR,
    LEGO,
    NEAR,
    ROOT,
    SMALL_NET,
    both_cfgs,
    nets,
    sample_rays,
)

from nerf_replication_tpu.renderer import volume as jv
from nerf_replication_tpu_torch.renderer import volume as pv
from nerf_replication_tpu_torch.renderer.gate import full_image_render_fn
from nerf_replication_tpu_torch.renderer.occupancy import save_occupancy_grid

MARCH = SMALL_NET + [
    "task_arg.render_step_size", "0.0625",
    "task_arg.max_march_samples", "16",
    "task_arg.march_chunk_size", "32",
    "task_arg.N_samples", "16", "task_arg.N_importance", "16",
    "task_arg.chunk_size", "32",
    "network.nerf.fused_tile", "64",
]
ROUTES = {
    "per_ray": [],
    "per_ray_fused": ["network.nerf.fused_trunk", "true"],
    "packed_hier": ["task_arg.march_coarse_block", "4"],
    "packed_hier_fused": ["task_arg.march_coarse_block", "4",
                          "network.nerf.fused_trunk", "true"],
    "packed_clip": ["task_arg.march_clip_bbox", "true",
                    "task_arg.packed_cap_avg_eval", "6"],
    "packed_hier_clip": ["task_arg.march_coarse_block", "4",
                         "task_arg.march_clip_bbox", "true"],
    "packed_clip_fused": ["task_arg.march_clip_bbox", "true",
                          "task_arg.packed_cap_avg_eval", "6",
                          "network.nerf.fused_trunk", "true"],
    "per_ray_eval_budget": ["task_arg.eval_render_step_size", "0.125",
                            "task_arg.eval_max_march_samples", "8"],
    "gather": ["task_arg.march_coarse_block", "4",
               "task_arg.march_fused", "gather"],
    "full": ["task_arg.march_coarse_block", "4",
             "task_arg.march_fused", "full"],
}


def _grid(res=16):
    c = (np.arange(res) + 0.5) / res * 2.0 - 1.0
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    g = (x * x + y * y + z * z) < 0.6 ** 2
    return g | (np.random.default_rng(1).random(g.shape) < 0.1)


@pytest.fixture(scope="module")
def grid_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("grid") / "occupancy_grid.npz")
    save_occupancy_grid(path, _grid(), BBOX, 1.0)
    return path


@pytest.fixture(scope="module")
def weights():
    return nets(seed=4)


def _renderers(weights, extra, grid_path):
    jnet, params, pnet = weights
    jcfg, pcfg = both_cfgs(MARCH + extra)
    jr = jv.Renderer(jcfg, jnet)
    pr = pv.Renderer(pcfg, pnet)
    if grid_path is not None:
        assert jr.load_occupancy_grid(grid_path)
        assert pr.load_occupancy_grid(grid_path)
    return params, jr, pr


def _batch_pair(rays):
    return ({"rays": jnp.asarray(rays), "near": NEAR, "far": FAR},
            {"rays": torch.from_numpy(rays), "near": NEAR, "far": FAR})


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_render_accelerated_matches_jax(weights, grid_file, route):
    """Every route of ``_build_march_fn`` through the render gate (two
    chunks, the last one padded): maps to 1e-5 (depth 1e-4), the
    per-chunk traversal stats and the truncation count exact."""
    params, jr, pr = _renderers(weights, ROUTES[route], grid_file)
    rays = sample_rays(45, seed=6)
    jb, pb = _batch_pair(rays)
    ref = jr.render_accelerated(params, jb)
    render = full_image_render_fn(both_cfgs(MARCH + ROUTES[route])[1],
                                  pr.network, pr, None, use_grid=True)
    out = render(pb)
    assert set(out) == set(ref) == {"rgb_map_f", "depth_map_f", "acc_map_f"}
    for k in ref:
        atol = 1e-4 if k.startswith("depth") else 1e-5
        assert out[k].shape[0] == 45
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=atol, err_msg=k)
    assert set(pr.last_march_stats) == set(jr.last_march_stats)
    for k, v in jr.last_march_stats.items():
        np.testing.assert_array_equal(np.asarray(pr.last_march_stats[k]),
                                      np.asarray(v), err_msg=k)
    assert pr.report_truncation(log=lambda s: None) == \
        jr.report_truncation(log=lambda s: None)


def test_truncation_accumulates_over_renders(weights, grid_file):
    """The per-ray march with a small K truncates; the counter sums over
    renders on the device and resets after one report, as in JAX."""
    params, jr, pr = _renderers(weights, ["task_arg.max_march_samples", "3"],
                                grid_file)
    logs = []
    for seed in (1, 2):
        jb, pb = _batch_pair(sample_rays(40, seed=seed))
        jr.render_accelerated(params, jb)
        with torch.no_grad():
            pr.render_accelerated(pb)
    n = pr.report_truncation(log=logs.append)
    assert n == jr.report_truncation(log=lambda s: None) > 0
    assert logs and "max_march_samples=3" in logs[0]
    assert pr.report_truncation(log=logs.append) == 0


def test_missing_grid_renders_chunked(weights, capsys):
    """No grid file: the JAX message, and render_accelerated is the
    chunked render (coarse + fine maps; bitwise the port's render_chunked),
    stats cleared. Against JAX rgb/acc atol 1e-3, depth 1e-2: with 16
    coarse samples an importance sample that moves by a few ulps lands on
    another side of a density step of the random network (measured 3e-4
    on one ray's acc, 1.8e-3 on its depth, t ≈ 2..6)."""
    params, jr, pr = _renderers(weights, [], None)
    assert not pr.load_occupancy_grid("/nonexistent/occupancy_grid.npz")
    assert "run in slow mode" in capsys.readouterr().out
    rays = sample_rays(20, seed=3)
    jb, pb = _batch_pair(rays)
    ref = jr.render_accelerated(params, jb)
    with torch.no_grad():
        out = pr.render_accelerated(pb)
        chunked = pr.render_chunked(pb)
    assert set(out) == set(ref) and "rgb_map_c" in out
    for k in ref:
        assert torch.equal(out[k], chunked[k]), k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-2 if "depth" in k
                                   else 1e-3, err_msg=k)
    assert pr.last_march_stats == {}


# -- CLIs on a procedural scene ------------------------------------------------


def _cli_opts(root, out):
    return [
        "scene", "procedural", "exp_name", "ev",
        "train_dataset.data_root", root, "test_dataset.data_root", root,
        "train_dataset.H", "16", "train_dataset.W", "16",
        "test_dataset.H", "16", "test_dataset.W", "16",
        "test_dataset.cams", "[0, -1, 1]",
        "task_arg.N_rays", "64", "task_arg.N_samples", "12",
        "task_arg.N_importance", "12", "task_arg.chunk_size", "256",
        "task_arg.precrop_iters", "0", "task_arg.occupancy_grid_res", "16",
        "task_arg.occupancy_grid_threshold", "0.5",
        "task_arg.render_step_size", "0.05",
        "task_arg.march_chunk_size", "128",
        "network.nerf.W", "32", "network.nerf.D", "3",
        "network.nerf.skips", "[1]", "network.xyz_encoder.freq", "4",
        "network.dir_encoder.freq", "2", "ep_iter", "10", "train.epoch", "1",
        "log_interval", "5", "eval_ep", "100", "save_ep", "100",
        "save_latest_ep", "1",
        "trained_model_dir", os.path.join(out, "trained"),
        "trained_config_dir", os.path.join(out, "config"),
        "record_dir", os.path.join(out, "record"),
        "result_dir", os.path.join(out, "result"),
    ]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 16×16 procedural scene, one short CPU epoch, and a work dir whose
    logs/ receives the grid."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.datasets.procedural import generate_scene
    from nerf_replication_tpu_torch.train.trainer import fit

    base = tmp_path_factory.mktemp("eval_cli")
    root = str(base / "data")
    generate_scene(root, "procedural", H=16, W=16, n_train=4, n_test=2)
    opts = _cli_opts(root, str(base / "out"))
    fit(make_cfg(LEGO, opts), device="cpu", log=lambda s: None)
    return base, opts


def test_bake_check_and_evaluate_clis(trained, monkeypatch, capsys):
    """occupancy_grid bakes logs/lego/occupancy_grid.npz from the trained
    checkpoint, check_grid reads it, ``run --type evaluate`` (a subprocess,
    as a user runs it) renders both test views through the grid, and
    ``train --test`` gives the same summary."""
    from nerf_replication_tpu_torch import check_grid, occupancy_grid
    from nerf_replication_tpu_torch.train.__main__ import main as train_main

    base, opts = trained
    monkeypatch.chdir(base)
    assert occupancy_grid.main(["--cfg_file", LEGO, "--device", "cpu",
                                *opts]) == 0
    grid_path = base / "logs" / "lego" / "occupancy_grid.npz"
    assert grid_path.exists()
    assert check_grid.main(["--cfg_file", LEGO]) == 0
    assert "occupied:" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="matplotlib"):
        check_grid.main(["--cfg_file", LEGO, "--visualize"])

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run(
        [sys.executable, "-m", "nerf_replication_tpu_torch.run", "--type",
         "evaluate", "--cfg_file", LEGO, "--device", "cpu", *opts],
        capture_output=True, text=True, timeout=300, cwd=str(base), env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "mean net_time" in res.stdout and "not found" not in res.stdout
    from nerf_replication_tpu_torch.config import make_cfg

    result_dir = make_cfg(LEGO, opts).result_dir
    with open(os.path.join(result_dir, "summary.json")) as f:
        summary = json.load(f)
    assert len(summary["per_image_psnr"]) == 2
    assert os.path.exists(os.path.join(result_dir, "pred_0001.png"))

    capsys.readouterr()
    assert train_main(["--cfg_file", LEGO, "--device", "cpu", "--test",
                       *opts]) == 0
    with open(os.path.join(result_dir, "summary.json")) as f:
        again = json.load(f)
    assert again["per_image_psnr"] == summary["per_image_psnr"]
    assert "not found" not in capsys.readouterr().out


def test_run_evaluate_matches_the_renderer(trained, monkeypatch):
    """run_evaluate's PSNR is the evaluator's on the gate's render; without
    a grid file it renders chunked (the JAX package's slow mode)."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.run import run_evaluate

    base, opts = trained
    monkeypatch.chdir(base)
    cfg = make_cfg(LEGO, opts)

    class Args:
        cfg_file = LEGO
        device = "cpu"

    with_grid = run_evaluate(cfg, Args)
    assert with_grid["used_grid"] and with_grid["n_images"] == 2
    assert np.isfinite(with_grid["psnr"]) and with_grid["march"] is None
    Args.cfg_file = "elsewhere.yaml"  # logs/elsewhere/: no grid
    chunked = run_evaluate(cfg, Args)
    assert not chunked["used_grid"]
    assert np.isfinite(chunked["psnr"])


# -- the serving engine's staged and grid-less routes ----------------------------

ENGINE = MARCH + ["serve.buckets", "[32]", "serve.max_batch_rays", "32",
                  "serve.warmup", "false"]


@pytest.mark.parametrize("route,extra,tiers", [
    ("packed", ["task_arg.march_coarse_block", "4"], ("full", "reduced_k")),
    ("per_ray", [], ("full", "coarse")),
    ("gridless", ["task_arg.accelerated_renderer", "false"],
     ("full", "coarse", "bf16")),
])
def test_engine_staged_and_gridless_routes(weights, route, extra, tiers):
    """``march_fused off`` (packed and per-ray) and the chunked volume
    route without a grid answer requests like the JAX engine."""
    from nerf_replication_tpu.serve import RenderEngine as JaxEngine
    from nerf_replication_tpu_torch.serve import RenderEngine

    jnet, params, pnet = weights
    jcfg, pcfg = both_cfgs(ENGINE + extra)
    grid = None if route == "gridless" else _grid()
    bbox = None if grid is None else BBOX
    jeng = JaxEngine(jcfg, jnet, params, near=NEAR, far=FAR, grid=grid,
                     bbox=bbox)
    peng = RenderEngine(pcfg, pnet, near=NEAR, far=FAR, grid=grid, bbox=bbox,
                        device="cpu")
    assert peng.use_grid == (grid is not None)
    assert peng.buckets == tuple(jeng.buckets)
    rays = sample_rays(40, seed=8)
    for tier in tiers:
        ref = jeng.render_request(rays, NEAR, FAR, tier=tier, emit=False)
        out = peng.render_request(rays, NEAR, FAR, tier=tier)
        assert set(out) == set(ref), tier
        # the chunked route: an importance sample that moves by a few ulps
        # can cross a density step of the random network (measured 8e-4 on
        # one ray's fine rgb), as in test_missing_grid_renders_chunked
        atol = 2e-2 if tier == "bf16" else (
            2e-3 if route == "gridless" else 1e-5)
        for k in out:
            if k == "tier":
                continue
            tol = atol * (10 if k.startswith("depth") else 1)
            np.testing.assert_allclose(out[k], np.asarray(ref[k]), rtol=0,
                                       atol=tol, err_msg=f"{tier} {k}")
    js, ps = jeng.stats(), peng.stats()
    assert (ps["march"] is None) == (js["march"] is None)
    if js["march"] is not None:
        for k in ("chunks", "candidates_per_chunk", "samples_out_per_chunk"):
            assert ps["march"][k] == js["march"][k], k
    assert ps["n_truncated"] == js["n_truncated"]
    img, info = peng.render_view(np.eye(4, dtype=np.float32)[:3] +
                                 np.array([[0, 0, 0, 0], [0, 0, 0, 0],
                                           [0, 0, 0, 4.0]], np.float32),
                                 4, 5, 6.0, tier=tiers[-1])
    assert img.shape == (4, 5, 3) and not info["cache_hit"]
