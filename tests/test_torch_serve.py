"""Port parity of serving: the port's RenderEngine against the JAX
RenderEngine on the same weights, grid and rays for every tier and both
fused routes; padded buckets; the micro-batcher; the HTTP entry point; the
checkpoint round trip; and the device / route guards.

Tolerances: f32 tiers ``atol 1e-5`` (depth 1e-4), as for K5. The bf16 tier
of the ``full`` route follows the fused tile's rounding points (2e-3, see
test_torch_fused_march); the bf16 tier of the ``gather`` route runs the
plain network with bf16 activations in both frameworks (2e-2, see
test_torch_network)."""

import base64
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

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
    box_grid,
    both_cfgs,
    nets,
    sample_rays,
)

from nerf_replication_tpu_torch.renderer.gate import BakedBoundsError
from nerf_replication_tpu_torch.serve import (
    MicroBatcher,
    RenderEngine,
    engine_from_cfg,
)
from nerf_replication_tpu_torch.train.checkpoint import (
    load_network,
    save_network,
)

SERVE_OPTS = SMALL_NET + [
    "task_arg.render_step_size", "0.25",
    "task_arg.max_march_samples", "64",
    "task_arg.march_chunk_size", "64",
    "task_arg.march_coarse_block", "4",
    "task_arg.march_coarse_cap", "3",
    "task_arg.march_fused_block", "64",
    "serve.buckets", "[64]",
    "serve.max_batch_rays", "64",
]
TIERS = ("full", "bf16", "reduced_k", "coarse", "half_res")


def _tol(route, tier):
    if tier != "bf16":
        return 1e-5, 1e-4
    return (2e-3, 1e-2) if route == "full" else (2e-2, 1e-1)


@pytest.fixture(scope="module")
def weights():
    return nets()


def _engines(weights, route):
    from nerf_replication_tpu.serve import RenderEngine as JaxEngine

    jnet, params, pnet = weights
    jcfg, pcfg = both_cfgs(SERVE_OPTS + ["task_arg.march_fused", route])
    grid = box_grid(16)
    jeng = JaxEngine(jcfg, jnet, params, near=NEAR, far=FAR, grid=grid,
                     bbox=BBOX)
    peng = RenderEngine(pcfg, pnet, near=NEAR, far=FAR, grid=grid,
                        bbox=BBOX, device="cpu")
    return jeng, peng


@pytest.mark.parametrize("route", ["full", "gather"])
def test_engine_matches_jax_engine_per_tier(weights, route):
    """Every tier (full, bf16, reduced_k, coarse, half_res) of the port's
    engine vs the JAX engine; then the same traversal stats."""
    jeng, peng = _engines(weights, route)
    assert peng.buckets == tuple(jeng.buckets) == (64,)
    rays = sample_rays(50, seed=11)
    for tier in TIERS:
        ref = jeng.render_request(rays, NEAR, FAR, tier=tier, emit=False)
        out = peng.render_request(rays, NEAR, FAR, tier=tier)
        assert out["tier"] == tier
        atol, datol = _tol(route, tier)
        for k, tol in (("rgb_map_f", atol), ("acc_map_f", atol),
                       ("depth_map_f", datol)):
            assert out[k].shape == np.asarray(ref[k]).shape, (tier, k)
            np.testing.assert_allclose(out[k], np.asarray(ref[k]), rtol=0,
                                       atol=tol, err_msg=f"{tier} {k}")
    js, ps = jeng.stats(), peng.stats()
    assert ps["march"]["chunks"] == js["march"]["chunks"]
    for k in ("candidates_per_chunk", "samples_out_per_chunk"):
        assert ps["march"][k] == js["march"][k], k
    for k in ("coarse_occ_mean", "overflow_mean", "sweep_efficiency"):
        assert ps["march"][k] == pytest.approx(js["march"][k], rel=1e-6), k
    assert ps["n_truncated"] == js["n_truncated"]
    assert ps["n_pad_rays"] == js["n_pad_rays"]
    assert ps["route"] == route


def test_padded_bucket_render_is_bitwise_unpadded(weights):
    """A request padded into its bucket renders bitwise like the same rays
    through the fused march with no padding (pad rays are inert)."""
    from nerf_replication_tpu_torch.ops.fused_march import (
        FusedWeights,
        march_rays_fused_full,
    )
    from nerf_replication_tpu_torch.ops.fused_mlp import fused_spec_for

    _, _, pnet = weights
    _, pcfg = both_cfgs(SERVE_OPTS + ["task_arg.march_fused", "full"])
    peng = RenderEngine(pcfg, pnet, near=NEAR, far=FAR, grid=box_grid(16),
                        bbox=BBOX, device="cpu")
    rays = sample_rays(37, seed=5)
    out = peng.render_request(rays, NEAR, FAR)
    w = FusedWeights(fused_spec_for(pnet), pnet.fine)
    with torch.no_grad():
        ref = march_rays_fused_full(
            w, pnet.xyz_encoder, pnet.dir_encoder, torch.from_numpy(rays),
            NEAR, FAR, torch.from_numpy(box_grid(16)),
            torch.from_numpy(BBOX), peng.march_options, k_tile=8)
    for k in ("rgb_map_f", "depth_map_f", "acc_map_f"):
        np.testing.assert_array_equal(out[k], ref[k].numpy(), err_msg=k)
    assert peng.stats()["n_pad_rays"] == 64 - 37


def test_render_view_and_cache(weights):
    _, _, pnet = weights
    _, pcfg = both_cfgs(SERVE_OPTS + ["task_arg.march_fused", "full"])
    peng = RenderEngine(pcfg, pnet, near=NEAR, far=FAR, grid=box_grid(16),
                        bbox=BBOX, device="cpu")
    from nerf_replication_tpu_torch.datasets.rays import pose_spherical

    c2w = pose_spherical(30.0, -30.0, 4.0)
    img, info = peng.render_view(c2w, 8, 10, 12.0)
    assert img.shape == (8, 10, 3) and img.dtype == np.uint8
    assert info == {"tier": "full", "cache_hit": False}
    img2, info2 = peng.render_view(c2w, 8, 10, 12.0)
    assert info2["cache_hit"] and np.array_equal(img, img2)
    with pytest.raises(BakedBoundsError):
        peng.render_request(sample_rays(4), NEAR, FAR + 1.0)


def test_batcher_coalesces_concurrent_submits(weights):
    """Deterministic drive: three queued requests cut into ONE batch and
    each gets exactly its own slice; then a threaded stress with more
    clients than cores completes every request."""
    _, _, pnet = weights
    _, pcfg = both_cfgs(SERVE_OPTS + ["task_arg.march_fused", "full",
                                      "serve.max_delay_ms", "50"])
    peng = RenderEngine(pcfg, pnet, near=NEAR, far=FAR, grid=box_grid(16),
                        bbox=BBOX, device="cpu")
    now = [0.0]
    b = MicroBatcher(peng, clock=lambda: now[0], start=False)
    reqs = [sample_rays(n, seed=n) for n in (10, 20, 30)]
    futs = [b.submit(r, NEAR, FAR) for r in reqs]
    now[0] = 1.0  # past max_delay: the delay edge fires
    assert b.pump() == 3
    assert b.n_batches == 1
    for r, f in zip(reqs, futs):
        got = f.result(timeout=1.0)
        ref = peng.render_request(r, NEAR, FAR)
        assert got["tier"] == "full"
        np.testing.assert_allclose(got["rgb_map_f"], ref["rgb_map_f"],
                                   rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        b.submit(np.zeros((0, 6), np.float32), NEAR, FAR)

    live = MicroBatcher(peng)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        results, errors = [None] * 12, []

        def client(k):
            try:
                results[k] = live.submit(sample_rays(16, seed=k), NEAR,
                                         FAR).result(60.0)
            except Exception as err:  # recorded and asserted below
                errors.append(err)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        live.close()
    assert not errors
    assert all(r is not None and r["rgb_map_f"].shape == (16, 3)
               for r in results)
    assert live.n_completed == 12
    assert live.n_batches < 12  # concurrent submits coalesced


def _scene(tmp_path, pnet):
    """Camera metadata, a port checkpoint and the grid, laid out the way
    engine_from_cfg reads them (grid path relative to the cwd)."""
    data = tmp_path / "data" / "lego"
    data.mkdir(parents=True)
    (data / "transforms_test.json").write_text(
        json.dumps({"camera_angle_x": 0.6911112070083618, "frames": []}))
    from nerf_replication_tpu_torch.renderer.occupancy import (
        save_occupancy_grid,
    )

    save_occupancy_grid(str(tmp_path / "logs" / "lego" / "occupancy_grid.npz"),
                        box_grid(16), BBOX, 1.0)
    opts = SERVE_OPTS + [
        "task_arg.march_fused", "full",
        "test_dataset.data_root", str(tmp_path / "data"),
        "test_dataset.H", "8", "test_dataset.W", "8",
        "trained_model_dir", str(tmp_path / "model"),
    ]
    return opts


def test_engine_from_cfg_on_cpu(weights, tmp_path, monkeypatch):
    """Boot from config: grid from logs/<cfg>/, weights from the port
    checkpoint (else the seeded init), camera from transforms_test.json."""
    from nerf_replication_tpu.datasets.rays import focal_from_fov as jfocal
    from nerf_replication_tpu_torch.config import make_cfg

    _, _, pnet = weights
    opts = _scene(tmp_path, pnet)
    cfg = make_cfg(LEGO, opts)
    save_network(cfg.trained_model_dir, pnet)
    monkeypatch.chdir(tmp_path)
    eng = engine_from_cfg(cfg, cfg_file=LEGO, device="cpu")
    assert eng.default_camera == {"H": 8, "W": 8,
                                  "focal": jfocal(8, 0.6911112070083618)}
    for k, v in pnet.state_dict().items():
        assert torch.equal(eng.network.state_dict()[k], v), k
    out = eng.render_request(sample_rays(20), NEAR, FAR)
    assert np.isfinite(out["rgb_map_f"]).all()


def test_checkpoint_roundtrip_and_epochs(weights, tmp_path):
    from nerf_replication_tpu_torch.models import make_network

    _, _, pnet = weights
    _, pcfg = both_cfgs(SMALL_NET)
    d = str(tmp_path / "ck")
    fresh = make_network(pcfg)
    assert load_network(d, fresh) == -1  # no checkpoint: untouched
    save_network(d, pnet, epoch=3)
    save_network(d, pnet, epoch=7)
    assert load_network(d, fresh) == 7
    assert load_network(d, fresh, epoch=3) == 3
    assert load_network(d, fresh, epoch=5) == -1
    save_network(d, pnet)
    assert load_network(d, fresh) == -1  # latest.pt wins
    for k, v in pnet.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v)


def test_guards_refuse_silent_fallbacks(weights, tmp_path, monkeypatch,
                                       capsys):
    """No CUDA → a cuda engine raises; an unported route (the learned
    sampler) raises, naming its slice; a missing grid file serves through
    the chunked volume route only after saying so, as the JAX engine does
    — never silently."""
    from nerf_replication_tpu_torch.config import make_cfg

    _, _, pnet = weights
    opts = _scene(tmp_path, pnet)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = make_cfg(LEGO, opts)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine_from_cfg(cfg, cfg_file=LEGO, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        engine_from_cfg(cfg, cfg_file=LEGO)  # the default device is cuda
    _, pcfg = both_cfgs(SERVE_OPTS + ["sampling.mode", "proposal"])
    with pytest.raises(NotImplementedError, match="slice 5"):
        RenderEngine(pcfg, pnet, NEAR, FAR, grid=box_grid(16), bbox=BBOX,
                     device="cpu")
    eng = engine_from_cfg(make_cfg(LEGO, opts), cfg_file="other.yaml",
                          device="cpu")
    assert "occupancy grid not found" in capsys.readouterr().out
    assert not eng.use_grid and eng.chunk == eng.eval_options.chunk_size


def test_http_entry_answers_render(weights, tmp_path):
    """``python -m nerf_replication_tpu_torch.serve --device cpu --port 0``
    answers POST /render, GET /stats and GET /healthz."""
    _, _, pnet = weights
    opts = _scene(tmp_path, pnet)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "nerf_replication_tpu_torch.serve",
         "--cfg_file", LEGO, "--device", "cpu", "--port", "0", *opts],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        port = None
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            if line.startswith("serving on"):
                port = int(line.split()[2].rsplit(":", 1)[1])
                break
        assert port, "server did not come up"
        base = f"http://127.0.0.1:{port}"
        req = urllib.request.Request(
            base + "/render", data=json.dumps(
                {"theta": 30, "phi": -30, "radius": 4}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        assert (body["h"], body["w"], body["tier"]) == (8, 8, "full")
        img = np.frombuffer(base64.b64decode(body["rgb_b64"]), np.uint8)
        assert img.size == 8 * 8 * 3
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["n_requests"] == 1 and stats["march"]["chunks"] >= 1
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["ok"] is True
        bad = urllib.request.Request(base + "/render", data=b"{}",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=30)
        assert e.value.code == 400
    finally:
        proc.terminate()
        proc.wait(timeout=30)
