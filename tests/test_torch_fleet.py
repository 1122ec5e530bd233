"""Port parity of multi-scene serving (``fleet/``, the engine's fleet hooks,
the batcher's per-scene cuts and the HTTP edge), the counterparts of
``tests/test_fleet.py``, on the CPU.

* The registry: manifest round trip, the scan of the port's checkpoint
  layout (``latest.pt`` / ``<n>.pt``), an unknown scene.
* The residency manager: one scripted event sequence drives the JAX and
  the port ``ResidencyManager`` (LRU order, pins, the over-budget refusal,
  a loader error with no residue, a retried ``OSError``, a prefetch join);
  their outcomes, resident sets after every event, ``stats()`` and the
  ``scene_load`` / ``scene_evict`` rows (all fields but the load's wall
  seconds) are equal.
* A scene-switch stream over four scenes (perturbed weights and their own
  grids) and the default scene through the ``full`` route (K5's plain
  version), the staged packed route (K3a's) and the staged per-ray route
  (K1's) under ``network.nerf.fused_trunk``: each response bitwise that scene's
  dedicated port engine's, and within the serve tolerances (``atol 1e-5``,
  depth ``1e-4``, as ``test_torch_serve.py``) of the JAX engine on the same
  weights; no route build after warm-up.
* An incompatible scene is rejected at load; a torn scene fails its own
  requests (a ``fault`` row, ``n_scene_errors``, the breaker closed) while
  the others serve; the HTTP edge answers 404 / 429 / 503 and ``/healthz``
  carries the replica block; fleet rows validate against the port's
  schema; ``fleet_from_cfg`` serves a scene from a port checkpoint.
"""

import http.client
import json
import threading

import numpy as np
import pytest
import torch

from test_torch_helpers import BBOX, FAR, LEGO, NEAR, SMALL_NET, nets
from test_torch_helpers import sample_rays as _rays

from nerf_replication_tpu_torch import fleet as pf
from nerf_replication_tpu_torch.config import make_cfg
from nerf_replication_tpu_torch.scale.mesh_dispatch import gather_into
from nerf_replication_tpu_torch.serve import MicroBatcher, RenderEngine

SERVE = SMALL_NET + [
    "task_arg.render_step_size", "0.25",
    "task_arg.max_march_samples", "32",
    "task_arg.march_chunk_size", "64",
    "task_arg.march_coarse_block", "4",
    "task_arg.march_coarse_cap", "3",
    "task_arg.march_fused_block", "64",
    "serve.buckets", "[64]",
    "serve.max_batch_rays", "128",
    "serve.max_delay_ms", "40.0",
    "serve.shed_queue_depths", "[50, 60, 70, 80]",
    "network.nerf.fused_tile", "64",
]
ROUTES = {
    "full": ["task_arg.march_fused", "full"],
    "packed": ["task_arg.march_fused", "off",
               "network.nerf.fused_trunk", "true"],
    "per_ray": ["task_arg.march_fused", "off",
                "task_arg.march_coarse_block", "0",
                "network.nerf.fused_trunk", "true"],
}
SCENES = ("a", "b", "c", "d")


def _grid(i: int) -> np.ndarray:
    """Scene ``i``'s own occupancy (a box of its own extent)."""
    g = np.zeros((16, 16, 16), bool)
    g[3 + i % 2:13 - i // 2, 4:12, 2 + i:14] = True
    return g


@pytest.fixture(scope="module")
def weights():
    return nets()


def _scene_tensors(pnet, i: int):
    s = np.float32(1.0 + 0.01 * (i + 1))
    return {k: v.detach().clone() * torch.tensor(s)
            for k, v in pnet.state_dict().items()}


def _fleet(pnet, budget_scenes=2.5, **kw):
    datas = {sid: pf.SceneData(sid, params=_scene_tensors(pnet, i),
                               grid=torch.from_numpy(_grid(i)),
                               bbox=torch.from_numpy(BBOX), near=NEAR,
                               far=FAR)
             for i, sid in enumerate(SCENES)}
    one = sum(v.numel() * 4 for v in datas["a"].params.values()) \
        + 16 ** 3 + BBOX.nbytes
    mgr = pf.ResidencyManager(
        pf.SceneRegistry(pf.SceneRecord(s) for s in SCENES),
        lambda rec: datas[rec.scene_id], budget_bytes=int(one * budget_scenes),
        verify_checksums=False, **kw)
    return mgr, datas


def _engine(cfg, net, grid=None):
    return RenderEngine(cfg, net, NEAR, FAR,
                        grid=_grid(0) if grid is None else grid, bbox=BBOX,
                        device="cpu", warmup_families=("full",))


# -- registry -----------------------------------------------------------------


def test_manifest_round_trip_and_relative_paths(tmp_path):
    reg = pf.SceneRegistry([
        pf.SceneRecord("lego", checkpoint="/ckpts/lego", grid="/g/lego.npz",
                       near=2.0, far=6.0,
                       bbox=((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5)), epoch=3,
                       meta={"note": "unit"}),
        pf.SceneRecord("ship", checkpoint="/ckpts/ship")])
    path = str(tmp_path / "manifest.json")
    reg.to_manifest(path)
    back = pf.SceneRegistry.from_manifest(path)
    assert back.ids() == ["lego", "ship"]
    assert back.get("lego") == reg.get("lego")
    with open(path, "w") as fh:
        json.dump({"version": 1, "scenes": [
            {"scene_id": "x", "checkpoint": "x/ckpt"}]}, fh)
    assert pf.SceneRegistry.from_manifest(path).get("x").checkpoint == str(
        tmp_path / "x" / "ckpt")
    with open(path, "w") as fh:
        json.dump({"version": 99, "scenes": []}, fh)
    with pytest.raises(ValueError, match="version"):
        pf.SceneRegistry.from_manifest(path)


def test_scan_finds_the_port_checkpoint_layout(tmp_path):
    """``latest.pt`` or ``<n>.pt`` make a scene (JAX's rule, Orbax
    directories, finds none of them); a grid beside it is picked up."""
    from nerf_replication_tpu.fleet import SceneRegistry as JaxRegistry

    root = tmp_path / "scenes"
    for name, f in (("alpha", "latest.pt"), ("beta", "3.pt")):
        (root / name).mkdir(parents=True)
        (root / name / f).write_bytes(b"x")
    (root / "beta" / "occupancy_grid.npz").write_bytes(b"x")
    (root / "noise").mkdir()
    reg = pf.SceneRegistry.scan(str(root))
    assert reg.ids() == ["alpha", "beta"]
    assert reg.get("alpha").grid == ""
    assert reg.get("beta").grid == str(root / "beta" / "occupancy_grid.npz")
    assert JaxRegistry.scan(str(root)).ids() == []


def test_unknown_scene_names_the_known_set():
    with pytest.raises(pf.UnknownSceneError, match="lego") as exc:
        pf.SceneRegistry([pf.SceneRecord("lego")]).get("shpi")
    assert exc.value.scene_id == "shpi"


# -- residency: one script, both managers -------------------------------------

SCRIPTS = {
    "lru": (2.0, [("lease", "a"), ("lease", "b"), ("lease", "a"),
                  ("lease", "c"), ("lease", "b")]),
    "pins": (2.0, [("acquire", "a"), ("acquire", "b"), ("acquire", "c"),
                   ("release", "a"), ("release", "b"), ("lease", "c"),
                   ("lease", "a")]),
    "over_budget": (0.5, [("acquire", "a"), ("lease", "a")]),
    "loader_error": (2.0, [("acquire", "x"), ("acquire", "x"),
                           ("lease", "a")]),
    "retry": (2.0, [("lease", "r"), ("lease", "a")]),
    "prefetch": (2.0, [("prefetch", "a"), ("wait", "a"), ("prefetch", "a"),
                       ("prefetch", "ghost"), ("lease", "a"),
                       ("lease", "b"), ("lease", "c"), ("prefetch", "a"),
                       ("wait", "a"), ("lease", "a")]),
}


def _run_script(mod, errors, as_array, name, monkeypatch):
    """The script through one package's manager: (per-event outcome and
    resident set, stats, rows)."""
    import importlib

    residency = importlib.import_module(mod + ".residency")
    budget, events = SCRIPTS[name]
    rows = []

    class Rec:
        def emit(self, kind, **fields):
            fields.pop("load_s", None)
            rows.append((kind, fields))

    monkeypatch.setattr(residency, "get_emitter", lambda: Rec())
    calls = {"r": 0}

    def loader(rec):
        if rec.scene_id == "x":
            raise errors.SceneLoadError("x", "artifact store down")
        if rec.scene_id == "r":
            calls["r"] += 1
            if calls["r"] == 1:
                raise OSError("transient hiccup")
        i = "abcrx".index(rec.scene_id)
        return residency.SceneData(rec.scene_id,
                                   params={"w": as_array(i)})

    reg_mod = importlib.import_module(mod + ".registry")
    reg = reg_mod.SceneRegistry(reg_mod.SceneRecord(s) for s in "abcrx")
    mgr = residency.ResidencyManager(
        reg, loader, budget_bytes=int(4000 * budget), verify_checksums=False,
        retry_kw={"attempts": 3, "base_s": 0.0, "max_s": 0.0})
    trail = []
    for op, sid in events:
        try:
            if op == "lease":
                with mgr.lease(sid):
                    pass
                out = "ok"
            elif op == "acquire":
                out = mgr.acquire(sid).scene_id
            elif op == "release":
                out = mgr.release(sid)
            elif op == "prefetch":
                out = mgr.prefetch(sid)
            else:
                out = mgr.wait_loaded(sid, timeout=30.0)
        except Exception as err:
            out = type(err).__name__
        # a prefetch's load runs on its own thread: the sets are read at
        # the next wait
        trail.append((op, sid, out) if op == "prefetch" else
                     (op, sid, out, mgr.resident_ids(), mgr.pinned_ids()))
    stats = mgr.stats()
    stats.pop("pose_caches")
    return trail, stats, rows


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_residency_decisions_and_rows_match_jax(script, monkeypatch):
    import nerf_replication_tpu.fleet.errors as jerr

    jax_side = _run_script("nerf_replication_tpu.fleet", jerr,
                           lambda i: np.full((1000,), i, np.float32),
                           script, monkeypatch)
    port_side = _run_script("nerf_replication_tpu_torch.fleet", pf,
                            lambda i: torch.full((1000,), float(i)),
                            script, monkeypatch)
    assert port_side[0] == jax_side[0]
    assert port_side[1] == jax_side[1]
    assert port_side[2] == jax_side[2]
    assert jax_side[2] or script == "over_budget"


# -- the engine: a scene-switch stream ----------------------------------------


@pytest.mark.parametrize("route", list(ROUTES))
def test_scene_switch_stream_matches_dedicated_engines(weights, route):
    """Scenes a-d and the default through one engine, switching on every
    request under a budget that evicts: each response is bitwise its
    scene's dedicated engine's; the JAX engine on scene b's weights and
    grid agrees within the serve tolerances; no route is built after
    warm-up, and the default scene restores the engine's own weights."""
    from nerf_replication_tpu.config import make_cfg as jax_make_cfg
    from nerf_replication_tpu.serve import RenderEngine as JaxEngine

    jnet, params, pnet = weights
    opts = SERVE + ROUTES[route]
    cfg = make_cfg(LEGO, opts)
    engine = _engine(cfg, pnet)
    mgr, datas = _fleet(pnet)
    engine.attach_fleet(mgr)
    builds = engine.stats()["route_builds"]
    rays = {sid: _rays(40 + 7 * i, seed=i)
            for i, sid in enumerate(SCENES + ("default",))}
    stream = ["a", "b", "default", "c", "a", "d", "b", "default", "c"]
    outs = {sid: engine.render_request(rays[sid], NEAR, FAR, scene=sid)
            for sid in stream}
    assert engine.stats()["route_builds"] == builds
    assert mgr.stats()["evictions"] >= 2
    assert engine.slot_switches == len(stream)
    from nerf_replication_tpu_torch.models import make_network

    for i, sid in enumerate(SCENES + ("default",)):
        net = make_network(cfg)
        if sid == "default":
            net.load_state_dict(pnet.state_dict())
            grid = _grid(0)
        else:
            net.load_state_dict(datas[sid].params)
            grid = _grid(i)
        ref = _engine(cfg, net, grid).render_request(rays[sid], NEAR, FAR)
        for k in ("rgb_map_f", "acc_map_f", "depth_map_f"):
            np.testing.assert_array_equal(outs[sid][k], ref[k],
                                          err_msg=f"{sid} {k}")
    s = np.float32(1.02)
    jparams = {"params": __import__("jax").tree.map(
        lambda a: np.asarray(a) * s, params["params"])}
    jeng = JaxEngine(jax_make_cfg(LEGO, opts), jnet, jparams, near=NEAR,
                     far=FAR, grid=_grid(1), bbox=BBOX,
                     warmup_families=("full",))
    jref = jeng.render_request(rays["b"], NEAR, FAR, emit=False)
    for k, tol in (("rgb_map_f", 1e-5), ("acc_map_f", 1e-5),
                   ("depth_map_f", 1e-4)):
        np.testing.assert_allclose(outs["b"][k], np.asarray(jref[k]),
                                   rtol=0, atol=tol, err_msg=k)


def test_incompatible_scene_rejected_at_load(weights):
    _, _, pnet = weights
    engine = _engine(make_cfg(LEGO, SERVE + ROUTES["full"]), pnet)
    good = _scene_tensors(pnet, 0)
    bad = {
        "bounds": pf.SceneData("bounds", good, torch.from_numpy(_grid(0)),
                               torch.from_numpy(BBOX), NEAR, FAR + 1.0),
        "no_grid": pf.SceneData("no_grid", good, None,
                                torch.from_numpy(BBOX), NEAR, FAR),
        "grid": pf.SceneData("grid", good, torch.zeros((8, 8, 8), dtype=bool),
                             torch.from_numpy(BBOX), NEAR, FAR),
        "names": pf.SceneData("names", {"w": torch.zeros(3)},
                              torch.from_numpy(_grid(0)),
                              torch.from_numpy(BBOX), NEAR, FAR),
        "shape": pf.SceneData("shape", {**good, "fine.rgb_linear.bias":
                                        torch.zeros(4)},
                              torch.from_numpy(_grid(0)),
                              torch.from_numpy(BBOX), NEAR, FAR),
    }
    mgr = pf.ResidencyManager(pf.SceneRegistry(pf.SceneRecord(s) for s in bad),
                              lambda rec: bad[rec.scene_id],
                              budget_bytes=1 << 30, verify_checksums=False)
    engine.attach_fleet(mgr)
    for sid in bad:
        with pytest.raises(pf.SceneCompatError):
            mgr.acquire(sid)
    assert mgr.resident_ids() == []


def _torn_dir(tmp_path) -> str:
    from nerf_replication_tpu_torch.resil import write_tree_checksum

    ckpt = tmp_path / "torn_scene"
    ckpt.mkdir()
    blob = ckpt / "latest.pt"
    blob.write_bytes(b"weights" * 128)
    write_tree_checksum(str(ckpt))
    blob.write_bytes(b"weights" * 64)  # torn after the checksum landed
    return str(ckpt)


def test_torn_scene_is_scoped_with_its_fault_row(weights, tmp_path):
    """The torn scene's batch fails alone (a ``fault`` row, the breaker
    closed); the good scene's batch renders; an unknown scene raises at
    submit."""
    from nerf_replication_tpu_torch.obs import init_run

    _, _, pnet = weights
    cfg = make_cfg(LEGO, SERVE + ROUTES["full"])
    engine = _engine(cfg, pnet)
    good = pf.SceneData("good", _scene_tensors(pnet, 1),
                        torch.from_numpy(_grid(0)), torch.from_numpy(BBOX),
                        NEAR, FAR)
    mgr = pf.ResidencyManager(
        pf.SceneRegistry([pf.SceneRecord("good"), pf.SceneRecord(
            "torn", checkpoint=_torn_dir(tmp_path))]),
        lambda rec: good, budget_bytes=1 << 30, prefetch=False)
    engine.attach_fleet(mgr)
    path = str(tmp_path / "telemetry.jsonl")
    emitter = init_run(cfg, component="fleet_test", path=path)
    try:
        batcher = MicroBatcher(engine, start=False)
        f_bad = batcher.submit(_rays(32), NEAR, FAR, scene="torn")
        f_good = batcher.submit(_rays(32), NEAR, FAR, scene="good")
        while batcher.queue_depth():
            batcher.pump()
        with pytest.raises(pf.SceneLoadError, match="torn"):
            f_bad.result(timeout=5.0)
        assert f_good.result(timeout=5.0)["rgb_map_f"].shape == (32, 3)
        assert batcher.stats()["n_scene_errors"] == 1
        assert batcher.breaker.snapshot()["state"] == "closed"
        with pytest.raises(pf.UnknownSceneError):
            batcher.submit(_rays(8), NEAR, FAR, scene="nope")
    finally:
        emitter.close()
    rows = [json.loads(line) for line in open(path)]
    assert any(r["kind"] == "fault" and r["point"] == "fleet.load"
               and r["fault"] == "torn" for r in rows)


def test_http_404_429_503_and_the_healthz_replica_block(weights, tmp_path):
    from nerf_replication_tpu_torch.serve.__main__ import make_server

    _, _, pnet = weights
    cfg = make_cfg(LEGO, SERVE + ROUTES["full"] + [
        "fleet.qos.enabled", "true", "fleet.qos.default_burst", "2",
        "fleet.qos.default_rate", "0.001"])
    engine = _engine(cfg, pnet)
    mgr, _ = _fleet(pnet)
    mgr.registry.register(pf.SceneRecord("torn",
                                         checkpoint=_torn_dir(tmp_path)))
    mgr.verify_checksums = True
    engine.attach_fleet(mgr)
    engine.default_camera = {"H": 8, "W": 8, "focal": 10.0}
    batcher = MicroBatcher(engine, qos=pf.QosController.from_cfg(cfg))
    server = make_server(engine, batcher, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          server.server_address[1],
                                          timeout=60)

        def call(method, path, body=None):
            conn.request(method, path, None if body is None
                         else json.dumps(body))
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read()), resp.headers

        status, out, _ = call("POST", "/render", {"theta": 30.0,
                                                  "scene": "a",
                                                  "tenant": "t1"})
        assert status == 200 and out["scene"] == "a"
        assert call("POST", "/render", {"theta": 30.0,
                                        "scene": "nope"})[0] == 404
        status, out, _ = call("POST", "/render", {"theta": 31.0,
                                                  "scene": "torn"})
        assert status == 503 and out["scene"] == "torn"
        status, out, headers = call("POST", "/render", {
            "theta": 32.0, "scene": "b", "tenant": "t1"})
        status, out, headers = call("POST", "/render", {
            "theta": 33.0, "scene": "b", "tenant": "t1"})
        assert status == 429 and out["tenant"] == "t1"
        assert int(headers["Retry-After"]) >= 1
        status, health, _ = call("GET", "/healthz")
        rep = health["replica"]
        assert rep["scenes"] == mgr.resident_ids() and "a" in rep["scenes"]
        assert rep["hbm_budget_bytes"] == mgr.budget_bytes
        assert rep["param_shards"] == 1
        status, stats, _ = call("GET", "/stats")
        assert stats["fleet"]["load_errors"] >= 1
        assert stats["batcher"]["n_quota_denied"] == 1
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()


def test_fleet_rows_validate_against_the_port_schema(weights, tmp_path):
    from nerf_replication_tpu_torch.obs import init_run
    from nerf_replication_tpu_torch.obs.schema import validate_row

    _, _, pnet = weights
    cfg = make_cfg(LEGO, SERVE + ROUTES["full"])
    engine = _engine(cfg, pnet)
    mgr, _ = _fleet(pnet, budget_scenes=1.5)
    engine.attach_fleet(mgr)
    path = str(tmp_path / "telemetry.jsonl")
    emitter = init_run(cfg, component="fleet_test", path=path)
    try:
        mgr.prefetch("a")
        mgr.wait_loaded("a", timeout=30.0)
        batcher = MicroBatcher(engine, start=False)
        futures = [batcher.submit(_rays(32), NEAR, FAR, scene=s,
                                  tenant="t") for s in ("a", "b")]
        while batcher.queue_depth():
            batcher.pump()
        for f in futures:
            f.result(timeout=5.0)
    finally:
        emitter.close()
    rows = [json.loads(line) for line in open(path)]
    for r in rows:
        assert validate_row(r) == [], r
    loads = [r for r in rows if r["kind"] == "scene_load"]
    assert {r["source"] for r in loads} == {"prefetch", "cold"}
    evicts = [r for r in rows if r["kind"] == "scene_evict"]
    assert evicts and evicts[0]["scene"] == "a"
    assert {r["scene"] for r in rows if r["kind"] == "serve_request"} == {
        "a", "b"}
    assert any(r["kind"] == "serve_batch" and r.get("tenant") == "t"
               for r in rows)


def test_checkpoint_loader_and_fleet_from_cfg(weights, tmp_path):
    """A port checkpoint and baked grid named by a manifest: the loaded
    scene's tensors are the checkpoint's, and it renders through the
    engine bitwise what an engine on those weights renders."""
    from nerf_replication_tpu_torch.renderer.occupancy import (
        save_occupancy_grid,
    )
    from nerf_replication_tpu_torch.resil import write_tree_checksum
    from nerf_replication_tpu_torch.train.checkpoint import save_network

    _, _, pnet = weights
    cfg = make_cfg(LEGO, SERVE + ROUTES["full"])
    engine = _engine(cfg, pnet)
    from nerf_replication_tpu_torch.models import make_network

    net = make_network(cfg)
    net.load_state_dict(_scene_tensors(pnet, 2))
    ckpt = str(tmp_path / "lego")
    save_network(ckpt, net)
    write_tree_checksum(ckpt)
    grid_path = str(tmp_path / "lego_grid.npz")
    save_occupancy_grid(grid_path, _grid(2), BBOX, 0.5)
    manifest = str(tmp_path / "manifest.json")
    pf.SceneRegistry([pf.SceneRecord("lego", checkpoint=ckpt,
                                     grid=grid_path)]).to_manifest(manifest)
    cfg2 = make_cfg(LEGO, SERVE + ROUTES["full"] + [
        "fleet.manifest", manifest, "fleet.hbm_budget_mb", "64.0"])
    mgr = pf.fleet_from_cfg(cfg2, engine)
    assert engine.fleet is mgr and mgr.registry.ids() == ["lego"]
    with engine.scene_lease("lego") as data:
        # placed on the engine's one-device layout: gathered back whole
        slots = {k: torch.empty_like(v) for k, v in net.state_dict().items()}
        gather_into(slots, data.params, 0)
        for k, v in net.state_dict().items():
            assert torch.equal(slots[k], v), k
        assert len(data.grid) == 1 and data.grid[0].dtype == torch.bool
    out = engine.render_request(_rays(30), NEAR, FAR, scene="lego")
    ref = _engine(cfg, net, _grid(2)).render_request(_rays(30), NEAR, FAR)
    np.testing.assert_array_equal(out["rgb_map_f"], ref["rgb_map_f"])
    assert pf.fleet_from_cfg(cfg, engine) is None
    with pytest.raises(pf.SceneLoadError, match="no checkpoint"):
        pf.checkpoint_loader(net.state_dict(), default_near=NEAR,
                             default_far=FAR)(pf.SceneRecord(
                                 "ghost", checkpoint=str(tmp_path / "nope")))
