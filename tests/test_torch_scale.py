"""Port parity of ``scale/``'s options, the engine's mesh refusal, the
replica runtime over real port engines and the scale row kinds.

* ``ScaleOptions`` / ``parse_mesh_shape`` read the same ``scale:`` block
  and raise the same errors in the same words as the JAX package's.
* ``mesh_from_scale_cfg`` builds the mesh the JAX package's builds at the
  same device count, or raises its error in its words; ``engine_from_cfg``
  on the CPU serves on the one-device mesh it asks for (``force``), or on
  none (``off``, and ``auto`` on one device).
* Drain-before-retire and kill + failover run on ``InProcessReplica`` s
  over a tiny port CPU engine and micro-batcher, and over the JAX engine
  with the same weights: the same failures (zero for a drain), states,
  lifecycle rows and router counters.
"""

import dataclasses
import json

import numpy as np
import pytest

from _torch_ops_pair import (
    JAX_PKG,
    PORT_PKG,
    FakeClock,
    Side,
    isolated,
    run_both,
    strip,
)
from test_torch_helpers import (
    BBOX,
    FAR,
    LEGO,
    NEAR,
    SMALL_NET,
    box_grid,
    both_cfgs,
    nets,
    sample_rays,
)

STACK_OPTS = SMALL_NET + [
    "task_arg.render_step_size", "0.25",
    "task_arg.max_march_samples", "64",
    "task_arg.march_chunk_size", "64",
    "task_arg.march_coarse_block", "4",
    "task_arg.march_coarse_cap", "3",
    "task_arg.march_fused_block", "64",
    "task_arg.march_fused", "full",
    "serve.buckets", "[64]",
    "serve.max_batch_rays", "64",
    "serve.max_delay_ms", "40.0",
    "serve.request_timeout_s", "5.0",
    "compile.aot", "False",
]


def _err(fn, *args):
    """``fn(*args)``'s result, or its error as ``(class name, message)``."""
    try:
        return fn(*args)
    except Exception as exc:  # the parity is in the type and the words
        return (type(exc).__name__, str(exc))


def test_scale_options_match_jax():
    """``ScaleOptions.from_cfg`` over the same config and
    ``parse_mesh_shape`` over good and bad values, as in JAX."""
    from nerf_replication_tpu.scale import options as jopt
    from nerf_replication_tpu_torch.scale import options as popt

    opts = ["scale.max_replicas", "7", "scale.out_below", "0.8",
            "scale.mesh", "auto", "scale.placement.enabled", "True",
            "scale.placement.hot_width", "3"]
    jcfg, pcfg = both_cfgs(opts)
    got = dataclasses.asdict(popt.ScaleOptions.from_cfg(pcfg))
    assert got == dataclasses.asdict(jopt.ScaleOptions.from_cfg(jcfg))
    assert got["max_replicas"] == 7 and got["placement"]["hot_width"] == 3
    assert dataclasses.asdict(popt.ScaleOptions()) == dataclasses.asdict(
        jopt.ScaleOptions())
    for raw in (None, [2, 2], "2,2", "-1 4", (1, 1), [1], "a b", [0, 1],
                [1, 0], [-2, 1], {"d": 1}, 3):
        ours = _err(popt.parse_mesh_shape, raw)
        assert ours == _err(jopt.parse_mesh_shape, raw), raw


# -- scale.mesh: the mesh JAX builds, or its error --------------------------

# case -> (opts, what the JAX package does with 8 devices, what the port's
# engine_from_cfg does on the CPU's one device)
MESH_CASES = {
    "bad_mode": (["scale.mesh", "sideways"], "error", "error"),
    "malformed_shape": (["scale.mesh", "force", "scale.mesh_shape",
                         "[1, 2, 3]"], "error", "error"),
    "shape_not_dividing": (["scale.mesh", "force", "scale.mesh_shape",
                            "[1, 3]"], "error", "error"),
    "shape_too_big": (["scale.mesh", "force", "scale.mesh_shape",
                       "[16, 1]"], "error", "error"),
    "force": (["scale.mesh", "force"], "mesh", "mesh"),
    "shape_fits": (["scale.mesh", "force", "scale.mesh_shape", "[1, 1]"],
                   "mesh", "mesh"),
    "auto": (["scale.mesh", "auto"], "mesh", "none"),
    # quoted: a bare off is YAML's false
    "off": (["scale.mesh", "'off'", "scale.mesh_shape", "[1, 2]"], "none",
            "none"),
}


@pytest.fixture(scope="module")
def camera_root(tmp_path_factory):
    """Test-split camera metadata, all ``engine_from_cfg`` needs without a
    grid or a checkpoint (the chunked route on the seeded init)."""
    root = tmp_path_factory.mktemp("mesh_scene")
    (root / "lego").mkdir()
    (root / "lego" / "transforms_test.json").write_text(
        json.dumps({"camera_angle_x": 0.69, "frames": []}))
    return str(root)


def _axes(mesh):
    return None if mesh is None else dict(mesh.shape)


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_engine_from_cfg_builds_the_jax_mesh(case, camera_root, tmp_path,
                                             monkeypatch):
    """``mesh_from_scale_cfg`` over 8 devices builds JAX's layout or raises
    JAX's error in JAX's words; ``engine_from_cfg`` on the CPU (one
    device) serves on the mesh the same function builds there (``force``
    and a fitting shape: ``(1, 1)``; ``auto`` and ``off``: none), or
    raises its error, and a mesh engine serves the mesh-less maps."""
    from nerf_replication_tpu.scale.mesh_dispatch import (
        mesh_from_scale_cfg as jax_mesh_from_scale_cfg,
    )
    from nerf_replication_tpu_torch.scale import mesh_from_scale_cfg
    from nerf_replication_tpu_torch.serve import engine_from_cfg

    opts, jax_does, port_does = MESH_CASES[case]
    opts = opts + SMALL_NET + [
        "test_dataset.data_root", camera_root, "test_dataset.H", "8",
        "test_dataset.W", "8", "serve.buckets", "[64]", "serve.warmup",
        "False", "task_arg.N_samples", "8", "task_arg.N_importance", "8",
        "trained_model_dir", str(tmp_path / "none")]
    import jax
    import torch

    n_jax = len(jax.devices())
    assert n_jax == 8  # conftest's virtual CPU platform
    jcfg, pcfg = both_cfgs(opts)
    ref = _err(jax_mesh_from_scale_cfg, jcfg)
    ours = _err(lambda: mesh_from_scale_cfg(
        pcfg, [torch.device("cpu")] * n_jax))
    if jax_does == "error":
        assert isinstance(ref, tuple) and ours == ref
    else:
        assert not isinstance(ours, tuple) and _axes(ours) == _axes(ref)
        assert (ref is None) == (jax_does == "none")
    # the port's entry point on the CPU (one device)
    want = _err(lambda: mesh_from_scale_cfg(pcfg, [torch.device("cpu")]))
    monkeypatch.chdir(tmp_path)
    if port_does == "error":
        assert isinstance(want, tuple)
        with pytest.raises(Exception) as exc:
            engine_from_cfg(pcfg, cfg_file=LEGO, device="cpu")
        assert (type(exc.value).__name__, str(exc.value)) == want
        return
    engine = engine_from_cfg(pcfg, cfg_file=LEGO, device="cpu")
    assert engine.device.type == "cpu" and engine.param_shards == 1
    assert _axes(engine.mesh) == _axes(want)
    assert (engine.mesh is None) == (port_does == "none")
    if engine.mesh is not None:
        assert engine.stats()["mesh"]["axes"] == {"data": 1, "model": 1}
        _, plain_cfg = both_cfgs(opts[2:] if case == "force" else opts[4:])
        plain = engine_from_cfg(plain_cfg, cfg_file=LEGO, device="cpu")
        assert plain.mesh is None
        rays = sample_rays(40)
        a = plain.render_request(rays, NEAR, FAR, emit=False)
        b = engine.render_request(rays, NEAR, FAR, emit=False)
        for k in ("rgb_map_c", "rgb_map_f", "depth_map_f", "acc_map_f"):
            if k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_serving_mesh_is_led_by_the_engines_device(monkeypatch):
    """A mesh whose ``(0, 0)`` is not the engine's device is refused, never
    swapped in for it; ``engine_from_cfg``'s default layout starts at the
    card it was asked for (four cards faked on the CPU: nothing launches)."""
    import torch

    from nerf_replication_tpu_torch.scale.mesh_dispatch import (
        default_devices,
        make_serve_mesh,
        mesh_from_scale_cfg,
    )
    from nerf_replication_tpu_torch.serve import RenderEngine

    cuda0, cpu = torch.device("cuda", 0), torch.device("cpu")
    with pytest.raises(ValueError, match="lead device cuda:0 is not the "
                                         "engine's device cpu"):
        RenderEngine(None, None, NEAR, FAR, device="cpu",
                     mesh=make_serve_mesh(1, 1, [cuda0]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="lead device cuda:0 is not the "
                                         "engine's device cuda:1"):
        RenderEngine(None, None, NEAR, FAR, device="cuda:1",
                     mesh=make_serve_mesh(2, 1, [cuda0, cuda0]))
    with pytest.raises(ValueError, match="lead device cpu is not"):
        RenderEngine(None, None, NEAR, FAR, device="cuda:1",
                     mesh=make_serve_mesh(1, 1, [cpu]))
    assert [d.index for d in default_devices("cuda:1")] == [1, 2, 3, 0]
    assert [d.index for d in default_devices()] == [0, 1, 2, 3]
    _, pcfg = both_cfgs(["scale.mesh", "force", "scale.mesh_shape",
                         "[2, 1]"])
    mesh = mesh_from_scale_cfg(pcfg, default_devices(torch.device("cuda", 2)))
    assert [d.index for d in mesh.devices[:, 0]] == [2, 3]


# -- replicas over real engines ----------------------------------------------


@pytest.fixture(scope="module")
def stacks():
    """``side -> make_engine()``: the JAX and the port engine on the same
    weights, grid and options."""
    from nerf_replication_tpu.serve import RenderEngine as JaxEngine
    from nerf_replication_tpu_torch.serve import RenderEngine

    jnet, params, pnet = nets()
    jcfg, pcfg = both_cfgs(STACK_OPTS)
    grid = box_grid(16)
    return {
        JAX_PKG: lambda: JaxEngine(jcfg, jnet, params, near=NEAR, far=FAR,
                                   grid=grid, bbox=BBOX),
        PORT_PKG: lambda: RenderEngine(pcfg, pnet, near=NEAR, far=FAR,
                                       grid=grid, bbox=BBOX, device="cpu"),
    }


def _batcher(side, engine, clock):
    mod = __import__(f"{side.pkg}.serve", fromlist=["MicroBatcher"])
    return mod.MicroBatcher(engine, clock=clock, start=False)


def _lifecycle(side):
    # the engines' compile accounting differs by design (JAX: executables
    # compiled; the port: nvcc builds + captures after warm-up)
    return strip((r for r in side.rows if r["kind"] in ("replica",
                                                        "router")),
                 drop=("t", "total_compiles", "warm_source"))


def test_drain_before_retire_fails_zero_in_flight(stacks):
    def scenario(side):
        clock = FakeClock()
        engine = stacks[side.pkg]()
        replica = side.scale.InProcessReplica(
            "r0", engine, _batcher(side, engine, clock), clock=clock)
        futures = [replica.submit(sample_rays(32, seed=i), NEAR, FAR)
                   for i in range(4)]
        load = replica.load()
        clock.advance(1.0)
        failed = replica.drain(timeout_s=30.0)
        outs = [f.result(timeout=0.1) for f in futures]
        refused = _err(replica.submit, sample_rays(8), NEAR, FAR)
        return {"load": load, "failed": failed, "state": replica.state,
                "shapes": [o["rgb_map_f"].shape for o in outs],
                "rgb": [o["rgb_map_f"] for o in outs],
                "refused": refused, "rows": _lifecycle(side)}

    ref, out = run_both(scenario)
    for a, b in zip(out.pop("rgb"), ref.pop("rgb")):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
    assert out == ref
    assert out["failed"] == 0 and out["load"] == 4
    assert out["refused"][0] == "ReplicaUnavailableError"
    assert [r["event"] for r in out["rows"]] == ["ready", "drain", "retire"]


def test_killed_replica_fails_queued_and_router_fails_over(stacks):
    def scenario(side):
        clock = FakeClock()
        engine = stacks[side.pkg]()
        doomed = side.scale.InProcessReplica(
            "doomed", engine, _batcher(side, engine, clock), clock=clock)
        backup = side.scale.InProcessReplica(
            "backup", engine, _batcher(side, engine, clock), clock=clock)
        router = side.scale.Router(heartbeat_timeout_s=10.0, clock=clock)
        router.register(doomed)
        router.register(backup)
        sweep = router.sweep()
        fut = doomed.submit(sample_rays(16), NEAR, FAR)
        doomed.kill()
        lost = _err(fut.result, 0.1)
        fut2 = router.submit(sample_rays(16), NEAR, FAR)
        clock.advance(1.0)
        backup.batcher.pump()
        beat = backup.heartbeat()
        stats = router.stats()
        return {"sweep": sweep, "lost": lost,
                "shape": fut2.result(timeout=0.1)["rgb_map_f"].shape,
                "router": stats,
                "backup": {k: v for k, v in backup.stats().items()
                           if k not in ("warm_source", "warm_compiles",
                                        "total_compiles", "batcher")},
                "beat": {k: v for k, v in beat.items()
                         if k not in ("warm_source", "total_compiles")},
                "rows": _lifecycle(side)}

    ref, out = run_both(scenario)
    for rep in ref["router"]["replicas"].values():
        rep.pop("warm_source")
    for rep in out["router"]["replicas"].values():
        assert rep.pop("warm_source") == "compiled"
    assert out == ref
    assert out["lost"][0] == "ServeTimeoutError"
    assert out["router"]["n_failovers"] == 0
    assert out["backup"]["n_submitted"] == 1


def test_in_process_replica_reports_port_compiles(stacks):
    """The port's ``InProcessReplica`` reads ``RenderEngine.
    total_compiles`` (0 on the CPU: no kernel built, nothing captured)
    into its ready row, heartbeat and stats."""
    from nerf_replication_tpu_torch.serve import MicroBatcher

    side = Side(PORT_PKG)
    with isolated(side):
        engine = stacks[PORT_PKG]()
        replica = side.scale.InProcessReplica(
            "r0", engine, MicroBatcher(engine, start=False))
        beat = replica.heartbeat()
        stats = replica.stats()
        ready = [r for r in side.rows if r["kind"] == "replica"][0]
    assert engine.total_compiles() == 0
    assert beat["total_compiles"] == stats["total_compiles"] == 0
    assert (ready["event"], ready["total_compiles"],
            ready["warm_source"]) == ("ready", 0, "compiled")
    assert side.obs.validate_row(ready) == []


def test_scale_row_kinds_validate_as_in_jax():
    rows = [
        {"v": 1, "kind": "replica", "t": 0.0, "replica": "r0",
         "event": "spawn", "state": "ready", "warm_source": "disk",
         "total_compiles": 0, "scenes": ["lego"], "n_ready": 2},
        {"v": 1, "kind": "router", "t": 0.0, "event": "failover",
         "replica": "r0", "scene": "lego", "n_candidates": 1},
        {"v": 1, "kind": "router", "t": 0.0, "event": "drain",
         "replica": "r1", "load": 3, "n_failed": 0},
        {"v": 1, "kind": "scale_decision", "t": 0.0, "action": "out",
         "reason": "slo_miss", "n_replicas": 2, "attainment": 0.8,
         "deny_rate": 0.0, "streak": 2, "replica": "s1"},
        {"v": 1, "kind": "scale_decision", "t": 0.0, "action": "out"},
        {"v": 1, "kind": "placement_move", "t": 0.0, "version": 1,
         "move": "prefetch", "scene": "a", "replica": "r0", "ok": True},
        {"v": 1, "kind": "alert", "t": 0.0, "name": "slo_burn_page",
         "state": "firing", "severity": "page", "signal": "slo",
         "burn_fast": 20.0, "burn_slow": 20.0, "value": 0.2,
         "threshold": 14.4, "window_s": 60.0, "replica": "",
         "detail": ""},
    ]
    jax_side, port_side = Side(JAX_PKG), Side(PORT_PKG)
    verdicts = [port_side.obs.validate_row(r) for r in rows]
    assert verdicts == [jax_side.obs.validate_row(r) for r in rows]
    assert verdicts[4] != [] and all(v == [] for i, v in
                                     enumerate(verdicts) if i != 4)
