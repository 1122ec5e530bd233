"""Port parity of the scene placement planner (``scale/placement.py``),
the router's plan consult and capability filter, the supervisor's plan
lifecycle, and — marked ``slow`` — the launcher on two real port serve
children.

Each scenario of the JAX package's ``tests/test_placement.py`` runs on
the JAX classes and on the port's with the same catalog, residency,
heat and fake clock (``_torch_ops_pair``): plans (assignments, versions,
ordered moves), executor results, router candidate orders and counters,
and every ``placement_plan`` / ``placement_move`` row must be ``==``.
"""

import os

import pytest

from _torch_ops_pair import FakeClock, run_both, strip

_REPO = os.path.join(os.path.dirname(__file__), "..")


class FakeCatalog:
    """The SceneStore surface the planner reads (ids + record get)."""

    def __init__(self, *ids):
        self._ids = list(ids)

    def ids(self):
        return list(self._ids)

    def get(self, sid):
        return {"scene_id": sid}


def _state(scenes=(), staging=(), hbm_budget=0, staging_budget=0,
           hbm_bytes=0, staging_bytes=0):
    return {"scenes": list(scenes), "staging": list(staging),
            "hbm_bytes": hbm_bytes, "staging_bytes": staging_bytes,
            "hbm_budget_bytes": hbm_budget,
            "staging_budget_bytes": staging_budget}


def _heat(**rps):
    return {s: {"requests_per_s": float(r), "rays_per_s": 0.0}
            for s, r in rps.items()}


def _planner(side, catalog, scene_bytes_fn=None, clock=None, **opts):
    merged = dict(enabled=True, hot_width=2, max_width=4,
                  hot_rps=1.0, width_rps=2.0)
    merged.update(opts)
    return side.scale.PlacementPlanner(
        catalog, options=side.scale.PlacementOptions(**merged),
        scene_bytes_fn=scene_bytes_fn, clock=clock or FakeClock())


def _router(side, clock, *replicas):
    r = side.scale.Router(heartbeat_timeout_s=10.0, clock=clock)
    for rep in replicas:
        r.register(rep)
    r.sweep()
    return r


def _plan(p):
    """A plan as plain data (its moves as tuples)."""
    return {"version": p.version, "assignments": p.assignments,
            "moves": [(m.kind, m.scene, m.replica) for m in p.moves],
            "reason": p.reason, "scene_heat": p.scene_heat,
            "converged": p.converged, "by_kind": p.moves_by_kind()}


def _placement_rows(side):
    return strip(r for r in side.rows
                 if r["kind"] in ("placement_plan", "placement_move",
                                  "scale_decision", "router"))


# -- planner -----------------------------------------------------------------


def _determinism(side):
    planner = _planner(side, FakeCatalog("a", "b"))
    states = {"r0": _state(scenes=["a"]), "r1": _state()}
    plans = [planner.plan(dict(states), _heat(a=3.0, b=0.1)),
             planner.plan(dict(states), _heat(a=3.0, b=0.1)),
             planner.plan(states, _heat(a=0.0, b=0.1))]
    return {"plans": [_plan(p) for p in plans], "stats": planner.stats()}


def _catalog_and_budgets(side):
    """Only catalog scenes are planned; packing never overfills a
    replica; the two ladder tiers pool into one planning budget."""
    only = _planner(side, FakeCatalog("a")).plan(
        {"r0": _state(scenes=["a", "ghost"])}, _heat(a=0.2, phantom=9.0))
    packer = _planner(side, FakeCatalog("a", "b", "c", "d", "e"),
                      scene_bytes_fn=lambda sid: 100)
    packed = packer.plan({"r0": _state(hbm_budget=250),
                          "r1": _state(hbm_budget=250)},
                         _heat(a=0.1, b=0.1, c=0.1, d=0.1, e=0.1))
    pooled = _planner(side, FakeCatalog("a", "b"),
                      scene_bytes_fn=lambda sid: 100).plan(
        {"r0": _state(hbm_budget=60, staging_budget=60)},
        _heat(a=0.2, b=0.1))
    mean = _planner(side, FakeCatalog("a", "b", "c")).plan(
        {"r0": _state(scenes=["a"], hbm_bytes=300, hbm_budget=500),
         "r1": _state(staging=["b"], staging_bytes=300,
                      staging_budget=200)},
        _heat(c=0.3))
    return {"plans": [_plan(p) for p in (only, packed, pooled, mean)],
            "unplanned_e": packer.planned_replicas("e")}


def _width(side):
    states = {f"r{i}": _state() for i in range(4)}
    widths = [len(_planner(side, FakeCatalog("a"), max_width=3).plan(
        dict(states), _heat(a=rps)).assignments["a"])
        for rps in (0.5, 1.0, 3.0, 99.0)]
    fleet = _planner(side, FakeCatalog("a"), max_width=8).plan(
        {"r0": _state(), "r1": _state()}, _heat(a=50.0))
    return {"widths": widths, "fleet": _plan(fleet)}


def _move_order(side):
    planner = _planner(side, FakeCatalog("a"))
    planner.note_publish("a")
    ordered = planner.plan({"r0": _state(scenes=["a", "stale"]),
                            "r1": _state()}, _heat(a=2.0))
    hottest = _planner(side, FakeCatalog("a", "b")).plan(
        {"r0": _state()}, _heat(a=0.2, b=0.9))
    return {"plans": [_plan(ordered), _plan(hottest)]}


def _executor(side):
    clock = FakeClock()
    planner = _planner(side, FakeCatalog("a"), clock=clock)
    plan = planner.plan({"r0": _state()}, _heat(a=2.0))
    clock.advance(3.0)
    lazy = side.scale.PlacementExecutor().execute(planner)

    class PinnedLadder:
        def prefetch(self, sid):
            return True

        def evict(self, sid):
            return False  # a pinned lease: evict() refuses

    class FlakyPublisher:
        def publish(self, record):
            raise OSError(f"torn {record['scene_id']}")

    pinned = _planner(side, FakeCatalog("a"))
    pinned.note_publish("a")
    pinned.plan({"r0": _state(scenes=["stale", "a"])}, _heat(a=0.2))
    applied = side.scale.PlacementExecutor(
        residency_of=lambda rid: PinnedLadder(),
        publisher_of=lambda rid: FlakyPublisher(),
        catalog=FakeCatalog("a")).execute(pinned, limit=8)
    return {"plan": _plan(plan), "lazy": lazy, "applied": applied,
            "stats": [planner.stats(), pinned.stats()]}


PLANNER_SCRIPTS = {
    "determinism": _determinism,
    "catalog_and_budgets": _catalog_and_budgets,
    "width": _width,
    "move_order": _move_order,
    "executor": _executor,
}


@pytest.mark.parametrize("script", list(PLANNER_SCRIPTS))
def test_planner_matches_jax(script):
    def scenario(side):
        out = PLANNER_SCRIPTS[script](side)
        rows = [r for r in side.rows if r["kind"].startswith("placement")]
        return {**out, "rows": _placement_rows(side),
                "invalid": [side.obs.validate_row(r) for r in rows
                            if side.obs.validate_row(r)]}

    ref, out = run_both(scenario)
    assert out == ref
    assert out["invalid"] == [] and out["rows"]
    if script == "width":
        assert out["widths"] == [1, 2, 3, 3]
    if script == "executor":
        assert out["applied"]["failed"] == 2  # the torn publish + pinned


# -- router: plan consult and capability filter ------------------------------


def _plan_beats_affinity(side):
    clock = FakeClock()
    holder = side.fake_replica("r0", load=0, scenes=["lego"])
    other = side.fake_replica("r1", load=5)
    router = _router(side, clock, holder, other)
    picks = [router.pick("lego").replica_id]
    planner = _planner(side, FakeCatalog("lego"),
                       scene_bytes_fn=lambda sid: 100)
    router.set_planner(planner)
    planner.plan({"r0": _state(scenes=["lego"], hbm_budget=1),
                  "r1": _state(hbm_budget=1000)}, _heat(lego=0.2))
    picks.append(router.pick("lego").replica_id)
    router.submit(None, 2.0, 6.0, scene="lego")
    router.submit(None, 2.0, 6.0, scene="ship")
    return {"picks": picks, "stats": router.stats()}


def _empty_plan_is_passive(side):
    def fleet():
        return (side.fake_replica("r0", load=2, scenes=["lego"]),
                side.fake_replica("r1", load=0),
                side.fake_replica("r2", load=0, scenes=["ship"]))

    clock = FakeClock()
    bare = _router(side, clock, *fleet())
    no_plan = _router(side, clock, *fleet())
    no_plan.set_planner(_planner(side, FakeCatalog("lego", "ship")))
    disabled = _router(side, clock, *fleet())
    off = side.scale.PlacementPlanner(
        FakeCatalog("lego", "ship"),
        options=side.scale.PlacementOptions(enabled=False))
    off.plan({"r0": _state(scenes=["lego"])}, _heat(lego=9.0))
    disabled.set_planner(off)
    empty = _router(side, clock, *fleet())
    hollow = _planner(side, FakeCatalog())
    hollow.plan({"r0": _state()}, {})
    empty.set_planner(hollow)
    return {scene or "none": [[c[:3] for c in r._candidates(scene)]
                              for r in (bare, no_plan, disabled, empty)]
            for scene in (None, "lego", "ship", "unknown")}


def _planned_group_order(side):
    clock = FakeClock()
    router = _router(side, clock,
                     side.fake_replica("a", load=9, scenes=["lego"]),
                     side.fake_replica("b", load=0),
                     side.fake_replica("c", load=0))
    planner = _planner(side, FakeCatalog("lego"))
    planner.current = side.scale.PlacementPlan(
        version=1, assignments={"lego": ("a", "c")})
    router.set_planner(planner)
    return {"order": [c[:3] for c in router._candidates("lego")]}


def _capabilities(side):
    clock = FakeClock()
    pose_only = side.fake_replica("http0", capabilities=("pose",))
    router = _router(side, clock, pose_only)
    try:
        router.submit(None, 2.0, 6.0)
        raised = None
    except side.scale.NoCapableReplicaError as exc:
        raised = (type(exc).__name__, str(exc))
    idle_pose = side.fake_replica("http1", load=0, capabilities=("pose",))
    universal = side.fake_replica("ray0", load=9)
    mixed = _router(side, clock, idle_pose, universal)
    fut = mixed.submit(None, 2.0, 6.0)
    return {"raised": raised, "state": pose_only.state,
            "failovers": router.n_failovers, "fut": fut,
            "submits": [idle_pose.submits, universal.submits]}


ROUTER_SCRIPTS = {
    "plan_beats_affinity": _plan_beats_affinity,
    "empty_plan_is_passive": _empty_plan_is_passive,
    "planned_group_order": _planned_group_order,
    "capabilities": _capabilities,
}


@pytest.mark.parametrize("script", list(ROUTER_SCRIPTS))
def test_router_plan_consult_matches_jax(script):
    def scenario(side):
        return {**ROUTER_SCRIPTS[script](side),
                "rows": _placement_rows(side)}

    ref, out = run_both(scenario)
    assert out == ref
    if script == "plan_beats_affinity":
        assert out["picks"] == ["r0", "r1"]
        assert (out["stats"]["n_planned_hits"],
                out["stats"]["n_unplanned"]) == (1, 1)
    if script == "empty_plan_is_passive":
        for scene in ("none", "lego", "ship", "unknown"):
            assert all(o == out[scene][0] for o in out[scene])
    if script == "planned_group_order":
        assert [c[2] for c in out["order"]] == ["a", "c", "b"]
    if script == "capabilities":
        assert out["raised"][0] == "NoCapableReplicaError"


# -- supervisor: the plan lifecycle ------------------------------------------


def _placement_supervisor(side, clock, heat):
    popt = side.scale.PlacementOptions(
        enabled=True, hot_width=2, max_width=4, hot_rps=0.5,
        width_rps=2.0, replan_every_s=1e9, max_moves_per_step=8)
    planner = side.scale.PlacementPlanner(
        FakeCatalog("lego"), options=popt,
        heat_fn=lambda: {"scenes": heat}, clock=clock)
    router = side.scale.Router(heartbeat_timeout_s=10.0, clock=clock)
    spawned = []

    def spawn_fn(i):
        r = side.fake_replica(f"s{i}", scenes=["lego"] if i == 0 else [])
        spawned.append(r)
        return r

    sup = side.scale.Supervisor(
        router, spawn_fn,
        options=side.scale.ScaleOptions(min_replicas=2, max_replicas=3,
                                        placement=popt),
        clock=clock, planner=planner,
        placement_executor=side.scale.PlacementExecutor())
    sup.ensure_min()
    router.sweep()
    return sup, planner, spawned


def _replan_on_death(side):
    clock = FakeClock()
    sup, planner, spawned = _placement_supervisor(side, clock,
                                                  _heat(lego=5.0))
    sup.step(1.0, 0.0)
    plans = [_plan(planner.current)]
    spawned[0].kill()
    replaced = sup.replace_dead()
    plans.append(_plan(planner.current))
    return {"plans": plans, "replaced": replaced, "stats": sup.stats()}


def _replan_on_publish(side):
    clock = FakeClock()
    sup, planner, _ = _placement_supervisor(side, clock, _heat(lego=5.0))
    sup.step(1.0, 0.0)
    sup.note_publish("lego")
    sup.step(1.0, 0.0)
    return {"plan": _plan(planner.current), "stats": sup.stats()}


@pytest.mark.parametrize("script", ["death", "publish"])
def test_supervisor_replans_match_jax(script):
    fn = {"death": _replan_on_death, "publish": _replan_on_publish}[script]
    ref, out = run_both(lambda side: {**fn(side),
                                      "rows": _placement_rows(side)})
    assert out == ref
    if script == "death":
        assert out["plans"][1]["reason"] == "replace"
        assert out["plans"][1]["assignments"]["lego"] == ("s1", "s2")
    else:
        assert out["plan"]["reason"] == "publish"


def test_merge_heat_and_planner_rows_match_jax():
    """``merge_heat`` over ledger views and flat dicts, and the JAX test's
    hand-built placement rows under both schemas."""
    def scenario(side):
        merged = side.scale.merge_heat(
            {"scenes": {"a": {"requests_per_s": 1.0, "rays_per_s": 10.0}}},
            {"a": {"requests_per_s": 2.0}, "b": {"requests_per_s": 0.5},
             "junk": 3.0},
            None)
        rows = [{"v": 1, "t": 0.0, "kind": "placement_plan", "version": 1,
                 "reason": "periodic", "n_scenes": 1, "n_replicas": 1,
                 "n_moves": 1, "moves_by_kind": {"prefetch": 1},
                 "converged": False, "planned_hits": 3, "unplanned": 1,
                 "evidence": {"scene_heat": {"a": {"requests_per_s": 2.0}}}},
                {"v": 1, "t": 0.0, "kind": "placement_move", "version": 1,
                 "move": "prefetch", "scene": "a", "replica": "r0",
                 "ok": True}]
        return {"merged": merged,
                "verdicts": [side.obs.validate_row(r) for r in rows]}

    ref, out = run_both(scenario)
    assert out == ref
    assert out["merged"]["a"] == {"requests_per_s": 3.0, "rays_per_s": 10.0}
    assert out["verdicts"] == [[], []]


# -- the real thing: two port serve children ---------------------------------


@pytest.mark.slow
def test_launcher_spawns_two_real_children_ready_drain_exit(tmp_path):
    """spawn -> ready -> render -> drain -> exit on REAL port serve
    children (``python -m nerf_replication_tpu_torch.serve --device
    cpu``). Slow: two child engine boots and warm-ups; excluded from
    tier-1 (the card runs the same path in chip_smoke.py phase 20)."""
    import yaml

    from nerf_replication_tpu_torch.datasets.procedural import generate_scene
    from nerf_replication_tpu_torch.scale import (
        ProcessLauncher,
        ReplicaState,
    )

    scene_root = str(tmp_path / "scene")
    generate_scene(scene_root, scene="procedural", H=16, W=16,
                   n_train=2, n_test=1)
    doc = {
        "parent_cfg": os.path.join(_REPO, "configs", "nerf", "lego.yaml"),
        "task": "run",
        "scene": "procedural",
        "exp_name": "launcher_test",
        "train_dataset": {"data_root": scene_root, "H": 16, "W": 16},
        "test_dataset": {"data_root": scene_root, "H": 16, "W": 16},
        "task_arg": {"N_samples": 24, "N_importance": 24},
        "network": {"nerf": {"W": 64, "D": 3, "skips": [1]},
                    "xyz_encoder": {"freq": 6},
                    "dir_encoder": {"freq": 2}},
        "serve": {"buckets": [256], "max_batch_rays": 256,
                  "max_delay_ms": 5.0, "request_timeout_s": 30.0},
        "record_dir": str(tmp_path / "record"),
        "obs": {"trace": False, "alerts": {"enabled": False}},
    }
    cfg_path = str(tmp_path / "serve_cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(doc, f, sort_keys=True)
    launcher = ProcessLauncher(cfg_path, device="cpu",
                               ready_timeout_s=600.0)
    try:
        r0 = launcher(0)
        r1 = launcher(1)
        assert r0.port != r1.port
        b0, b1 = r0.heartbeat(), r1.heartbeat()
        assert b0["ok"] and b1["ok"]
        assert r0.state == ReplicaState.READY
        assert b0["total_compiles"] == b1["total_compiles"] == 0
        out = r0.render({"theta": 30.0, "phi": -30.0, "radius": 4.0},
                        timeout_s=120.0)
        assert out["h"] > 0 and out["rgb_b64"]
        assert launcher.retire(r1, timeout_s=60.0) == 0
        assert r1.state == ReplicaState.RETIRED
        assert r1.proc.returncode == 0  # SIGTERM: a clean exit
        assert launcher.stats()["n_spawned"] == 2
    finally:
        launcher.shutdown()
