"""Port parity of the front-door router and the supervisor's closed loop
(``scale/router.py``, ``scale/supervisor.py``).

Each scenario of the JAX package's ``tests/test_scale.py`` runs on the
JAX classes and on the port's with the same fake clock and scripted
replicas (``_torch_ops_pair``): router picks, failovers, dead-marking,
the supervisor's decision sequence, its ``scale_decision`` / ``replica``
/ ``router`` rows and the fleet's states must be ``==``.
"""

import numpy as np
import pytest

from _torch_ops_pair import FakeClock, run_both, strip

NEAR, FAR = 2.0, 6.0
RAYS = np.zeros((4, 6), np.float32)


def _rows(side):
    return strip(r for r in side.rows
                 if r["kind"] in ("scale_decision", "replica", "router"))


def _invalid(side):
    return [side.obs.validate_row(r) for r in side.rows
            if side.obs.validate_row(r)]


def _router(side, clock, *replicas, timeout_s=10.0):
    r = side.scale.Router(heartbeat_timeout_s=timeout_s, clock=clock)
    for rep in replicas:
        r.register(rep)
    r.sweep()
    return r


def _ids(picks):
    return [None if p is None else p.replica_id for p in picks]


# -- router ------------------------------------------------------------------


def _affinity(side):
    clock = FakeClock()
    busy = side.fake_replica("r0", load=9, scenes=["lego"])
    idle = side.fake_replica("r1", load=0)
    router = _router(side, clock, busy, idle)
    return {"picks": _ids([router.pick("lego"), router.pick("ship"),
                           router.pick(None)])}


def _least_loaded(side):
    clock = FakeClock()
    router = _router(side, clock, side.fake_replica("a", load=3),
                     side.fake_replica("b", load=1),
                     side.fake_replica("c", load=1))
    return {"picks": _ids([router.pick()]),
            "order": [c[:3] for c in router._candidates(None)]}


def _failover(side):
    clock = FakeClock()
    first = side.fake_replica("r0", load=0)
    second = side.fake_replica("r1", load=5)
    router = _router(side, clock, first, second)
    first.fail_submit = True
    fut = router.submit(RAYS, NEAR, FAR, scene="lego")
    return {"fut": fut, "submits": second.submits, "state": first.state,
            "stats": router.stats()}


def _all_gone(side):
    clock = FakeClock()
    only = side.fake_replica("r0")
    router = _router(side, clock, only)
    only.kill()
    try:
        router.submit(RAYS, NEAR, FAR)
        raised = None
    except side.scale.NoReplicaAvailableError as exc:
        raised = (type(exc).__name__, str(exc))
    return {"raised": raised, "stats": router.stats()}


def _heartbeat_hysteresis(side):
    clock = FakeClock()
    rep = side.fake_replica("r0")
    router = _router(side, clock, rep, timeout_s=10.0)
    rep.beat_ok = False
    out = []
    for dt in (5.0, 6.0):
        clock.advance(dt)
        out.append((router.sweep(), rep.state))
    return {"sweeps": out, "stats": router.stats()}


def _draining_not_dead(side):
    clock = FakeClock()
    draining = side.fake_replica("r0")
    other = side.fake_replica("r1")
    router = _router(side, clock, draining, other)
    draining.state = side.scale.ReplicaState.DRAINING
    fut = router.submit(RAYS, NEAR, FAR)
    failed = router.drain("r1")
    return {"fut": fut, "state": draining.state, "failed": failed,
            "views": (router.load_view(), router.residency_view()),
            "stats": router.stats()}


ROUTER_SCRIPTS = {
    "affinity": _affinity,
    "least_loaded": _least_loaded,
    "failover": _failover,
    "all_gone": _all_gone,
    "heartbeat_hysteresis": _heartbeat_hysteresis,
    "draining_not_dead": _draining_not_dead,
}


@pytest.mark.parametrize("script", list(ROUTER_SCRIPTS))
def test_router_matches_jax(script):
    def scenario(side):
        out = ROUTER_SCRIPTS[script](side)
        return {**out, "rows": _rows(side), "invalid": _invalid(side)}

    ref, out = run_both(scenario)
    assert out == ref
    assert out["invalid"] == []
    if script == "affinity":
        assert out["picks"] == ["r0", "r1", "r1"]
    if script == "failover":
        assert out["fut"] == "future:r1" and out["state"] == "dead"
    if script == "heartbeat_hysteresis":
        assert [s[1] for s in out["sweeps"]] == ["ready", "dead"]


# -- supervisor: the decision table ------------------------------------------


def _supervisor(side, clock, n_start=1, **overrides):
    opts = side.scale.ScaleOptions(**{**dict(
        min_replicas=1, max_replicas=4, out_below=0.90, in_above=0.98,
        deny_above=0.05, out_windows=2, in_windows=3,
        cooldown_out_s=30.0, cooldown_in_s=60.0,
    ), **overrides})
    router = side.scale.Router(heartbeat_timeout_s=10.0, clock=clock)
    spawned = []

    def spawn_fn(i):
        r = side.fake_replica(f"s{i}")
        spawned.append(r)
        return r

    sup = side.scale.Supervisor(router, spawn_fn, options=opts, clock=clock)
    for _ in range(n_start):
        sup._spawn("test_boot")
    return sup, router, spawned


def _drive(sup, clock, windows, dt=10.0):
    """``(attainment, deny_rate)`` windows through ``step``; the actions
    and the ready count after each."""
    out = []
    for att, deny in windows:
        out.append((sup.step(att, deny_rate=deny), sup.router.n_ready()))
        clock.advance(dt)
    return out


def _sup_consecutive(side):
    clock = FakeClock()
    sup, _, _ = _supervisor(side, clock)
    return {"steps": _drive(sup, clock, [(0.5, 0.0), (0.5, 0.0)]),
            "decisions": sup.decisions}


def _sup_single_miss(side):
    clock = FakeClock()
    sup, _, _ = _supervisor(side, clock)
    return {"steps": _drive(sup, clock, [(a, 0.0) for a in
                                         (0.99, 0.5, 0.99, 0.5, 0.99)]),
            "decisions": sup.decisions}


def _sup_cooldown(side):
    clock = FakeClock()
    sup, _, _ = _supervisor(side, clock, cooldown_out_s=100.0)
    steps = _drive(sup, clock, [(0.5, 0.0)] * 4, dt=0.0)
    clock.advance(101.0)
    steps += _drive(sup, clock, [(0.5, 0.0)], dt=0.0)
    return {"steps": steps, "decisions": sup.decisions}


def _sup_max(side):
    clock = FakeClock()
    sup, _, _ = _supervisor(side, clock, max_replicas=2, cooldown_out_s=0.0)
    return {"steps": _drive(sup, clock, [(0.5, 0.0)] * 4),
            "decisions": sup.decisions}


def _sup_deny(side):
    clock = FakeClock()
    sup, _, _ = _supervisor(side, clock)
    return {"steps": _drive(sup, clock, [(0.99, 0.2)] * 2),
            "decisions": sup.decisions}


def _sup_scale_in(side):
    clock = FakeClock()
    sup, _, spawned = _supervisor(side, clock, n_start=2, in_windows=3,
                                  cooldown_in_s=0.0)
    spawned[0]._load = 4
    spawned[1]._load = 0
    steps = _drive(sup, clock, [(0.99, 0.0)] * 3)
    return {"steps": steps, "decisions": sup.decisions,
            "states": [r.state for r in spawned],
            "drains": [r.drains for r in spawned], "stats": sup.stats()}


def _sup_min_and_idle(side):
    clock = FakeClock()
    at_min, _, _ = _supervisor(side, clock, n_start=1, in_windows=2,
                               cooldown_in_s=0.0)
    idle, _, _ = _supervisor(side, clock, n_start=2, in_windows=2,
                             cooldown_in_s=0.0)
    return {"min": _drive(at_min, clock, [(0.99, 0.0)] * 2),
            "idle": _drive(idle, clock, [(None, 0.0)] * 2),
            "decisions": at_min.decisions + idle.decisions}


def _sup_band(side):
    clock = FakeClock()
    sup, _, _ = _supervisor(side, clock, n_start=2, in_windows=2,
                            cooldown_in_s=0.0, cooldown_out_s=0.0)
    return {"steps": _drive(sup, clock, [(a, 0.0) for a in
                                         (0.5, 0.94, 0.5, 0.99, 0.94, 0.99)]),
            "decisions": sup.decisions}


def _sup_replace_dead(side):
    clock = FakeClock()
    sup, router, spawned = _supervisor(side, clock, n_start=2,
                                       cooldown_out_s=1e9)
    spawned[0].beat_ok = False
    clock.advance(11.0)
    steps = _drive(sup, clock, [(0.99, 0.0)])
    return {"steps": steps, "decisions": sup.decisions,
            "registered": [r.replica_id for r in router.replicas()],
            "stats": sup.stats()}


def _sup_flight_dump(side, tmp):
    """Every out/in notes the decision into the flight ring and dumps
    ``flight_scale_<dir>.json``."""
    clock = FakeClock()
    side.resil.install_flight_recorder(
        side.resil.FlightRecorder(tmp, capacity=64))
    sup, _, _ = _supervisor(side, clock, n_start=2, in_windows=1,
                            cooldown_in_s=0.0, cooldown_out_s=0.0)
    steps = _drive(sup, clock, [(0.5, 0.0), (0.5, 0.0), (0.99, 0.0)])
    import json
    import os

    dumps = {}
    for name in sorted(os.listdir(tmp)):
        with open(os.path.join(tmp, name)) as fh:
            d = json.load(fh)
        dumps[name] = {"reason": d.get("reason"), "detail": d.get("detail"),
                       "events": [{k: v for k, v in e.items() if k != "t"}
                                  for e in d.get("events", [])]}
    return {"steps": steps, "decisions": sup.decisions, "dumps": dumps}


SUP_SCRIPTS = {
    "consecutive": _sup_consecutive,
    "single_miss": _sup_single_miss,
    "cooldown": _sup_cooldown,
    "max_replicas": _sup_max,
    "deny_rate": _sup_deny,
    "scale_in": _sup_scale_in,
    "min_and_idle": _sup_min_and_idle,
    "hysteresis_band": _sup_band,
    "replace_dead": _sup_replace_dead,
    "flight_dump": _sup_flight_dump,
}


@pytest.mark.parametrize("script", list(SUP_SCRIPTS))
def test_supervisor_matches_jax(script, tmp_path):
    dirs = iter([str(tmp_path / "jax"), str(tmp_path / "port")])

    def scenario(side):
        fn = SUP_SCRIPTS[script]
        out = fn(side, next(dirs)) if script == "flight_dump" else fn(side)
        return {**out, "rows": _rows(side), "invalid": _invalid(side)}

    ref, out = run_both(scenario)
    assert out == ref
    assert out["invalid"] == []
    actions = [s[0] for s in out.get("steps", [])]
    want = {"consecutive": ["hold", "out"],
            "single_miss": ["hold"] * 5,
            "cooldown": ["hold", "out", "hold", "hold", "out"],
            "max_replicas": ["hold", "out", "hold", "hold"],
            "deny_rate": ["hold", "out"],
            "scale_in": ["hold", "hold", "in"],
            "hysteresis_band": ["hold"] * 6,
            "replace_dead": ["replace"],
            "flight_dump": ["hold", "out", "in"]}.get(script)
    if want is not None:
        assert actions == want
    if script == "flight_dump":
        assert sorted(out["dumps"]) == ["flight_scale_in.json",
                                        "flight_scale_out.json"]


def test_router_fails_over_a_reply_cut_short():
    """A child killed while it writes a reply leaves the router an
    ``http.client.IncompleteRead`` (an ``HTTPException``, not an
    ``OSError``): the pose render goes to the next child, counted as a
    failover, and no request is lost (chip_smoke.py phase 20's kill)."""
    import http.client

    from _torch_ops_pair import PORT_PKG, Side, isolated

    with isolated(Side(PORT_PKG)) as side:
        _cut_reply_failover(side, http.client)


def _cut_reply_failover(side, http_client):
    class PoseReplica:
        def __init__(self, rid, load, fail):
            self.replica_id, self._load, self.fail = rid, load, fail
            self.state = side.scale.ReplicaState.READY
            self.bodies = []

        def accepting(self):
            return self.state == side.scale.ReplicaState.READY

        def load(self):
            return self._load

        def heartbeat(self):
            return {"replica": self.replica_id, "state": self.state,
                    "ok": True, "load": self._load, "scenes": []}

        def resident_scenes(self):
            return []

        def render(self, body, timeout_s=30.0):
            self.bodies.append(body)
            if self.fail:
                raise http_client.IncompleteRead(b"", 16500)
            return {"image": self.replica_id}

    cut = PoseReplica("r0", 0, True)
    live = PoseReplica("r1", 5, False)
    router = _router(side, FakeClock(), cut, live)
    out = router.render({"theta": 40.0})
    assert out == {"image": "r1"}
    assert len(cut.bodies) == len(live.bodies) == 1
    assert router.stats()["n_failovers"] == 1
    # the cut child is marked dead, then the request fails over
    assert [r["event"] for r in side.rows if r["kind"] == "router"] == [
        "dead", "failover"]
