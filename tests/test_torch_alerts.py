"""Port parity of the ops-intelligence layer (``obs/alerts.py``,
``obs/incidents.py``, ``obs/capacity.py``, the windowed SLO view) and the
port server's ops loop.

Each scenario of the JAX package's ``tests/test_alerts.py`` runs once on
the JAX classes and once on the port's, fed the same fake clock and the
same rows (``_torch_ops_pair.run_both``): alert states, transitions and
rows, incident timelines and dumps, and ledger accounting must be ``==``,
floats exact. The last test runs the port's HTTP server with the whole
ops loop on a tiny CPU engine: ``/alerts``, the ``/healthz`` alerts and
replica blocks, ``/drain``, and no capture or route build after warm-up.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from _torch_ops_pair import FakeClock, run_both, strip

# second-scale windows so one scenario drives whole alert lifetimes
_WINDOWS = dict(fast_short_s=60.0, fast_long_s=600.0, slow_short_s=120.0,
                slow_long_s=1200.0, clear_hold_s=120.0)


def _alert_record(side, eng, views):
    return {
        "views": views,
        "transitions": eng.transitions,
        "active": eng.active(),
        "alert_seconds": eng.alert_seconds,
        "healthz": eng.healthz_block(),
        "rows": strip(r for r in side.rows if r["kind"] == "alert"),
        "invalid": [side.obs.validate_row(r) for r in side.rows
                    if side.obs.validate_row(r)],
    }


def _burn_page(side):
    """20% errors against 99%: the page fires on both windows, holds
    through ``clear_hold_s`` once traffic ages out, then clears once."""
    clock = FakeClock(10_000.0)
    eng = side.obs.AlertEngine(side.obs.AlertOptions(**_WINDOWS),
                               clock=clock)
    eng.observe_window(attainment=0.8, deny_rate=0.0, n=100)
    views = [eng.evaluate()]
    for dt in (700.0, 60.0, 61.0):
        clock.advance(dt)
        views.append(eng.evaluate())
    return _alert_record(side, eng, views)


def _long_window_blip(side):
    """A burst diluted by healthy history in the long window never pages."""
    clock = FakeClock(50_000.0)
    eng = side.obs.AlertEngine(side.obs.AlertOptions(**_WINDOWS),
                               clock=clock)
    eng.observe_window(attainment=1.0, deny_rate=0.0, n=1000)
    clock.advance(550.0)
    eng.observe_window(attainment=0.0, deny_rate=0.0, n=50)
    return _alert_record(side, eng, [eng.evaluate()])


def _deny_and_idle(side):
    """The deny budget is its own signal; empty windows never fire."""
    idle = side.obs.AlertEngine(side.obs.AlertOptions(**_WINDOWS),
                                clock=FakeClock(1_000.0))
    clock = FakeClock(1_000.0)
    eng = side.obs.AlertEngine(side.obs.AlertOptions(**_WINDOWS),
                               clock=clock)
    eng.observe_window(attainment=1.0, deny_rate=0.5, n=100)
    return {"idle": idle.evaluate(),
            **_alert_record(side, eng, [eng.evaluate()])}


def _breaker(side):
    """A breaker-open row pages at once (naming the point); a closed row
    clears it; both transitions are rows and reach listeners."""
    clock = FakeClock(2_000.0)
    eng = side.obs.AlertEngine(
        side.obs.AlertOptions(**{**_WINDOWS, "clear_hold_s": 0.0}),
        clock=clock)
    events = []
    eng.add_listener(events.append)
    eng._on_row({"kind": "breaker", "point": "serve.dispatch",
                 "state": "open", "failures": 5})
    views = [eng.evaluate()]
    eng._on_row({"kind": "breaker", "point": "serve.dispatch",
                 "state": "closed", "failures": 0})
    views.append(eng.evaluate())
    eng.remove_listener(events.append)
    return {"events": events, **_alert_record(side, eng, views)}


def _orphans(side):
    """A child whose parent never arrives is an orphan after the grace."""
    clock = FakeClock(3_000.0)
    eng = side.obs.AlertEngine(
        side.obs.AlertOptions(**{**_WINDOWS, "orphan_grace_s": 10.0,
                                 "clear_hold_s": 0.0}), clock=clock)
    eng._on_row({"kind": "span", "span_id": "c1", "parent_id": "gone1"})
    eng._on_row({"kind": "span", "span_id": "c2", "parent_id": "p1"})
    eng._on_row({"kind": "span", "span_id": "p1"})
    views = [eng.evaluate()]
    for dt in (10.0, 70.0):
        clock.advance(dt)
        views.append(eng.evaluate())
    return _alert_record(side, eng, views)


def _thrash(side):
    """Demote -> re-promote churn at the ladder tickets."""
    clock = FakeClock(4_000.0)
    eng = side.obs.AlertEngine(
        side.obs.AlertOptions(**{**_WINDOWS, "thrash_per_min_max": 6.0,
                                 "clear_hold_s": 0.0}), clock=clock)
    for _ in range(7):
        eng._on_row({"kind": "scene_evict", "scene": "lego",
                     "reason": "demoted"})
        eng._on_row({"kind": "scene_load", "scene": "lego",
                     "source": "staging"})
    views = [eng.evaluate()]
    clock.advance(120.0)
    views.append(eng.evaluate())
    return _alert_record(side, eng, views)


def _row_tap_feed(side):
    """serve_request / tenant_admit rows through the attached tap: slow
    and failed requests burn the SLO budget, denials the deny budget;
    the status view carries the alert seconds."""
    clock = FakeClock(6_000.0)
    eng = side.obs.AlertEngine(side.obs.AlertOptions(**_WINDOWS),
                               slo_target_s=0.1, clock=clock,
                               replica="r3").attach()
    em = side.emit.get_emitter()
    for i in range(40):
        em.emit("serve_request", latency_s=0.5 if i % 3 == 0 else 0.01,
                n_rays=64, tier="full",
                status="error" if i % 7 == 0 else "ok")
        em.emit("tenant_admit", tenant="t", decision="deny" if i % 2
                else "admit", retry_after_s=1.0)
    views = [eng.evaluate()]
    clock.advance(30.0)
    status = eng.status()
    eng.detach()
    return {"status": status, **_alert_record(side, eng, views)}


ALERT_SCRIPTS = {
    "burn_page": _burn_page,
    "long_window_blip": _long_window_blip,
    "deny_and_idle": _deny_and_idle,
    "breaker": _breaker,
    "orphans": _orphans,
    "thrash": _thrash,
    "row_tap_feed": _row_tap_feed,
}


@pytest.mark.parametrize("script", list(ALERT_SCRIPTS))
def test_alert_engine_matches_jax(script):
    ref, out = run_both(ALERT_SCRIPTS[script])
    assert out == ref
    assert out["invalid"] == []
    fired = {t["name"] for t in out["transitions"]
             if t["state"] == "firing"}
    want = {"burn_page": {"slo_burn_page", "slo_burn_ticket"},
            "long_window_blip": set(),
            "deny_and_idle": {"deny_burn_page", "deny_burn_ticket"},
            "breaker": {"breaker_open"},
            "orphans": {"orphan_spans"},
            "thrash": {"staging_thrash"},
            "row_tap_feed": {"slo_burn_page", "slo_burn_ticket",
                             "deny_burn_page", "deny_burn_ticket"}}[script]
    assert fired == want


def test_alert_options_from_cfg_match_jax():
    """``AlertOptions.from_cfg`` reads the same ``obs.alerts`` block, the
    port's config defaults included."""
    from test_torch_helpers import both_cfgs

    from nerf_replication_tpu.obs import AlertOptions as JaxOptions
    from nerf_replication_tpu_torch.obs import AlertOptions

    opts = ["obs.alerts.fast_short_s", "4.0", "obs.alerts.clear_hold_s",
            "2.5", "obs.alerts.slo_objective", "0.95"]
    jcfg, pcfg = both_cfgs(opts)
    assert vars(AlertOptions.from_cfg(pcfg)) == vars(
        JaxOptions.from_cfg(jcfg))
    assert AlertOptions.from_cfg(pcfg).fast_short_s == 4.0
    assert dict(pcfg.obs.alerts) == dict(jcfg.obs.alerts)


# -- incident correlation ----------------------------------------------------


def _feed_timeline(mgr, t0):
    mgr._on_row({"kind": "fault", "point": "serve.flush",
                 "fault": "io_error", "mode": "count", "t": t0})
    mgr._on_row({"kind": "retry", "point": "serve.flush", "attempt": 1,
                 "outcome": "success", "t": t0 + 1})
    mgr._on_row({"kind": "breaker", "point": "serve.dispatch",
                 "state": "open", "failures": 5, "t": t0 + 2})
    mgr._on_row({"kind": "span", "trace_id": "abc123", "span_id": "s1",
                 "name": "render", "dur_s": 0.31, "status": "ok",
                 "t": t0 + 3})
    mgr._on_row({"kind": "span", "trace_id": "zzz999", "span_id": "s2",
                 "name": "render", "dur_s": 0.02, "status": "ok",
                 "t": t0 + 3})
    mgr._on_row({"kind": "scale_decision", "action": "scale_out",
                 "reason": "attainment", "n_replicas": 2,
                 "attainment": 0.5,
                 "evidence": {"exemplar_trace_ids": ["abc123"]},
                 "t": t0 + 4})
    mgr._on_row({"kind": "scene_load", "scene": "lego", "source": "disk",
                 "load_s": 0.2, "t": t0 + 5})
    mgr._on_row({"kind": "tenant_admit", "tenant": "bronze",
                 "decision": "deny", "reason": "rate", "t": t0 + 6})


def _incident_record(side, mgr, out_dir):
    """Incidents, their dumps (json + markdown) and rows, paths made
    relative to the scenario's own directory."""
    def rel(p):
        return os.path.relpath(p, out_dir) if p else p

    incs = [{**inc, "path": rel(inc["path"])} for inc in mgr.incidents]
    dumps = []
    for inc in mgr.incidents:
        with open(inc["path"]) as fh:
            d = json.load(fh)
        with open(inc["path"][:-len(".json")] + ".md") as fh:
            md = fh.read()
        dumps.append(({**d, "path": rel(d["path"])},
                      md.replace(out_dir, "<dir>"),
                      side.obs.validate_incident_dump(inc["path"])))
    rows = [{**r, "path": rel(r["path"])} for r in strip(side.rows)
            if r["kind"] == "incident"]
    return {"incidents": incs, "dumps": dumps, "rows": rows,
            "stats": mgr.stats(),
            "invalid": [side.obs.validate_row(r) for r in side.rows
                        if side.obs.validate_row(r)]}


def _inc_timeline(side, out_dir):
    clock = FakeClock(5_000.0)
    mgr = side.obs.IncidentManager(out_dir, clock=clock, lookback_s=300.0,
                                   coalesce_s=30.0, quiet_s=60.0)
    _feed_timeline(mgr, clock.t)
    clock.advance(10.0)
    mgr.on_alert({"name": "slo_burn_page", "state": "firing",
                  "severity": "page", "value": 0.2, "threshold": 14.4})
    mgr.on_flight_dump("breaker_open", "flight_breaker_open.json",
                       "serve.dispatch open")
    return _incident_record(side, mgr, out_dir)


def _inc_lifecycle(side, out_dir):
    clock = FakeClock(5_000.0)
    mgr = side.obs.IncidentManager(out_dir, clock=clock, lookback_s=300.0,
                                   coalesce_s=30.0, quiet_s=60.0)
    mgr.on_alert({"name": "slo_burn_page", "state": "firing",
                  "severity": "page", "value": 0.2, "threshold": 14.4})
    clock.advance(20.0)
    mgr.on_alert({"name": "deny_burn_page", "state": "firing",
                  "severity": "page", "value": 0.5, "threshold": 14.4})
    clock.advance(10.0)
    mgr.on_alert({"name": "slo_burn_page", "state": "resolved"})
    mgr.on_alert({"name": "deny_burn_page", "state": "resolved"})
    clock.advance(60.0)
    mgr.sweep()
    return _incident_record(side, mgr, out_dir)


def _inc_open_on_fault(side, out_dir):
    clock = FakeClock(7_000.0)
    mgr = side.obs.IncidentManager(out_dir, clock=clock, coalesce_s=30.0,
                                   quiet_s=60.0, open_on_fault=True)
    mgr._on_row({"kind": "fault", "point": "serve.flush",
                 "fault": "io_error", "t": clock.t})
    clock.advance(5.0)
    mgr._on_row({"kind": "fault", "point": "data.load",
                 "fault": "io_error", "t": clock.t})
    n = [mgr.resolve_open("recovery checks passed"), mgr.resolve_open()]
    return {"n_resolved": n, **_incident_record(side, mgr, out_dir)}


def _inc_quiet_sweep(side, out_dir):
    clock = FakeClock(8_000.0)
    mgr = side.obs.IncidentManager(out_dir, clock=clock, coalesce_s=5.0,
                                   quiet_s=60.0, open_on_fault=True)
    mgr._on_row({"kind": "fault", "point": "p", "fault": "f",
                 "t": clock.t})
    statuses = []
    for dt in (59.0, 1.0, 60.0):
        clock.advance(dt)
        mgr.sweep()
        statuses.append(mgr.incidents[0]["status"])
    return {"statuses": statuses, **_incident_record(side, mgr, out_dir)}


def _inc_lookback(side, out_dir):
    clock = FakeClock(9_000.0)
    mgr = side.obs.IncidentManager(out_dir, clock=clock, lookback_s=50.0)
    mgr._on_row({"kind": "fault", "point": "old", "fault": "f",
                 "t": clock.t})
    clock.advance(100.0)
    mgr._on_row({"kind": "fault", "point": "new", "fault": "f",
                 "t": clock.t})
    mgr.on_alert({"name": "a", "state": "firing", "severity": "page"})
    return _incident_record(side, mgr, out_dir)


INCIDENT_SCRIPTS = {
    "timeline": _inc_timeline,
    "lifecycle": _inc_lifecycle,
    "open_on_fault": _inc_open_on_fault,
    "quiet_sweep": _inc_quiet_sweep,
    "lookback": _inc_lookback,
}


@pytest.mark.parametrize("script", list(INCIDENT_SCRIPTS))
def test_incidents_match_jax(script, tmp_path):
    dirs = iter([str(tmp_path / "jax"), str(tmp_path / "port")])
    ref, out = run_both(lambda side: INCIDENT_SCRIPTS[script](
        side, next(dirs)))
    assert out == ref
    assert out["invalid"] == []
    assert out["incidents"] and all(d[2] == [] for d in out["dumps"])
    if script == "timeline":
        inc = out["incidents"][0]
        assert inc["trace_ids"] == ["abc123"]
        assert inc["flight_dumps"] == ["flight_breaker_open.json"]
    if script == "lifecycle":
        assert [r["status"] for r in out["rows"]] == [
            "open", "mitigated", "resolved"]


# -- capacity ledger ---------------------------------------------------------


def _ledger_accounting(side):
    clock = FakeClock(1_000.0)
    lg = side.obs.CapacityLedger(replica="r0", window_s=100.0, clock=clock)
    lg.note_residency(100, 200)
    lg.note_residency(50, 75)
    for _ in range(4):
        lg.note_request("lego", 512)
    for _ in range(2):
        lg.note_request("ship", 256)
    lg._on_row({"kind": "scene_load", "scene": "ship", "source": "staging"})
    lg._on_row({"kind": "scene_load", "scene": "fern", "source": "disk",
                "resident_bytes": 80, "staging_bytes": 75})
    lg._on_row({"kind": "scene_evict", "scene": "fern", "reason": "lru",
                "resident_bytes": 10})
    lg._on_row({"kind": "span", "stage": "device", "family": "nerf",
                "dur_s": 3.0})
    lg._on_row({"kind": "span", "stage": "device", "name": "prop",
                "dur_s": 1.0})
    lg._on_row({"kind": "span", "stage": "host", "name": "ignored",
                "dur_s": 99.0})
    lg._on_row({"kind": "serve_request", "scene": "lego", "n_rays": 64,
                "latency_s": 0.01, "tier": "full", "status": "ok"})
    views = [lg.view()]
    clock.advance(150.0)
    views.append(lg.view())
    return {"views": views, "stats": lg.stats()}


def _ledger_snapshot(side):
    clock = FakeClock(2_000.0)
    lg = side.obs.CapacityLedger(replica="r7", window_s=100.0, clock=clock)
    lg.note_residency(1234, 0)
    lg.note_request("lego", 128)
    lg.attach()
    side.emit.get_emitter().emit("serve_request", latency_s=0.0,
                                 n_rays=4096, tier="full", status="ok",
                                 cache_hit=True, scene="ship")
    lg.detach()
    view = lg.snapshot()
    rows = [r for r in side.rows if r["kind"] == "capacity_snapshot"]
    return {"view": view, "rows": strip(rows),
            "invalid": [side.obs.validate_row(r) for r in rows
                        if side.obs.validate_row(r)],
            "prometheus": side.obs.get_metrics().render_prometheus(),
            "n_snapshots": lg.n_snapshots}


@pytest.mark.parametrize("script", ["accounting", "snapshot"])
def test_capacity_ledger_matches_jax(script):
    fn = {"accounting": _ledger_accounting,
          "snapshot": _ledger_snapshot}[script]
    ref, out = run_both(fn)
    assert out == ref
    if script == "accounting":
        assert out["views"][0]["device_share"] == {"nerf": 0.75,
                                                   "prop": 0.25}
    else:
        assert out["invalid"] == []
        assert 'capacity_scene_requests_per_s{scene="ship"}' in \
            out["prometheus"]
        assert 'replica="' not in out["prometheus"]


def test_windowed_slo_view_matches_jax():
    """A fresh regression read over a window is not diluted by lifetime
    history: the port's registry agrees with JAX's on both reads."""
    def scenario(side):
        clock = FakeClock(0.0)
        reg = side.obs.MetricsRegistry(clock=clock)
        clock.t = 1_000.0
        for _ in range(200):
            reg.observe("serve_request_latency_seconds", 0.05)
        reg.counter("serve_requests_total", 200.0, status="ok")
        reg.counter("serve_breaker_transitions_total", 1.0, state="open")
        clock.t = 1_400.0
        for _ in range(50):
            reg.observe("serve_request_latency_seconds", 0.9)
        reg.counter("serve_requests_total", 50.0, status="ok")
        reg.counter("serve_requests_total", 10.0, status="timeout")
        return {"life": reg.slo_view(0.25),
                "window": reg.slo_view(0.25, window_s=60.0),
                "ok_60": reg.window_counter("serve_requests_total", 60.0,
                                            status="ok"),
                "all": reg.window_counter("serve_requests_total",
                                          10_000.0)}

    ref, out = run_both(scenario)
    assert out == ref
    assert out["life"]["attainment"] == pytest.approx(0.8)
    assert out["window"]["attainment"] == 0.0


# -- the port server's ops loop ----------------------------------------------


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode())


def _post(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method="POST",
        data=json.dumps(body or {}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode())


def test_port_server_ops_loop_alerts_drain_and_no_capture(tmp_path):
    """The port server with the alert engine, the incident correlator and
    the capacity ledger on a tiny CPU engine: a clean request stream
    fires nothing, ``/alerts`` and the ``/healthz`` blocks answer, a
    breaker-open row pages, ``/drain`` renders what is queued and the
    server refuses ``/render`` after it, the capacity snapshot counts the
    batched requests AND a pose-cache hit, and no capture or route build
    happens after warm-up."""
    from test_torch_helpers import SMALL_NET, box_grid, both_cfgs, nets

    from nerf_replication_tpu_torch.obs import (
        AlertEngine,
        AlertOptions,
        CapacityLedger,
        IncidentManager,
        emit,
    )
    from nerf_replication_tpu_torch.resil.flight import (
        add_dump_listener,
        remove_dump_listener,
    )
    from nerf_replication_tpu_torch.serve import MicroBatcher, RenderEngine
    from nerf_replication_tpu_torch.serve.__main__ import make_server

    _, _, pnet = nets()
    _, cfg = both_cfgs(SMALL_NET + [
        "task_arg.render_step_size", "0.25",
        "task_arg.max_march_samples", "64",
        "task_arg.march_chunk_size", "64",
        "task_arg.march_coarse_block", "4",
        "task_arg.march_coarse_cap", "3",
        "task_arg.march_fused_block", "64",
        "task_arg.march_fused", "full",
        "serve.buckets", "[64]", "serve.max_batch_rays", "64"])
    engine = RenderEngine(cfg, pnet, near=2.0, far=6.0, grid=box_grid(16),
                          bbox=np.asarray([[-1.5] * 3, [1.5] * 3],
                                          np.float32), device="cpu")
    engine.default_camera = {"H": 6, "W": 6, "focal": 8.0}
    saved = emit._active
    emit._active = emit.NullEmitter()
    rows = []
    emit.add_row_tap(rows.append)
    alerts = AlertEngine(AlertOptions(**{**_WINDOWS, "clear_hold_s": 0.0}),
                         slo_target_s=30.0, replica="r0").attach()
    incidents = IncidentManager(str(tmp_path), replica="r0").attach()
    alerts.add_listener(incidents.on_alert)
    add_dump_listener(incidents.on_flight_dump)
    capacity = CapacityLedger(replica="r0", window_s=60.0).attach()
    batcher = MicroBatcher(engine)
    server = make_server(engine, batcher, port=0, alerts=alerts,
                         slo_window_s=60.0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    before = (engine.total_compiles(), engine.route_builds,
              engine.stats()["captures"])
    try:
        pose = {"theta": 30.0, "phi": -30.0, "radius": 4.0}
        for i in range(3):
            code, out = _post(port, "/render", {**pose, "theta": 10.0 * i})
            assert code == 200 and out["cache_hit"] is False
        code, out = _post(port, "/render", pose)  # theta 30: a new view
        code, out = _post(port, "/render", pose)  # the same view: a hit
        assert code == 200 and out["cache_hit"] is True
        alerts.evaluate()
        code, view = _get(port, "/alerts")
        assert code == 200 and view["enabled"] and view["firing"] == []
        code, health = _get(port, "/healthz")
        assert code == 200 and health["alerts"]["n_firing"] == 0
        assert health["slo"]["window_s"] == 60.0
        rep = health["replica"]
        assert rep["total_compiles"] == 0
        assert set(rep["trace"]) == {"enabled", "spans", "dropped_sink",
                                     "remote_parented"}
        # a breaker-open row pages and opens an incident
        emit.get_emitter().emit("breaker", point="serve.dispatch",
                                state="open", failures=5)
        alerts.evaluate()
        incidents.sweep()
        code, view = _get(port, "/alerts")
        assert view["firing"] == ["breaker_open"]
        assert incidents.incidents and \
            incidents.incidents[0]["alerts"] == ["breaker_open"]
        # queued work renders before /drain replies; /render is refused
        futures = [batcher.submit(np.tile([[0.0, 0.0, 4.0, 0.0, 0.0, -1.0]],
                                          (8, 1)).astype(np.float32),
                                  2.0, 6.0) for _ in range(3)]
        code, drained = _post(port, "/drain")
        assert (code, drained) == (200, {"drained": True, "n_failed": 0})
        assert all(f.done() for f in futures)
        code, out = _post(port, "/render", {**pose, "theta": 99.0})
        assert code == 503
        snap = capacity.snapshot()
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        alerts.detach()
        incidents.detach()
        capacity.detach()
        remove_dump_listener(incidents.on_flight_dump)
        emit.remove_row_tap(rows.append)
        emit._active = saved
    after = (engine.total_compiles(), engine.route_builds,
             engine.stats()["captures"])
    assert after == before
    # 5 pose requests (4 batched + 1 cache hit) and the 3 direct submits
    # are request rows: each counted exactly once
    reqs = [r for r in rows if r["kind"] == "serve_request"]
    assert len(reqs) == 8
    assert sum(bool(r.get("cache_hit")) for r in reqs) == 1
    assert snap["requests_per_s"] == round(8 / 60.0, 4)
    assert any(r["kind"] == "alert" for r in rows)
    assert any(r["kind"] == "incident" for r in rows)
