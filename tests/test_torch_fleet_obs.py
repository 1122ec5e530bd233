"""Port parity of fleet observability (``scale/fleet_metrics.py``): the
Prometheus merge, the fleet aggregator (dead-replica skips, shared
registry dedup, SLO view, window deltas, exemplars, capacity view), the
fleet server, evidence-linked scale decisions — each scenario of the JAX
package's ``tests/test_fleet_obs.py`` on the JAX classes and on the
port's, outputs ``==`` — and one REAL two-process run: a child running
the port's own ``make_server`` over a fake engine takes one request
routed by the port's ``Router.render`` with tracing on; its spans parent
under the router's dispatch span (one request, one trace, two processes)
with zero orphans and >= 95% of the routed wall time covered.
"""

import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from _torch_ops_pair import FakeClock, run_both, strip

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROM_A = """\
# TYPE serve_request_latency_seconds histogram
serve_request_latency_seconds_bucket{le="0.1"} 8
serve_request_latency_seconds_bucket{le="0.25"} 8
serve_request_latency_seconds_bucket{le="1"} 10 # {trace_id="slowA1"} 0.7
serve_request_latency_seconds_bucket{le="+Inf"} 10
serve_request_latency_seconds_sum 2.4
serve_request_latency_seconds_count 10
# TYPE serve_requests_total counter
serve_requests_total{status="ok"} 10
# TYPE scale_router_dispatch_total counter
scale_router_dispatch_total{replica="r1"} 3
# TYPE capacity_scene_requests_per_s gauge
capacity_scene_requests_per_s{scene="lego"} 1.5
capacity_scene_rays_per_s{scene="lego"} 6000.0
capacity_scene_cold_loads{scene="lego"} 1
capacity_hbm_bytes 4096
capacity_device_share{family="full"} 1.0
"""

_PROM_B = """\
# TYPE serve_request_latency_seconds histogram
serve_request_latency_seconds_bucket{le="0.1"} 5
serve_request_latency_seconds_bucket{le="0.25"} 5
serve_request_latency_seconds_bucket{le="1"} 5
serve_request_latency_seconds_bucket{le="+Inf"} 5
serve_request_latency_seconds_sum 0.2
serve_request_latency_seconds_count 5
# TYPE serve_requests_total counter
serve_requests_total{status="ok"} 5
# TYPE tenant_admits_total counter
tenant_admits_total{decision="admit",tenant="a"} 8
tenant_admits_total{decision="deny",tenant="b"} 2
# TYPE capacity_scene_requests_per_s gauge
capacity_scene_requests_per_s{scene="ship"} 0.25
"""


class _ScrapeReplica:
    """Replica double wearing only the fleet-metrics surface."""

    def __init__(self, side, replica_id, text, state=None, source_id=None,
                 load=0):
        self.side = side
        self.replica_id = replica_id
        self.text = text
        self.state = state or side.scale.ReplicaState.READY
        self._source_id = source_id or replica_id
        self._load = load

    def accepting(self):
        return self.state == self.side.scale.ReplicaState.READY

    def metrics_source_id(self):
        return self._source_id

    def scrape_metrics(self):
        if isinstance(self.text, Exception):
            raise self.text
        return self.text

    def load(self):
        return self._load

    def heartbeat(self):
        return {"replica": self.replica_id, "state": self.state,
                "ok": True, "load": self._load, "scenes": []}

    def drain(self, timeout_s=60.0):
        self.state = self.side.scale.ReplicaState.RETIRED
        return 0


def test_merge_scrapes_matches_jax():
    def scenario(side):
        fm = side.fleet_metrics
        return {
            "relabel": [fm.relabel_sample(line, rid) for line, rid in (
                ('serve_requests_total{status="ok"} 10', "rep0"),
                ('scale_router_dispatch_total{replica="r1"} 3', "router"),
                ('x_bucket{le="1"} 2 # {trace_id="t9"} 0.7', "rep1"),
                ("# HELP not a sample", "rep2"))],
            "merged": fm.merge_scrapes({"rep0": _PROM_A, "rep1": _PROM_B}),
            "labels": fm.parse_labels('a="1",b="x y"'),
        }

    ref, out = run_both(scenario)
    assert out == ref
    merged = out["merged"]
    assert merged.count("# TYPE serve_requests_total counter") == 1
    assert 'serve_requests_total{replica="rep1",status="ok"} 5' in merged
    assert '# {trace_id="slowA1"} 0.7' in merged
    assert 'exported_replica="r1"' in out["relabel"][1]


def _agg_skips(side):
    router = side.scale.Router()
    st = side.scale.ReplicaState
    router.register(_ScrapeReplica(side, "rep0", _PROM_A))
    router.register(_ScrapeReplica(side, "rep1", _PROM_B, state=st.DEAD))
    router.register(_ScrapeReplica(side, "rep2", _PROM_B, state=st.RETIRED))
    router.register(_ScrapeReplica(side, "rep3",
                                   RuntimeError("conn refused")))
    router.register(_ScrapeReplica(side, "rep4", _PROM_B,
                                   source_id="process"))
    router.register(_ScrapeReplica(side, "rep5", _PROM_B,
                                   source_id="process"))
    agg = side.scale.FleetMetricsAggregator(router, slo_target_s=0.25)
    return {"scrapes": sorted(agg.scrape()), "skipped": agg.skipped,
            "stats": agg.stats(), "slo": agg.slo_view(),
            "capacity": agg.capacity_view()}


def _agg_windows(side):
    router = side.scale.Router()
    rep = _ScrapeReplica(side, "rep0", _PROM_A)
    router.register(rep)
    agg = side.scale.FleetMetricsAggregator(router, slo_target_s=0.25)
    views = [agg.slo_view(), agg.window()]
    rep.text = _PROM_A.replace(
        'le="0.1"} 8', 'le="0.1"} 18').replace(
        'le="0.25"} 8', 'le="0.25"} 18').replace(
        'le="1"} 10', 'le="1"} 20').replace(
        'le="+Inf"} 10', 'le="+Inf"} 20').replace(
        '_count 10', '_count 20').replace(
        'serve_requests_total{status="ok"} 10',
        'serve_requests_total{status="ok"} 20')
    views.append(agg.window())
    return {"views": views}


def _agg_exemplars(side):
    router = side.scale.Router()
    router.register(_ScrapeReplica(side, "rep0", _PROM_A))
    agg = side.scale.FleetMetricsAggregator(router, slo_target_s=0.25)
    agg.scrape()
    mx = side.obs.get_metrics()
    mx.observe("serve_request_latency_seconds", 0.01, trace_id="fast1")
    mx.observe("serve_request_latency_seconds", 0.6, trace_id="slow1")
    mx.observe("serve_request_latency_seconds", 1.8, trace_id="slow2")
    mx.observe("serve_request_latency_seconds", 0.02)
    return {"agg": [agg.slo_miss_exemplars(0.25), agg.slo_miss_exemplars(),
                    agg.slo_miss_exemplars(5.0)],
            "registry": [mx.slo_miss_exemplars(0.25),
                         mx.slo_miss_exemplars(100.0)],
            "text": mx.render_prometheus()}


AGG_SCRIPTS = {"skips": _agg_skips, "windows": _agg_windows,
               "exemplars": _agg_exemplars}


@pytest.mark.parametrize("script", list(AGG_SCRIPTS))
def test_aggregator_matches_jax(script):
    ref, out = run_both(AGG_SCRIPTS[script])
    assert out == ref
    if script == "skips":
        assert out["scrapes"] == ["process", "rep0"]
        assert out["capacity"]["replicas"]["rep0"]["scenes"]["lego"] == {
            "requests_per_s": 1.5, "rays_per_s": 6000.0, "cold_loads": 1}
    if script == "windows":
        assert [v["attainment"] for v in out["views"]] == [0.8, 0.8, 1.0]
    if script == "exemplars":
        assert out["agg"] == [["slowA1"], ["slowA1"], []]


def test_fleet_server_matches_jax():
    """``GET /fleet/metrics``, ``/fleet/slo``, ``/fleet/capacity`` and a
    404 from each side's own fleet server, over the same replicas."""
    def scenario(side):
        router = side.scale.Router()
        router.register(_ScrapeReplica(side, "rep0", _PROM_A))
        router.register(_ScrapeReplica(side, "rep1", _PROM_B))
        agg = side.scale.FleetMetricsAggregator(router, slo_target_s=0.25)
        server = side.scale.make_fleet_server(agg, port=0)
        port = server.server_address[1]
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        out = {}
        try:
            for path in ("/fleet/metrics", "/fleet/slo", "/fleet/capacity",
                         "/fleet/nope"):
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}{path}",
                            timeout=10) as r:
                        out[path] = (r.status, r.read().decode())
                except urllib.error.HTTPError as err:
                    out[path] = (err.code, err.read().decode())
        finally:
            server.shutdown()
            server.server_close()
        out["scrapes_total"] = side.obs.get_metrics().snapshot()
        return out

    ref, out = run_both(scenario)
    assert out == ref
    assert out["/fleet/nope"][0] == 404
    body = out["/fleet/metrics"][1]
    assert 'replica="rep0"' in body and 'replica="rep1"' in body
    assert json.loads(out["/fleet/slo"][1])["deny_rate"] == 0.2


def _evidence(side, tmp):
    router = side.scale.Router()
    router.register(_ScrapeReplica(side, "rep0", _PROM_A, load=3))
    agg = side.scale.FleetMetricsAggregator(router, slo_target_s=0.25)
    spawned = []

    def spawn(i):
        r = _ScrapeReplica(side, f"fresh{i}", _PROM_B)
        spawned.append(r)
        return r

    opts = side.scale.ScaleOptions(min_replicas=1, max_replicas=3,
                                   out_below=0.9, out_windows=1,
                                   cooldown_out_s=0.0)
    alerts = side.obs.AlertEngine(side.obs.AlertOptions(
        fast_short_s=60.0, fast_long_s=600.0, slow_short_s=120.0,
        slow_long_s=1200.0), clock=FakeClock(100.0))
    sup = side.scale.Supervisor(router, spawn, options=opts,
                                evidence_source=agg, slo_target_s=0.25,
                                alerts=alerts)
    side.resil.install_flight_recorder(
        side.resil.FlightRecorder(tmp, capacity=64))
    router.sweep()
    action = sup.step_from_fleet(agg)
    with open(os.path.join(tmp, "flight_scale_out.json")) as fh:
        detail = json.load(fh)["detail"]
    wedged_router = side.scale.Router()
    wedged_router.register(_ScrapeReplica(side, "w0", "", load=9))
    wedged_agg = side.scale.FleetMetricsAggregator(wedged_router)
    wedged = side.scale.Supervisor(
        wedged_router, lambda i: _ScrapeReplica(side, f"f{i}", ""),
        options=opts, evidence_source=wedged_agg)
    wedged_router.sweep()
    return {"action": action, "spawned": [r.replica_id for r in spawned],
            "decisions": sup.decisions, "detail": detail,
            "alerts": alerts.transitions,
            "wedged": wedged.step_from_fleet(wedged_agg),
            "rows": strip(r for r in side.rows
                          if r["kind"] in ("scale_decision", "replica",
                                           "alert")),
            "invalid": [side.obs.validate_row(r) for r in side.rows
                        if side.obs.validate_row(r)]}


def test_supervisor_fleet_evidence_matches_jax(tmp_path):
    """A fleet-fed step links its decision to the window's evidence
    (attainment series, queue depths, exemplar trace ids), dumps
    ``flight_scale_out.json`` naming it, feeds the alert engine the same
    window, and a wedged fleet (nothing completing, deep queues) scales
    out, not in."""
    dirs = iter([str(tmp_path / "jax"), str(tmp_path / "port")])
    ref, out = run_both(lambda side: _evidence(side, next(dirs)))
    assert out == ref
    assert out["invalid"] == []
    assert out["action"] == "out" and out["wedged"] == "out"
    ev = out["decisions"][-1]["evidence"]
    assert ev["exemplar_trace_ids"] == ["slowA1"]
    assert ev["queue_depths"] == {"rep0": 3}
    assert "slowA1" in out["detail"]


# -- the two-process propagation test ----------------------------------------

# A port-server-shaped child: the port's REAL make_server/render_pose HTTP
# stack over a fake engine whose render emits dispatch/device stage spans
# around sleeps.
_SERVE_CHILD = """\
import json, os, sys, time

repo_dir, telem_path = sys.argv[1:3]
sys.path.insert(0, repo_dir)

import numpy as np

from nerf_replication_tpu_torch.obs import configure_tracing, get_tracer
from nerf_replication_tpu_torch.obs import emit as emit_mod

emit_mod._active = emit_mod.Emitter(telem_path, chief=True)
configure_tracing(enabled=True,
                  id_prefix=os.environ.get("SCALE_REPLICA_ID", ""))

from nerf_replication_tpu_torch.serve import __main__ as serve_cli


class Options:
    request_timeout_s = 5.0


class Engine:
    default_camera = {"H": 8, "W": 8, "focal": 10.0}
    options = Options()

    def stats(self):
        return {"warm_source": "disk", "total_compiles": 0}

    def render_view(self, c2w, H, W, focal, via=None, scene=None):
        trs = get_tracer()
        with trs.span("serve.dispatch", stage="dispatch"):
            time.sleep(0.4)
        with trs.span("serve.device", stage="device"):
            time.sleep(0.4)
        return np.zeros((H, W, 3), np.uint8), {"tier": "full",
                                               "cache_hit": False}


serve_cli._resolve_pose({"theta": 0.0})  # imports paid before the timed path
server = serve_cli.make_server(Engine(), None, port=0, slo_target_ms=100.0)
print(json.dumps({"port": server.server_address[1]}), flush=True)
server.serve_forever()
"""

_BUDGET_S = 60.0  # this test's own time limit


def _read_child_port(proc, timeout_s):
    out = {}

    def read():
        out["line"] = proc.stdout.readline()

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    return out.get("line", "")


def _load_spans(path):
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [r for r in rows if r.get("kind") == "span"], rows


def test_two_process_trace_spans_router_and_port_child(tmp_path,
                                                       monkeypatch):
    from nerf_replication_tpu_torch.obs import (
        configure_tracing,
        reset_metrics,
        validate_row,
    )
    from nerf_replication_tpu_torch.obs import emit as emit_mod
    from nerf_replication_tpu_torch.scale import (
        FleetMetricsAggregator,
        ProcessReplica,
        ReplicaState,
        Router,
    )

    t_start = time.monotonic()
    router_telem = str(tmp_path / "router" / "telemetry.jsonl")
    em = emit_mod.Emitter(router_telem, chief=True)
    monkeypatch.setattr(emit_mod, "_active", em)
    reset_metrics()
    configure_tracing(enabled=True, id_prefix="router")
    child_telem = str(tmp_path / "rep0" / "telemetry.jsonl")
    os.makedirs(os.path.dirname(child_telem), exist_ok=True)
    env = dict(os.environ, SCALE_REPLICA_ID="rep0")
    err_path = tmp_path / "child_stderr.txt"
    with open(err_path, "w") as errf:
        proc = subprocess.Popen(
            [sys.executable, "-c", _SERVE_CHILD, _REPO, child_telem],
            stdout=subprocess.PIPE, stderr=errf, text=True, env=env,
            cwd=_REPO)
    try:
        line = _read_child_port(proc, _BUDGET_S / 2)
        assert line, ("child never reported a port; stderr:\n"
                      + err_path.read_text()[-2000:])
        rep = ProcessReplica("rep0", cfg_file="unused.yaml",
                             host="127.0.0.1", port=json.loads(line)["port"])
        rep.proc = proc
        router = Router(heartbeat_timeout_s=30.0)
        router.register(rep)
        router.sweep()
        assert rep.state == ReplicaState.READY
        out = router.render({"theta": 40.0, "phi": -30.0, "radius": 4.0,
                             "H": 8, "W": 8, "focal": 10.0}, timeout_s=20.0)
        assert out["h"] == 8 and out["tier"] == "full"
        beat = rep.heartbeat()
        assert beat["trace"]["enabled"] is True
        assert beat["trace"]["remote_parented"] >= 1
        assert beat["trace"]["spans"] >= 3
        assert beat["total_compiles"] == 0
        merged = FleetMetricsAggregator(router, slo_target_s=0.25).render()
        assert 'replica="rep0"' in merged
        assert "serve_stage_seconds" in merged
        assert router.drain("rep0", timeout_s=20.0) == 0
        assert rep.state == ReplicaState.RETIRED
        proc.wait(timeout=15)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        configure_tracing(enabled=False)
        reset_metrics()
    em.close()

    router_spans, router_rows = _load_spans(router_telem)
    child_spans, child_rows = _load_spans(child_telem)
    submits = [s for s in router_spans if s["name"] == "route.submit"]
    dispatches = [s for s in router_spans if s["name"] == "route.dispatch"]
    requests = [s for s in child_spans if s["name"] == "serve.request"]
    assert len(submits) == len(dispatches) == len(requests) == 1
    submit, dispatch, request = submits[0], dispatches[0], requests[0]
    assert request["remote_parent"] is True
    assert request["parent_id"] == dispatch["span_id"]
    assert request["trace_id"] == submit["trace_id"]
    assert dispatch["parent_id"] == submit["span_id"]
    assert request["span_id"].startswith("rep0")
    assert submit["span_id"].startswith("router")
    stages = {s["name"]: s for s in child_spans
              if s["name"] in ("serve.dispatch", "serve.device")}
    assert set(stages) == {"serve.dispatch", "serve.device"}
    for s in stages.values():
        assert s["parent_id"] == request["span_id"]
    assert sum(s["dur_s"] for s in stages.values()) >= 0.95 * request["dur_s"]
    assert dispatch["dur_s"] >= 0.95 * submit["dur_s"]
    for row in router_rows + child_rows:
        assert validate_row(row) == [], row
    # the JAX package's fleet trace merge reads the port's telemetry: zero
    # orphans, every remote parent resolved
    spec = importlib.util.spec_from_file_location(
        "trace_view", os.path.join(_REPO, "scripts", "trace_view.py"))
    tv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tv)
    _doc, stats = tv.merge_fleet([router_telem, child_telem])
    assert stats["orphans"] == 0
    assert stats["remote_resolved"] == stats["remote_parented"] >= 1
    assert stats["duplicate_span_ids"] == []
    assert time.monotonic() - t_start < _BUDGET_S
