"""The port's serving observability (``obs/metrics.py``, ``obs/trace.py``,
``resil/flight.py``, the batcher's breaker and watchdog, the HTTP entry's
``/metrics`` and ``/healthz``) against the JAX package's, which is the
oracle: the same metric updates render the same Prometheus text, the
port's flight dumps pass JAX's validator (byte for byte the JAX dump of the
same schedule), batcher spans descend from the submitting request, and the
same submissions and fault plan through both batchers (an injected clock,
``pump()``) give the same statuses, tiers and breaker transitions.

The engines here are stand-ins with the batcher's engine surface
(``render_flat`` calling its package's ``serve.dispatch`` fault point);
the real engine's dispatch path is held by tests/test_torch_serve.py and,
on the card, by chip_smoke.py's ops phase."""

import json
import os
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import nerf_replication_tpu.resil as jres
from nerf_replication_tpu.obs import emit as jax_emit
from nerf_replication_tpu.obs import metrics as jax_metrics
from nerf_replication_tpu.obs import trace as jax_trace
from nerf_replication_tpu.resil.flight import (
    validate_flight_dump as jax_validate_flight_dump,
)
from nerf_replication_tpu_torch import resil as pres
from nerf_replication_tpu_torch.obs import emit as port_emit
from nerf_replication_tpu_torch.obs import metrics as port_metrics
from nerf_replication_tpu_torch.obs import trace as port_trace
from nerf_replication_tpu_torch.obs.schema import validate_row


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class FakeEngine:
    """The batcher's engine surface on the host: ``render_flat`` passes the
    package's ``serve.dispatch`` fault point and scales the rays."""

    def __init__(self, resil_mod):
        self.resil = resil_mod
        self.options = SimpleNamespace(
            max_batch_rays=64, max_delay_s=0.0, request_timeout_s=5.0,
            shed_queue_depths=[4, 8, 16, 32])
        self.near, self.far = 2.0, 6.0
        self.n_requests = 0
        self.default_camera = {"H": 4, "W": 4, "focal": 5.0}

    def render_flat(self, flat, family):
        self.resil.fault_point("serve.dispatch")
        return {"rgb_map_f": flat[:, :3] * 0.5}, {
            "occupancy": flat.shape[0] / 64, "bucket_rays": 64}

    def render_view(self, c2w, H, W, focal, via=None):
        out = via(_rays(H * W), self.near, self.far)
        img = np.clip(out["rgb_map_f"] * 255, 0, 255).astype(np.uint8)
        return img.reshape(H, W, 3), {"tier": out["tier"],
                                      "cache_hit": False}

    def stats(self):
        return {"n_requests": self.n_requests}


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    d = np.array([0.0, 0.0, -1.0]) + rng.normal(0, 0.1, (n, 3))
    return np.concatenate([np.tile([0.0, 0.0, 4.0], (n, 1)), d],
                          -1).astype(np.float32)


def _strip(rows):
    return [{k: v for k, v in r.items() if k not in ("t", "wall_s")}
            for r in rows]


def _read(path, kind=None):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        assert validate_row(r) == [], r
    return [r for r in rows if kind is None or r["kind"] == kind]


@pytest.fixture
def telem(tmp_path, monkeypatch):
    """Both packages' emitters at scratch files, fresh metrics and
    disabled tracers (everything restored after): ``(port, jax)``."""
    paths = (str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl"))
    ems = (port_emit.Emitter(paths[0]), jax_emit.Emitter(paths[1]))
    monkeypatch.setattr(port_emit, "_active", ems[0])
    monkeypatch.setattr(jax_emit, "_active", ems[1])
    for mod in (port_metrics, jax_metrics):
        monkeypatch.setattr(mod, "_registry", mod.MetricsRegistry())
    for mod in (port_trace, jax_trace):
        monkeypatch.setattr(mod, "_tracer", mod.Tracer(enabled=False))
    yield paths
    for em in ems:
        em.close()


def _update(reg):
    reg.counter("serve_requests_total", status="ok", tier="full")
    reg.counter("serve_requests_total", 2.0, status="error", tier="bf16")
    reg.gauge("serve_queue_depth", 3)
    for v in (0.004, 0.03, 0.2, 1.7, 12.0):
        reg.observe("serve_request_latency_seconds", v, tier="full")
    reg.observe("serve_stage_seconds", 0.01, stage="queue")


def test_prometheus_text_and_slo_view_equal_jax():
    clock = FakeClock()
    port = port_metrics.MetricsRegistry(clock=clock)
    jax = jax_metrics.MetricsRegistry(clock=clock)
    _update(port)
    _update(jax)
    text = port.render_prometheus()
    assert text == jax.render_prometheus()
    for line in text.splitlines():  # parses as exposition text
        assert line.startswith("#") or len(line.rsplit(" ", 1)) == 2, line
    assert port.slo_view(0.1) == jax.slo_view(0.1)
    assert port.snapshot() == jax.snapshot()


def _flight_schedule(resil_mod, trace_mod, out_dir):
    clock = FakeClock(1000.0)
    trs = trace_mod.configure_tracing(enabled=True, clock=clock)
    rec = resil_mod.FlightRecorder(out_dir, capacity=8, clock=clock)
    resil_mod.install_flight_recorder(rec)
    try:
        with trs.span("serve.request"):
            clock.advance(0.01)
            with trs.span("serve.batch", tier="full", n_rays=16):
                clock.advance(0.02)
        resil_mod.note_flight(point="serve.dispatch", fault="io_error",
                              injected=True)
        path = resil_mod.dump_flight("breaker_open", detail="probe")
    finally:
        resil_mod.uninstall_flight_recorder()
        trace_mod.configure_tracing(enabled=False)
    with open(path) as f:
        return path, json.load(f)


def test_flight_dump_passes_jax_validation(tmp_path, telem):
    path, dump = _flight_schedule(pres, port_trace, str(tmp_path / "p"))
    assert os.path.basename(path) == "flight_breaker_open.json"
    assert jax_validate_flight_dump(dump) == []
    assert pres.validate_flight_dump(dump) == []
    _, jdump = _flight_schedule(jres, jax_trace, str(tmp_path / "j"))
    assert dump == jdump
    assert [s["name"] for s in dump["spans"]] == ["serve.batch",
                                                  "serve.request"]


def test_trace_header_roundtrips_across_packages():
    ctx = port_trace.SpanContext("0af7651916cd43dd", "b7ad6b71")
    (name, value), = port_trace.trace_headers(ctx).items()
    assert name == jax_trace.TRACE_HEADER == port_trace.TRACE_HEADER
    back = jax_trace.SpanContext.from_header(value)
    assert (back.trace_id, back.span_id) == (ctx.trace_id, ctx.span_id)
    assert port_trace.SpanContext.from_header(
        jax_trace.trace_headers(back)[name]).to_header() == value


def test_batcher_spans_descend_from_the_submitting_request(telem):
    from nerf_replication_tpu_torch.serve import MicroBatcher

    trs = port_trace.configure_tracing(enabled=True, clock=FakeClock())
    batcher = MicroBatcher(FakeEngine(pres), start=False, clock=FakeClock())
    with trs.span("serve.request") as root:
        fut = batcher.submit(_rays(8), 2.0, 6.0)
    other = batcher.submit(_rays(8, 1), 2.0, 6.0)  # no request span
    assert batcher.pump() == 2
    assert fut.result(1.0)["tier"] == "full" and other.done()
    spans = _read(telem[0], "span")
    mine = [s for s in spans if s["trace_id"] == root.context.trace_id]
    by_id = {s["span_id"]: s for s in spans}
    assert {s["name"] for s in mine} == {
        "serve.request", "serve.queue", "serve.batch", "serve.render",
        "serve.scatter", "serve.handoff"}
    for s in mine:
        if s["name"] != "serve.request":  # each chain ends at the root
            p = s
            while p.get("parent_id"):
                p = by_id[p["parent_id"]]
            assert p["span_id"] == root.context.span_id, s
    req = _read(telem[0], "serve_request")
    assert [r["status"] for r in req] == ["ok", "ok"]


def _drive(batcher_cls, resil_mod, engine):
    """Submissions under a dispatch fault plan: per request the status
    (``ok`` + tier, ``error``, or ``rejected`` by the open breaker)."""
    clock = FakeClock()
    breaker = resil_mod.CircuitBreaker(threshold=2, cooldown_s=1.0,
                                       clock=clock)
    batcher = batcher_cls(engine, start=False, clock=clock, breaker=breaker)
    plan = resil_mod.FaultPlan(seed=3).add("serve.dispatch", "io_error",
                                           after=1, times=3)
    seen = []
    with resil_mod.injecting(plan):
        for i in range(8):
            if i in (4, 6):
                clock.advance(1.5)  # past the cooldown: half open
            try:
                fut = batcher.submit(_rays(4 + i, i), 2.0, 6.0)
            except resil_mod.BreakerOpenError:
                seen.append(("rejected", breaker.state))
                continue
            batcher.pump()
            try:
                seen.append(("ok", fut.result(1.0)["tier"], breaker.state))
            except OSError:
                seen.append(("error", breaker.state))
    return seen, batcher.stats()["breaker"]


def test_batchers_match_jax_under_a_fault_plan(telem):
    from nerf_replication_tpu.serve import MicroBatcher as JaxBatcher
    from nerf_replication_tpu_torch.serve import MicroBatcher

    port = _drive(MicroBatcher, pres, FakeEngine(pres))
    jax = _drive(JaxBatcher, jres, FakeEngine(jres))
    assert port == jax
    assert [s[0] for s in port[0]] == ["ok", "error", "error", "rejected",
                                       "error", "rejected", "ok", "ok"]
    p_rows, j_rows = (_strip(_read(p, "breaker")) for p in telem)
    assert [r["state"] for r in p_rows] == ["open", "half_open", "open",
                                            "half_open", "closed"]
    assert p_rows == j_rows
    keep = ("status", "tier", "n_rays")
    p_req, j_req = ([{k: r[k] for k in keep} for r in _read(p, "serve_request")]
                    for p in telem)
    assert p_req == j_req


def test_breaker_opening_dumps_the_flight_recorder(tmp_path, telem):
    from nerf_replication_tpu_torch.serve import MicroBatcher

    pres.install_flight_recorder(pres.FlightRecorder(str(tmp_path)))
    try:
        clock = FakeClock()
        batcher = MicroBatcher(
            FakeEngine(pres), start=False, clock=clock,
            breaker=pres.CircuitBreaker(threshold=2, cooldown_s=1.0,
                                        clock=clock))
        with pres.injecting(pres.FaultPlan().add(
                "serve.dispatch", "io_error", times=2)):
            for _ in range(2):
                fut = batcher.submit(_rays(8), 2.0, 6.0)
                batcher.pump()
                with pytest.raises(OSError):
                    fut.result(1.0)
        assert batcher.breaker.state == "open"
    finally:
        pres.uninstall_flight_recorder()
    with open(tmp_path / "flight_breaker_open.json") as f:
        dump = json.load(f)
    assert jax_validate_flight_dump(dump) == []
    # the dump is taken as the breaker opens, before the batch reports
    assert [e["fault"] for e in dump["events"]] == ["io_error", "error",
                                                    "io_error"]


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_watchdog_restarts_a_dead_worker(telem):
    """A kill at ``serve.flush`` dies with the worker thread; its in-flight
    request fails at once, and the next submit restarts the worker."""
    from nerf_replication_tpu_torch.serve import MicroBatcher

    batcher = MicroBatcher(FakeEngine(pres))
    try:
        batcher.submit(_rays(8), 2.0, 6.0).result(timeout=5.0)
        with pres.injecting(pres.FaultPlan().add("serve.flush", "kill")):
            fut = batcher.submit(_rays(8), 2.0, 6.0)
            with pytest.raises(RuntimeError, match="crashed mid-batch"):
                fut.result(timeout=5.0)
        out = batcher.submit(_rays(8), 2.0, 6.0).result(timeout=5.0)
        assert out["rgb_map_f"].shape == (8, 3)
        assert batcher.worker_restarts == 1
        health = batcher.health()
        assert health["ok"] and health["worker_alive"]
    finally:
        batcher.close(drain=False)
    kinds = {(r["point"], r["fault"]) for r in _read(telem[0], "fault")}
    assert {("serve.flush", "kill"), ("serve.flush", "crash")} <= kinds


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.headers, r.read()


def test_http_metrics_healthz_slo_and_breaker_503(telem):
    from nerf_replication_tpu_torch.serve import MicroBatcher
    from nerf_replication_tpu_torch.serve.__main__ import make_server

    port_trace.configure_tracing(enabled=True)
    engine = FakeEngine(pres)
    breaker = pres.CircuitBreaker(threshold=1, cooldown_s=60.0)
    batcher = MicroBatcher(engine, breaker=breaker)
    server = make_server(engine, batcher, port=0, slo_target_ms=50.0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        req = urllib.request.Request(
            base + "/render", data=json.dumps({"theta": 30}).encode(),
            method="POST", headers=port_trace.trace_headers(
                port_trace.SpanContext("00000000000000aa", "000000bb")))
        with urllib.request.urlopen(req, timeout=30) as r:
            body = json.loads(r.read())
        assert (body["h"], body["w"], body["tier"]) == (4, 4, "full")
        status, headers, data = _get(base + "/metrics")
        assert status == 200 and "text/plain" in headers["Content-Type"]
        text = data.decode()
        assert 'serve_requests_total{status="ok",tier="full"} 1' in text
        assert "serve_request_latency_seconds_bucket" in text
        status, _, data = _get(base + "/healthz")
        health = json.loads(data)
        assert status == 200 and health["ok"]
        assert health["slo"]["target_ms"] == 50.0
        assert health["slo"]["requests"] == 1
        with pres.injecting(pres.FaultPlan().add("serve.dispatch",
                                                 "io_error")):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 500  # the failed dispatch opens it
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 503 and err.value.headers["Retry-After"]
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(base + "/healthz")
        assert err.value.code == 503
        assert json.loads(err.value.read())["breaker"]["state"] == "open"
    finally:
        server.shutdown()
        server.server_close()
        batcher.close(drain=False)
    roots = [s for s in _read(telem[0], "span")
             if s["name"] == "serve.request"]
    assert roots and all(s["trace_id"] == "00000000000000aa"
                         and s["parent_id"] == "000000bb" for s in roots)
