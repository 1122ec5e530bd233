"""HTTP render serving over the port's engine and micro-batcher.

    python -m nerf_replication_tpu_torch.serve --cfg_file configs/nerf/lego.yaml \\
        --device cuda task_arg.march_coarse_block 8 task_arg.march_fused full
    curl -s localhost:8008/render -d '{"theta": 40, "phi": -30, "radius": 4}'
    curl -s localhost:8008/stats

The port of ``serve.py``'s request surface (all JSON):

* ``POST /render`` — a spherical pose (``theta``/``phi``/``radius``) OR a
  ``c2w`` 3x4/4x4 matrix; optional ``H``/``W``/``focal`` override the test
  camera; optional ``scene`` (a fleet scene id) and ``tenant`` (the QoS
  tenant, ``fleet.qos``). Reply ``{h, w, tier, cache_hit, latency_ms,
  rgb_b64[, scene]}``, where ``rgb_b64`` is the base64 of the raw uint8
  [h, w, 3] buffer. A bad pose or out-of-bounds request → 400, an unknown
  scene → 404, an over-quota tenant → 429 with ``Retry-After``, a torn,
  unloadable or over-budget scene → 503 for that scene only, a render
  timeout → 504, anything else → 500.
* ``GET /stats`` — engine counters (with the ``march`` block and kernel
  launch counts) plus the batcher's.
* ``GET /healthz`` — the batcher's health (queue depth, last-dispatch age,
  breaker state, worker liveness) plus the ``slo`` block: latency
  attainment against ``obs.slo_target_ms`` and the shed / timeout / error
  / breaker rates of the live metrics (over the last
  ``obs.alerts.view_window_s`` when the alerts are on, else the whole
  lifetime), the ``alerts`` block (the firing alerts, when on), and the
  ``replica`` block that ``scale/replica.py``'s heartbeat reads: ``id``
  (``SCALE_REPLICA_ID``), the warm source, the captures,
  ``total_compiles``, the resident and staged scenes, the residency byte
  watermarks and budgets, ``param_shards``, and ``trace`` (spans emitted,
  sink drops, spans parented to a propagated context). 200 while
  healthy, 503 while the breaker is open or after a drain.
* ``GET /alerts`` — the alert engine's status (``obs/alerts.py``: every
  alert's state, burn rates and value, the firing set, the seconds each
  has fired); ``{"enabled": false, ...}`` with ``obs.alerts.enabled``
  off.
* ``POST /drain`` — drain-before-retire: stop admitting, render everything
  queued, reply ``{drained, n_failed}`` under a ``serve.drain`` span
  parented to the ``Traceparent`` header. The process keeps running
  (retirement is the caller's: SIGTERM); ``/render`` answers 503 from
  then on.
* ``GET /metrics`` — Prometheus text of the live counters, gauges and
  histograms (``obs/metrics.py``).

``total_compiles`` is the port's counterpart of the JAX engine's compile
count: the kernel libraries this process built with ``nvcc`` plus the
CUDA-graph captures after warm-up (``RenderEngine.total_compiles``). A
child that warmed from the kernel-library store (``compile/artifacts.py``)
reports 0. The server binds only after the engine's warm-up and captures,
so a child that answers ``/healthz`` is warm.

With ``obs.alerts.enabled`` (the default) the main loop runs the ops
layer every half second: the burn-rate alert engine evaluates, the
incident correlator (alert fires and flight dumps open incidents,
``incident_<id>.json`` in the flight dir) sweeps, and the capacity ledger
commits a ``capacity_snapshot`` row every ``obs.alerts.capacity_every_s``
(and once more on exit).

A breaker that is open answers ``/render`` with 503 and ``Retry-After``.
Each request runs under a root span (``serve.request``) parented to the
``Traceparent`` header when the caller sends one (``obs.trace``); with
``obs.trace`` on, spans land in ``<record_dir>/telemetry.jsonl`` and the
flight recorder rings them. SIGTERM dumps ``flight_sigterm.json`` into
``obs.flight_dir`` (default ``record_dir``), drains the batcher and exits 0.

``--port 0`` binds an ephemeral port; the first line printed names it.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def _resolve_pose(body: dict):
    """c2w matrix from a request body (spherical pose or explicit matrix)."""
    import numpy as np

    from ..datasets.rays import pose_spherical

    if "c2w" in body:
        c2w = np.asarray(body["c2w"], np.float32)
        if c2w.shape not in ((3, 4), (4, 4)):
            raise ValueError(f"c2w must be 3x4 or 4x4, got {c2w.shape}")
        return c2w
    try:
        return pose_spherical(
            float(body["theta"]), float(body.get("phi", -30.0)),
            float(body.get("radius", 4.0)),
        )
    except KeyError:
        raise ValueError(
            "request must carry either 'c2w' or a spherical pose "
            "('theta' [, 'phi', 'radius'])"
        ) from None


def render_pose(engine, batcher, body: dict) -> dict:
    """One request: pose -> cached or batch-rendered image -> JSON fields."""
    camera = dict(engine.default_camera or {"H": 400, "W": 400, "focal": 555.0})
    H = int(body.get("H", camera["H"]))
    W = int(body.get("W", camera["W"]))
    focal = float(body.get("focal", camera["focal"]))
    scene = body.get("scene")
    scene = None if scene is None else str(scene)
    tenant = body.get("tenant")
    tenant = None if tenant is None else str(tenant)
    c2w = _resolve_pose(body)
    timeout = engine.options.request_timeout_s + 30.0
    via = None
    if batcher is not None:
        def via(rays, near, far):
            return batcher.submit(rays, near, far, scene=scene,
                                  tenant=tenant).result(timeout)
    t0 = time.perf_counter()
    # a scene-less request makes the pre-fleet call (engine doubles too)
    kw = {} if scene is None else {"scene": scene}
    image, info = engine.render_view(c2w, H, W, focal, via=via, **kw)
    out = {
        "h": H,
        "w": W,
        "tier": info["tier"],
        "cache_hit": bool(info["cache_hit"]),
        "latency_ms": (time.perf_counter() - t0) * 1e3,
        "rgb_b64": base64.b64encode(image.tobytes()).decode("ascii"),
    }
    if scene is not None:
        out["scene"] = scene
    return out


def replica_block(engine) -> dict:
    """The ``/healthz`` replica block: the warm state, resident and staged
    scenes, the residency watermarks and budgets, and tracing health."""
    from ..obs import get_tracer

    stats = engine.stats()
    fs = stats.get("fleet") or {}
    trs = get_tracer().stats()
    return {
        "id": os.environ.get("SCALE_REPLICA_ID", ""),
        "warm_source": stats.get("warm_source"),
        "captures": stats.get("captures", 0),
        "total_compiles": int(stats.get("total_compiles", 0)),
        "scenes": (engine.resident_scenes()
                   if hasattr(engine, "resident_scenes") else []),
        "staging": list(fs.get("staging", [])),
        "hbm_bytes": int(fs.get("resident_bytes", 0)),
        "staging_bytes": int(fs.get("staging_bytes", 0)),
        "hbm_budget_bytes": int(fs.get("budget_bytes", 0)),
        "staging_budget_bytes": int(fs.get("staging_budget_bytes", 0)),
        "param_shards": int(fs.get("param_shards", 1)),
        "trace": {
            "enabled": trs["enabled"],
            "spans": trs["spans"],
            "dropped_sink": trs["dropped_sink"],
            "remote_parented": trs["remote_parented"],
        },
    }


def make_server(engine, batcher, host: str = "127.0.0.1",
                port: int = 8008,
                slo_target_ms: float = 100.0,
                alerts=None,
                slo_window_s: float | None = None) -> ThreadingHTTPServer:
    """A ready-to-serve ThreadingHTTPServer (port 0 = ephemeral).

    ``alerts`` (an ``obs.alerts.AlertEngine``) adds the ``GET /alerts``
    status and an ``alerts`` block to ``/healthz``; ``slo_window_s`` reads
    the ``/healthz`` SLO view over that sliding window instead of the
    whole lifetime (a long-idle replica cannot mask a fresh regression)."""
    from ..fleet import (
        ResidencyOverloadError,
        SceneError,
        TenantQuotaError,
        UnknownSceneError,
    )
    from ..obs import get_metrics, get_tracer
    from ..obs.trace import TRACE_HEADER, SpanContext
    from ..resil import BreakerOpenError, report
    from .batcher import BatcherClosedError, ServeTimeoutError

    slo_target_s = float(slo_target_ms) / 1e3

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet: telemetry is the record
            pass

        def _reply(self, code: int, payload: dict,
                   headers: dict | None = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                health = (batcher.health() if batcher is not None
                          else {"ok": True, "queue_depth": 0})
                health["slo"] = get_metrics().slo_view(
                    slo_target_s, window_s=slo_window_s)
                if alerts is not None:
                    health["alerts"] = alerts.healthz_block()
                health["replica"] = replica_block(engine)
                return self._reply(200 if health["ok"] else 503, health)
            if self.path == "/stats":
                stats = engine.stats()
                if batcher is not None:
                    stats["batcher"] = batcher.stats()
                return self._reply(200, stats)
            if self.path == "/alerts":
                if alerts is None:
                    return self._reply(
                        200, {"enabled": False, "firing": [], "alerts": []})
                return self._reply(200, alerts.status())
            if self.path == "/metrics":
                data = get_metrics().render_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return None
            return self._reply(404, {"error": f"no route {self.path}"})

        def _drain(self):
            """Stop admitting, render everything queued, count what
            failed meanwhile; the process exit stays the caller's."""
            if batcher is None:
                return self._reply(200, {"drained": True, "n_failed": 0})
            with get_tracer().span(
                    "serve.drain",
                    parent=SpanContext.from_header(
                        self.headers.get(TRACE_HEADER))) as sp:
                before = (batcher.n_timeouts + batcher.n_dispatch_errors
                          + batcher.n_scene_errors)
                batcher.close(drain=True)
                failed = (batcher.n_timeouts + batcher.n_dispatch_errors
                          + batcher.n_scene_errors) - before
                sp.set(detail=f"drain_failed={int(failed)}")
            return self._reply(200, {"drained": True,
                                     "n_failed": int(failed)})

        def do_POST(self):
            if self.path == "/drain":
                return self._drain()
            if self.path != "/render":
                return self._reply(404, {"error": f"no route {self.path}"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                scene, tenant = body.get("scene"), body.get("tenant")
                # the request's root span; the batcher captures its context
                # at submit, so the worker's spans descend from it
                with get_tracer().span(
                        "serve.request",
                        parent=SpanContext.from_header(
                            self.headers.get(TRACE_HEADER)),
                        scene=None if scene is None else str(scene),
                        tenant=None if tenant is None else str(tenant)):
                    out = render_pose(engine, batcher, body)
                return self._reply(200, out)
            except TenantQuotaError as err:
                return self._reply(
                    429, {"error": str(err), "tenant": err.tenant,
                          "retry_after_s": err.retry_after_s},
                    headers={"Retry-After":
                             str(max(1, round(err.retry_after_s)))})
            except UnknownSceneError as err:
                return self._reply(404, {"error": str(err),
                                         "scene": err.scene_id})
            except ResidencyOverloadError as err:
                # every resident scene is pinned: momentary, retryable
                return self._reply(503, {"error": str(err),
                                         "scene": err.scene_id},
                                   headers={"Retry-After": "1"})
            except SceneError as err:
                # torn / unloadable / incompatible: this scene only
                return self._reply(503, {"error": str(err),
                                         "scene": err.scene_id})
            except BreakerOpenError as err:
                return self._reply(
                    503, {"error": str(err),
                          "retry_after_s": err.retry_after_s},
                    headers={"Retry-After":
                             str(max(1, round(err.retry_after_s)))})
            except BatcherClosedError as err:
                # drained or shutting down: another replica takes it
                return self._reply(503, {"error": str(err)})
            except (ServeTimeoutError, TimeoutError) as err:
                return self._reply(504, {"error": str(err) or "timed out"})
            except (ValueError, KeyError) as err:
                return self._reply(400, {"error": str(err)})
            except Exception as err:  # structured 500, never a traceback
                report("serve.request", "error",
                       detail=f"{type(err).__name__}: {err}"[:200])
                return self._reply(500, {"error": "internal error"})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="NeRF render serving (PyTorch)")
    p.add_argument("--cfg_file", default="configs/nerf/lego.yaml")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8008)
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", default=[], nargs=argparse.REMAINDER)
    args = p.parse_args(argv)

    from ..config import make_cfg
    from ..obs import configure_tracing, get_metrics, init_run
    from ..resil import (
        CircuitBreaker,
        FlightRecorder,
        PreemptionGuard,
        install_flight_recorder,
    )
    from ..fleet.qos import QosController
    from ..utils.setup import configure_runtime
    from .batcher import MicroBatcher
    from .engine import engine_from_cfg

    cfg = make_cfg(args.cfg_file, args.opts or (), default_task="run")
    configure_runtime(cfg)
    emitter = init_run(cfg, component="serve")
    # tracing and the flight recorder come up BEFORE the engine, so the
    # warm-up and the first request are on the record
    o = cfg.get("obs", {})
    trace_on = bool(o.get("trace", True))
    flight_dir = str(o.get("flight_dir", "")) or str(
        cfg.get("record_dir", "."))
    slo_target_ms = float(o.get("slo_target_ms", 100.0))
    # a replica's span ids carry its id as a prefix, so a merge of several
    # replicas' telemetry joins on globally unique ids
    replica_id = os.environ.get("SCALE_REPLICA_ID", "")
    configure_tracing(enabled=trace_on, id_prefix=replica_id)
    install_flight_recorder(FlightRecorder(
        flight_dir, capacity=int(o.get("trace_ring", 256))))
    # the ops layer (obs.alerts): the burn-rate alert engine, the incident
    # correlator (alert fires and flight dumps open incidents) and the
    # capacity ledger, fed from the row taps, driven by the loop below
    alerts = incidents = capacity = None
    slo_window_s = None
    capacity_every_s = 30.0
    if bool(cfg.obs.alerts.enabled):
        from ..obs import (
            AlertEngine,
            AlertOptions,
            CapacityLedger,
            IncidentManager,
        )
        from ..resil.flight import add_dump_listener, remove_dump_listener

        slo_window_s = float(cfg.obs.alerts.view_window_s)
        capacity_every_s = float(cfg.obs.alerts.capacity_every_s)
        alerts = AlertEngine(AlertOptions.from_cfg(cfg),
                             slo_target_s=slo_target_ms / 1e3,
                             replica=replica_id).attach()
        incidents = IncidentManager(flight_dir, replica=replica_id).attach()
        alerts.add_listener(incidents.on_alert)
        add_dump_listener(incidents.on_flight_dump)
        capacity = CapacityLedger(replica=replica_id,
                                  window_s=slo_window_s).attach()
    # SIGTERM: the guard's handler dumps the flight ring; the loop below
    # then drains and exits cleanly
    guard = PreemptionGuard.install()

    engine = engine_from_cfg(cfg, cfg_file=args.cfg_file, device=args.device)
    batcher = MicroBatcher(engine, breaker=CircuitBreaker.from_cfg(cfg),
                           qos=QosController.from_cfg(cfg))
    server = make_server(engine, batcher, host=args.host, port=args.port,
                         slo_target_ms=slo_target_ms, alerts=alerts,
                         slo_window_s=slo_window_s)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(device {engine.device}, route {engine.march_options.march_fused}, "
          f"buckets {list(engine.buckets)}, "
          f"tracing {'on' if trace_on else 'off'})", flush=True)
    try:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        last_cap = time.monotonic()
        while t.is_alive() and not (guard is not None and guard.triggered):
            t.join(timeout=0.5)
            if alerts is not None:
                # transitions emit alert rows and open or mitigate
                # incidents; the capacity row commits on its own cadence
                alerts.evaluate()
                incidents.sweep()
                if time.monotonic() - last_cap >= capacity_every_s:
                    capacity.snapshot()
                    last_cap = time.monotonic()
        server.shutdown()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        batcher.close()
        if alerts is not None:
            capacity.snapshot()  # the final ledger state is on the record
            alerts.evaluate()
            incidents.sweep()
            alerts.detach()
            incidents.detach()
            capacity.detach()
            remove_dump_listener(incidents.on_flight_dump)
        snap = get_metrics().snapshot()
        snap["slo"] = get_metrics().slo_view(slo_target_ms / 1e3)
        emitter.emit("metrics_snapshot", **snap)
        emitter.close()
        if guard is not None:
            guard.uninstall()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
