"""Fleet metrics aggregation: one Prometheus surface for N replicas
(port of ``nerf_replication_tpu/scale/fleet_metrics.py``).

Each serving process has its own ``GET /metrics``; this module merges
them, so the operator reads one body instead of N ports, and gives the
supervisor its evidence from the same object:

* :func:`merge_scrapes` — merge per-replica Prometheus text bodies into
  one, every sample gaining a ``replica`` label (an already-present
  ``replica`` label is renamed ``exported_replica``, the classic
  federation collision rule). Exemplar suffixes ride along untouched.
* :class:`FleetMetricsAggregator` — scrapes every registered replica
  through the router (``scrape_metrics()`` on the replica surface),
  dedups in-process replicas that share one registry (their
  ``metrics_source_id()`` is the process, not the replica), skips dead/
  retired/unreachable replicas (counted, surfaced), and derives the
  fleet SLO view — both cumulative and per-window deltas, which is the
  attainment/deny-rate signal the supervisor acts on. One signal,
  two consumers: what the loop decides on is what operators see.
* :func:`make_fleet_server` — the router-side HTTP face:
  ``GET /fleet/metrics`` (merged text) and ``GET /fleet/slo`` (JSON).

Host-side pure Python; no torch import anywhere in scale/.
"""

from __future__ import annotations

import bisect
import json
import re
import threading

from ..obs.metrics import get_metrics
from .replica import ReplicaState

# one exposition sample: name{labels} value [# {exemplar-labels} value]
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"      # metric name
    r"(?:\{(.*?)\})?"                    # label body (lazy: stop before value/exemplar)
    r"\s+(-?[0-9.eE+\-]+|NaN|[+-]Inf)"   # value
    r"(\s+#\s+\{.*\}\s+\S+)?\s*$"        # optional exemplar suffix
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def parse_labels(body: str | None) -> dict[str, str]:
    return dict(_LABEL_RE.findall(body or ""))


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in sorted(labels.items())) \
        + "}"


def relabel_sample(line: str, replica: str) -> str:
    """Inject ``replica="<id>"`` into one sample line; a pre-existing
    ``replica`` label (a replica talking about other replicas, e.g. the
    router's own dispatch counter) is renamed ``exported_replica``."""
    m = _SAMPLE_RE.match(line)
    if m is None:
        return line  # not a sample (defensive) — pass through
    name, body, value, exemplar = m.groups()
    labels = parse_labels(body)
    if "replica" in labels:
        labels["exported_replica"] = labels.pop("replica")
    labels["replica"] = str(replica)
    return f"{name}{_fmt_labels(labels)} {value}{exemplar or ''}"


def merge_scrapes(scrapes: dict[str, str]) -> str:
    """Merge ``{source_id: prometheus_text}`` into one exposition body:
    one ``# TYPE`` line per metric (first scrape wins), samples grouped
    by metric, each carrying its source's ``replica`` label."""
    types: dict[str, str] = {}
    samples: dict[str, list[str]] = {}
    for rid in sorted(scrapes):
        for line in scrapes[rid].splitlines():
            line = line.strip()
            if not line:
                continue
            if line.startswith("# TYPE "):
                parts = line.split()
                if len(parts) >= 3:
                    types.setdefault(parts[2], line)
                continue
            if line.startswith("#"):
                continue  # HELP/comments don't merge meaningfully
            m = _SAMPLE_RE.match(line)
            if m is None:
                continue
            name = m.group(1)
            # bucket/sum/count series group under their histogram's name
            base = re.sub(r"_(bucket|sum|count)$", "", name)
            key = base if base in types else name
            samples.setdefault(key, []).append(relabel_sample(line, rid))
    lines: list[str] = []
    for name in sorted(samples):
        if name in types:
            lines.append(types[name])
        lines.extend(samples[name])
    return "\n".join(lines) + "\n"


class FleetMetricsAggregator:
    """Scrape-merge-derive over a :class:`~.router.Router`'s registry.

    ``slo_target_s`` mirrors the per-replica ``/healthz`` target; the
    attainment read uses the same fixed-bucket rule as
    ``MetricsRegistry.slo_view`` (smallest edge >= target)."""

    def __init__(self, router, slo_target_s: float = 0.25):
        self.router = router
        self.slo_target_s = float(slo_target_s)
        self._lock = threading.Lock()
        self.last_scrapes: dict[str, str] = {}
        self.skipped: list[dict] = []
        self.n_scrape_rounds = 0
        self.n_scrape_failures = 0
        # cumulative totals at the previous window() call — the deltas
        # between calls ARE the supervisor's observation window
        self._prev: dict | None = None

    # -- scraping -------------------------------------------------------------

    def scrape(self) -> dict[str, str]:
        """One scrape round across the fleet. Returns source_id → text;
        dead/retired/unreachable replicas are skipped and recorded in
        ``self.skipped`` (the operator sees the hole, not a silent
        shorter list)."""
        scrapes: dict[str, str] = {}
        skipped: list[dict] = []
        for r in self.router.replicas():
            rid = r.replica_id
            if r.state in (ReplicaState.DEAD, ReplicaState.RETIRED):
                skipped.append({"replica": rid, "reason": r.state})
                continue
            scrape_fn = getattr(r, "scrape_metrics", None)
            if scrape_fn is None:
                skipped.append({"replica": rid, "reason": "no_scrape"})
                continue
            sid = str(getattr(r, "metrics_source_id", lambda: rid)())
            if sid in scrapes:
                continue  # in-process replicas share one registry
            try:
                scrapes[sid] = scrape_fn()
            # graftlint: ok(swallow: an unreachable replica must not fail the fleet scrape; the skip is recorded and counted)
            except Exception as exc:
                self.n_scrape_failures += 1
                skipped.append({"replica": rid,
                                "reason": f"unreachable: {exc}"[:120]})
        with self._lock:
            self.last_scrapes = scrapes
            self.skipped = skipped
            self.n_scrape_rounds += 1
        return scrapes

    def render(self) -> str:
        """Fresh scrape → one merged Prometheus text body (the
        ``GET /fleet/metrics`` payload)."""
        return merge_scrapes(self.scrape())

    # -- derived views --------------------------------------------------------

    def _totals(self, merged: str) -> dict:
        """Cumulative fleet counts from one merged body: latency
        histogram (attained-at-target / total), request/shed/deny
        counters, and the SLO-miss exemplar trace ids seen."""
        series: dict[tuple, dict[float, float]] = {}
        inf: dict[tuple, float] = {}
        counters = {"requests": 0.0, "sheds": 0.0, "admits": 0.0,
                    "denies": 0.0, "no_replica": 0.0}
        exemplars: list[tuple[float, str]] = []
        for line in merged.splitlines():
            m = _SAMPLE_RE.match(line.strip())
            if m is None:
                continue
            name, body, value, exemplar = m.groups()
            try:
                val = float(value)
            except ValueError:
                continue
            labels = parse_labels(body)
            if name == "serve_request_latency_seconds_bucket":
                le = labels.pop("le", None)
                key = tuple(sorted(labels.items()))
                if le == "+Inf":
                    inf[key] = val
                else:
                    try:
                        edge = float(le)
                    except (TypeError, ValueError):
                        continue
                    series.setdefault(key, {})[edge] = val
                    if exemplar and edge >= self.slo_target_s:
                        tid = parse_labels(exemplar).get("trace_id")
                        if tid:
                            exemplars.append((edge, tid))
            elif name == "serve_requests_total":
                counters["requests"] += val
            elif name == "serve_sheds_total":
                counters["sheds"] += val
            elif name == "tenant_admits_total":
                counters["admits"] += val
                if labels.get("decision") == "deny":
                    counters["denies"] += val
            elif (name == "scale_router_events_total"
                    and labels.get("event") == "no_replica"):
                counters["no_replica"] += val
        attained = 0.0
        total = 0.0
        for key, buckets in series.items():
            edges = sorted(buckets)
            i = bisect.bisect_left(edges, self.slo_target_s)
            cum_inf = inf.get(key, buckets[edges[-1]] if edges else 0.0)
            attained += buckets[edges[i]] if i < len(edges) else cum_inf
            total += cum_inf
        return {"attained": attained, "latency_count": total,
                **counters, "exemplars": exemplars}

    def slo_view(self) -> dict:
        """Cumulative fleet SLO verdict (the ``GET /fleet/slo`` body)."""
        merged = merge_scrapes(self.scrape())
        t = self._totals(merged)
        total = t["latency_count"]
        admits = t["admits"]
        return {
            "target_ms": round(self.slo_target_s * 1e3, 3),
            "replicas_scraped": len(self.last_scrapes),
            "replicas_skipped": len(self.skipped),
            "skipped": list(self.skipped),
            "requests": int(t["requests"]),
            "attainment": (round(t["attained"] / total, 4)
                           if total else None),
            "deny_rate": (round(t["denies"] / admits, 4) if admits else 0.0),
            "shed_rate": (round(t["sheds"] / t["requests"], 4)
                          if t["requests"] else 0.0),
            "no_replica": int(t["no_replica"]),
        }

    def window(self) -> dict:
        """One observation window: the DELTAS since the previous call
        (cumulative counters make each window independent of restart
        timing). This is the supervisor's input — attainment None means
        nothing completed this window, which the caller must distinguish
        between idle and wedged (see Supervisor.step_from_fleet)."""
        merged = merge_scrapes(self.scrape())
        now = self._totals(merged)
        with self._lock:
            prev = self._prev or {k: 0.0 for k in
                                  ("attained", "latency_count", "requests",
                                   "sheds", "admits", "denies", "no_replica")}
            self._prev = now
        d = {k: max(0.0, now[k] - prev.get(k, 0.0))
             for k in ("attained", "latency_count", "requests", "sheds",
                       "admits", "denies", "no_replica")}
        admits = d["admits"]
        return {
            "attainment": (round(d["attained"] / d["latency_count"], 4)
                           if d["latency_count"] else None),
            "deny_rate": (round(d["denies"] / admits, 4) if admits else 0.0),
            "requests": int(d["requests"]),
            "no_replica": int(d["no_replica"]),
            "exemplar_trace_ids": self.slo_miss_exemplars(),
        }

    def slo_miss_exemplars(self, target_s: float | None = None,
                           limit: int = 8) -> list[str]:
        """Exemplar trace ids from SLO-missing latency buckets across
        the LAST scrape round (slowest first, deduped) — the evidence
        trace ids a scale decision links to. ``target_s`` mirrors the
        :meth:`~..obs.metrics.MetricsRegistry.slo_miss_exemplars`
        surface (the Supervisor's evidence_source duck type); the
        aggregator's own ``slo_target_s`` is the floor either way."""
        target = self.slo_target_s if target_s is None else float(target_s)
        with self._lock:
            scrapes = dict(self.last_scrapes)
        merged = merge_scrapes(scrapes) if scrapes else ""
        pool = sorted((e for e in self._totals(merged)["exemplars"]
                       if e[0] >= target), reverse=True)
        out: list[str] = []
        for _edge, tid in pool:
            if tid not in out:
                out.append(tid)
            if len(out) >= limit:
                break
        return out

    def capacity_view(self) -> dict:
        """Fresh scrape → the fleet's capacity ledger, per replica: the
        ``capacity_*`` gauges each replica's
        :class:`~..obs.capacity.CapacityLedger` published, grouped by
        the ``replica`` label the merge injected (the ``GET
        /fleet/capacity`` payload — what the placement planner reads)."""
        merged = merge_scrapes(self.scrape())
        replicas: dict[str, dict] = {}
        for line in merged.splitlines():
            m = _SAMPLE_RE.match(line.strip())
            if m is None:
                continue
            name, body, value, _ex = m.groups()
            if not name.startswith("capacity_"):
                continue
            try:
                val = float(value)
            except ValueError:
                continue
            labels = parse_labels(body)
            rep = replicas.setdefault(labels.get("replica", ""), {})
            if name == "capacity_scene_requests_per_s":
                rep.setdefault("scenes", {}).setdefault(
                    labels.get("scene", ""), {})["requests_per_s"] = val
            elif name == "capacity_scene_rays_per_s":
                rep.setdefault("scenes", {}).setdefault(
                    labels.get("scene", ""), {})["rays_per_s"] = val
            elif name == "capacity_scene_cold_loads":
                rep.setdefault("scenes", {}).setdefault(
                    labels.get("scene", ""), {})["cold_loads"] = int(val)
            elif name == "capacity_scene_repromotions":
                rep.setdefault("scenes", {}).setdefault(
                    labels.get("scene", ""), {})["repromotions"] = int(val)
            elif name == "capacity_device_share":
                rep.setdefault("device_share", {})[
                    labels.get("family", "")] = val
            else:
                # the byte watermarks: capacity_hbm_bytes etc.
                rep[name[len("capacity_"):]] = int(val)
        return {"replicas": replicas, "n_replicas": len(replicas)}

    def stats(self) -> dict:
        with self._lock:
            return {
                "n_scrape_rounds": self.n_scrape_rounds,
                "n_scrape_failures": self.n_scrape_failures,
                "sources": sorted(self.last_scrapes),
                "skipped": list(self.skipped),
            }


def make_fleet_server(aggregator: FleetMetricsAggregator,
                      host: str = "127.0.0.1", port: int = 0):
    """The router-side HTTP face of the aggregator: ``GET
    /fleet/metrics`` (merged Prometheus text), ``GET /fleet/slo``
    (JSON), and ``GET /fleet/capacity`` (the per-replica capacity
    ledger). Returns the configured ``ThreadingHTTPServer`` (caller
    serves it; ``server.server_address[1]`` is the bound port)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet: telemetry rows, not stderr
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            try:
                if self.path == "/fleet/metrics":
                    text = aggregator.render()
                    get_metrics().counter("fleet_scrapes_total")
                    self._send(200, text.encode(),
                               "text/plain; version=0.0.4")
                elif self.path == "/fleet/slo":
                    body = json.dumps(aggregator.slo_view()).encode()
                    self._send(200, body, "application/json")
                elif self.path == "/fleet/capacity":
                    body = json.dumps(aggregator.capacity_view()).encode()
                    self._send(200, body, "application/json")
                else:
                    self._send(404, b'{"error": "not found"}',
                               "application/json")
            # graftlint: ok(swallow: one bad scrape must not kill the fleet endpoint thread; the 500 carries the error)
            except Exception as exc:
                detail = json.dumps(
                    {"error": f"{type(exc).__name__}: {exc}"[:200]}
                ).encode()
                self._send(500, detail, "application/json")

    return ThreadingHTTPServer((host, port), Handler)
