"""Lock-cheap live aggregation: counters, gauges, fixed-bucket histograms.

``telemetry.jsonl`` answers questions after a run; an operator curl-ing a
serving replica needs answers *now*. This registry is the live side:
every serve-path event also bumps an in-memory aggregate — O(1) dict
updates under one short-held lock, no allocation proportional to traffic
— and two read surfaces render it on demand:

* :meth:`MetricsRegistry.render_prometheus` — Prometheus text exposition
  (``GET /metrics`` on serve.py) with counters, gauges, and cumulative
  ``_bucket``/``_sum``/``_count`` histogram series.
* :meth:`MetricsRegistry.slo_view` — the operator's one-glance health
  verdict folded into ``/healthz``: latency attainment against the
  configured target plus shed/timeout/error/breaker rates.

Histogram buckets are FIXED at registration (the classic Prometheus
latency ladder) rather than adaptive: fixed buckets make the hot-path
update a bisect + increment, and make attainment a cumulative-count read
with no quantile estimation. Snapshots serialize as the
``metrics_snapshot`` row kind for offline diffing.

Host-side only — no torch import, nothing here runs under trace.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque

# Prometheus' classic latency ladder, in seconds. serve targets sit
# around 50-250 ms, so the ladder brackets the SLO from both sides.
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class WindowRing:
    """Time-bucketed accumulator: ``add`` now, ``total`` over any window.

    The primitive behind windowed rates (and the burn-rate alert engine,
    obs/alerts.py): values land in coarse time slots (``slot_s``), slots
    older than ``horizon_s`` are pruned on write, and a window query sums
    the slots it covers. Memory is bounded by horizon/slot regardless of
    traffic; an idle series holds nothing. Whole-lifetime counters dilute
    a fresh regression under hours of healthy history — a windowed read
    cannot (the PR-16 ``slo_view`` fix).
    """

    __slots__ = ("slot_s", "horizon_s", "_slots")

    def __init__(self, slot_s: float = 5.0, horizon_s: float = 6 * 3600.0):
        self.slot_s = float(slot_s)
        self.horizon_s = float(horizon_s)
        self._slots: deque = deque()  # (slot_index, accumulated value)

    def add(self, value: float, now: float) -> None:
        idx = int(now // self.slot_s)
        if self._slots and self._slots[-1][0] == idx:
            self._slots[-1][1] += value
        else:
            self._slots.append([idx, float(value)])
            floor = idx - int(self.horizon_s / self.slot_s) - 1
            while self._slots and self._slots[0][0] < floor:
                self._slots.popleft()

    def total(self, window_s: float, now: float) -> float:
        """Sum over slots that overlap [now - window_s, now]."""
        cutoff = int((now - float(window_s)) // self.slot_s)
        return sum(v for i, v in self._slots if i >= cutoff)

    def __len__(self) -> int:
        return len(self._slots)


class _Histogram:
    __slots__ = ("buckets", "counts", "total", "count", "exemplars")

    def __init__(self, buckets: tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # +1: the +Inf bucket
        self.total = 0.0
        self.count = 0
        # bucket index -> (trace_id, value): last-seen sampling keeps the
        # exemplar fresh at O(1) with no reservoir bookkeeping
        self.exemplars: dict[int, tuple[str, float]] = {}

    def observe(self, value: float, trace_id: str | None = None) -> None:
        i = bisect.bisect_left(self.buckets, value)
        self.counts[i] += 1
        self.total += value
        self.count += 1
        if trace_id is not None:
            self.exemplars[i] = (str(trace_id), float(value))

    def cumulative(self) -> list[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out


class MetricsRegistry:
    """Names → labeled series. One lock; every mutation is a dict update."""

    def __init__(self, buckets: tuple[float, ...] = DEFAULT_BUCKETS,
                 clock=time.monotonic):
        self.buckets = buckets
        self.clock = clock
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, tuple], float] = {}
        self._gauges: dict[tuple[str, tuple], float] = {}
        self._hists: dict[tuple[str, tuple], _Histogram] = {}
        # windowed shadows: every counter bump and histogram observation
        # also lands in a WindowRing, so rate reads (slo_view, the alert
        # engine) can scope to a recent window instead of process lifetime
        self._cwin: dict[tuple[str, tuple], WindowRing] = {}
        self._hwin: dict[tuple[str, tuple, int], WindowRing] = {}

    # -- writes (hot path) ---------------------------------------------------

    def counter(self, name: str, value: float = 1.0, **labels) -> None:
        k = (name, _label_key(labels))
        now = self.clock()
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value
            ring = self._cwin.get(k)
            if ring is None:
                ring = self._cwin[k] = WindowRing()
            ring.add(value, now)

    def gauge(self, name: str, value: float, **labels) -> None:
        k = (name, _label_key(labels))
        with self._lock:
            self._gauges[k] = float(value)

    def observe(self, name: str, value: float, trace_id: str | None = None,
                **labels) -> None:
        """Histogram update; ``trace_id`` (when the caller is inside a
        traced request) is kept as the bucket's exemplar — the join key
        from an aggregate back to one concrete trace."""
        k = (name, _label_key(labels))
        now = self.clock()
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = _Histogram(self.buckets)
            h.observe(float(value), trace_id=trace_id)
            i = bisect.bisect_left(self.buckets, float(value))
            wk = (name, k[1], i)
            ring = self._hwin.get(wk)
            if ring is None:
                ring = self._hwin[wk] = WindowRing()
            ring.add(1.0, now)

    # -- reads ---------------------------------------------------------------

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: (h.buckets, h.cumulative(), h.total, h.count,
                         dict(h.exemplars))
                     for k, h in self._hists.items()}
        lines: list[str] = []
        seen: set[str] = set()
        for (name, key), val in sorted(counters.items()):
            if name not in seen:
                lines.append(f"# TYPE {name} counter")
                seen.add(name)
            lines.append(f"{name}{_label_str(key)} {_fmt(val)}")
        for (name, key), val in sorted(gauges.items()):
            if name not in seen:
                lines.append(f"# TYPE {name} gauge")
                seen.add(name)
            lines.append(f"{name}{_label_str(key)} {_fmt(val)}")
        for (name, key), (buckets, cum, total, count, ex) in sorted(
                hists.items()):
            if name not in seen:
                lines.append(f"# TYPE {name} histogram")
                seen.add(name)
            for i, (edge, c) in enumerate(zip(buckets, cum)):
                le = dict(key)
                le["le"] = _fmt(edge)
                line = f"{name}_bucket{_label_str(_label_key(le))} {c}"
                if i in ex:  # OpenMetrics exemplar suffix
                    tid, val = ex[i]
                    line += f' # {{trace_id="{tid}"}} {_fmt(val)}'
                lines.append(line)
            inf = dict(key)
            inf["le"] = "+Inf"
            line = f"{name}_bucket{_label_str(_label_key(inf))} {cum[-1]}"
            if len(buckets) in ex:
                tid, val = ex[len(buckets)]
                line += f' # {{trace_id="{tid}"}} {_fmt(val)}'
            lines.append(line)
            lines.append(f"{name}_sum{_label_str(key)} {_fmt(total)}")
            lines.append(f"{name}_count{_label_str(key)} {count}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able aggregate state — the ``metrics_snapshot`` row body."""
        with self._lock:
            return {
                "counters": {f"{n}{_label_str(k)}": v
                             for (n, k), v in self._counters.items()},
                "gauges": {f"{n}{_label_str(k)}": v
                           for (n, k), v in self._gauges.items()},
                "histograms": {
                    f"{n}{_label_str(k)}": {
                        "buckets": list(h.buckets),
                        "counts": list(h.counts),
                        "sum": h.total,
                        "count": h.count,
                        "exemplars": {
                            str(i): {"trace_id": t, "value": v}
                            for i, (t, v) in sorted(h.exemplars.items())
                        },
                    }
                    for (n, k), h in self._hists.items()
                },
            }

    def slo_miss_exemplars(self, target_s: float, limit: int = 8,
                           name: str = "serve_request_latency_seconds",
                           ) -> list[str]:
        """Exemplar trace ids of requests that missed the latency target:
        the evidence a ``scale_decision`` row links to. Reads exemplars
        from every bucket whose edge is >= ``target_s``; when no miss has
        an exemplar (yet), falls back to the slowest exemplars seen so an
        observed fleet always yields at least one join key."""
        miss: list[tuple[float, str]] = []
        seen_any: list[tuple[float, str]] = []
        with self._lock:
            for (n, _key), h in self._hists.items():
                if n != name:
                    continue
                lo = bisect.bisect_left(h.buckets, target_s)
                for i, (tid, val) in h.exemplars.items():
                    seen_any.append((val, tid))
                    if i >= lo:
                        miss.append((val, tid))
        pool = miss if miss else seen_any
        out: list[str] = []
        for _val, tid in sorted(pool, reverse=True):
            if tid not in out:
                out.append(tid)
            if len(out) >= limit:
                break
        return out

    def window_counter(self, name: str, window_s: float,
                       now: float | None = None, **label_filter) -> float:
        """Sum of a counter over the trailing window, across every label
        set matching ``label_filter`` (empty filter = all label sets)."""
        now = self.clock() if now is None else now
        want = set(label_filter.items())
        with self._lock:
            return sum(
                ring.total(window_s, now)
                for (n, key), ring in self._cwin.items()
                if n == name and want.issubset(dict(key).items())
            )

    def window_hist(self, name: str, target_s: float, window_s: float,
                    now: float | None = None) -> tuple[float, float]:
        """(attained, total) observation counts over the trailing window
        for histogram ``name``, attained = value <= the smallest bucket
        edge >= target (the same fixed-bucket rule as the lifetime read).
        The windowed primitive the burn-rate engine divides."""
        now = self.clock() if now is None else now
        ti = bisect.bisect_left(self.buckets, float(target_s))
        attained = total = 0.0
        with self._lock:
            for (n, _key, i), ring in self._hwin.items():
                if n != name:
                    continue
                c = ring.total(window_s, now)
                total += c
                if i <= ti:
                    attained += c
        return attained, total

    def slo_view(self, target_s: float, window_s: float | None = None) -> dict:
        """Attainment vs. the latency target + failure rates, aggregated
        across labels. Attainment is read at the smallest histogram edge
        >= target (fixed buckets: no interpolation, no estimator).

        ``window_s`` scopes every rate to the trailing window (the
        PR-16 fix: lifetime rates let hours of healthy history dilute a
        fresh regression); None keeps the whole-lifetime read for
        back-compat and offline snapshot diffing."""
        if window_s is not None:
            return self._slo_view_windowed(target_s, float(window_s))
        with self._lock:
            lat_count = 0
            lat_attained = 0
            for (name, _key), h in self._hists.items():
                if name != "serve_request_latency_seconds":
                    continue
                cum = h.cumulative()
                i = bisect.bisect_left(h.buckets, target_s)
                edge_hits = cum[min(i, len(cum) - 1)] if i < len(h.buckets) \
                    else cum[-1]
                lat_attained += edge_hits
                lat_count += h.count
            totals: dict[str, float] = {}
            by_status: dict[str, float] = {}
            breaker_opens = 0.0
            for (name, key), v in self._counters.items():
                totals[name] = totals.get(name, 0.0) + v
                if name == "serve_requests_total":
                    status = dict(key).get("status", "")
                    by_status[status] = by_status.get(status, 0.0) + v
                elif (name == "serve_breaker_transitions_total"
                        and dict(key).get("state") == "open"):
                    breaker_opens += v
        requests = totals.get("serve_requests_total", 0.0)

        def rate(n: float) -> float:
            return round(n / requests, 4) if requests else 0.0

        return {
            "target_ms": round(target_s * 1e3, 3),
            "requests": int(requests),
            "attainment": round(lat_attained / lat_count, 4)
            if lat_count else None,
            "shed_rate": rate(totals.get("serve_sheds_total", 0.0)),
            "timeout_rate": rate(by_status.get("timeout", 0.0)),
            "error_rate": rate(sum(v for s, v in by_status.items()
                                   if s.startswith("error"))),
            "breaker_opens": int(breaker_opens),
        }

    def _slo_view_windowed(self, target_s: float, window_s: float) -> dict:
        now = self.clock()
        attained, lat_count = self.window_hist(
            "serve_request_latency_seconds", target_s, window_s, now=now)
        with self._lock:
            totals: dict[str, float] = {}
            by_status: dict[str, float] = {}
            breaker_opens = 0.0
            for (name, key), ring in self._cwin.items():
                v = ring.total(window_s, now)
                if not v:
                    continue
                totals[name] = totals.get(name, 0.0) + v
                if name == "serve_requests_total":
                    status = dict(key).get("status", "")
                    by_status[status] = by_status.get(status, 0.0) + v
                elif (name == "serve_breaker_transitions_total"
                        and dict(key).get("state") == "open"):
                    breaker_opens += v
        requests = totals.get("serve_requests_total", 0.0)

        def rate(n: float) -> float:
            return round(n / requests, 4) if requests else 0.0

        return {
            "target_ms": round(target_s * 1e3, 3),
            "window_s": round(window_s, 3),
            "requests": int(requests),
            "attainment": round(attained / lat_count, 4)
            if lat_count else None,
            "shed_rate": rate(totals.get("serve_sheds_total", 0.0)),
            "timeout_rate": rate(by_status.get("timeout", 0.0)),
            "error_rate": rate(sum(v for s, v in by_status.items()
                                   if s.startswith("error"))),
            "breaker_opens": int(breaker_opens),
        }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._cwin.clear()
            self._hwin.clear()


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


_registry = MetricsRegistry()


def get_metrics() -> MetricsRegistry:
    """The process's live registry (always on; writing is cheap enough
    that there is no disable switch — tracing has one, metrics don't)."""
    return _registry


def reset_metrics() -> None:
    """Test isolation: wipe the process registry between cases."""
    _registry.reset()
