"""Incident correlator: alerts and flight dumps assemble their own evidence
(port of ``nerf_replication_tpu/obs/incidents.py``).

When something fires — a burn-rate alert (obs/alerts.py), a flight-data
dump (resil/flight.py), or an injected chaos fault — the on-call question
is always the same: *what else was happening?* This module answers it
automatically. The manager taps the telemetry row stream
(``obs.emit.add_row_tap``), keeps a bounded ring of recent rows, and on a
trigger walks that ring backward to assemble a causal timeline: fault /
retry / breaker transitions, scale_decision rows (whose evidence carries
exemplar trace ids), scene_load / scene_evict residency moves, tenant
denials, shed decisions, replica lifecycle — plus the spans matching any
exemplar trace id, so the incident links directly into the traces that
missed their SLO.

Each incident is written atomically (tmp + rename, the flight-dump
discipline) as ``incident_<id>.json`` next to the run's telemetry plus a
human-readable ``incident_<id>.md``, and follows an
open -> mitigated -> resolved lifecycle tied to alert clearing: the
triggering alert resolving mitigates the incident; a quiet period (or an
explicit :meth:`resolve_open` from the chaos harness) resolves it. Every
lifecycle transition emits a schema-versioned ``incident`` telemetry row,
so tlm_report can gate on unresolved incidents without reading dumps.

With ``open_on_fault=True`` (the chaos harness), injected fault rows
themselves open incidents — every chaos scenario self-documents, and a
clean run produces zero incident files by construction.

Dependency direction: obs never imports resil — the *caller* (the HTTP
server, ``serve/__main__.py``) wires
``resil.flight.add_dump_listener(mgr.on_flight_dump)``.
Host-side pure Python, injectable clock, thread-safe (RLock: emitting an
``incident`` row from inside a row tap re-enters :meth:`_on_row` on the
same thread).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from .emit import add_row_tap, get_emitter, remove_row_tap

INCIDENT_VERSION = 1

# row kinds worth putting on an incident timeline, and the fields that
# make each one legible in the markdown summary
_TIMELINE_KINDS = {
    "fault": ("point", "fault", "mode"),
    "retry": ("point", "attempt", "outcome"),
    "breaker": ("point", "state", "failures"),
    "scale_decision": ("action", "reason", "n_replicas", "attainment"),
    "scene_load": ("scene", "source", "load_s", "bytes"),
    "scene_evict": ("scene", "reason", "bytes"),
    "tenant_admit": ("tenant", "decision", "reason"),
    "serve_shed": ("reason", "queue_depth"),
    "replica": ("replica", "state", "reason"),
    "router": ("event", "replica"),
    "alert": ("name", "state", "severity", "value"),
}

_STATUSES = ("open", "mitigated", "resolved")
_TRIGGERS = ("alert", "flight_dump", "fault")


class IncidentManager:
    """Correlates telemetry into atomic incident dumps with a lifecycle.

    ``out_dir`` receives ``incident_<id>.json`` / ``.md``. ``clock``
    must be the same timebase as row ``t`` stamps (wall time) — tests
    inject a fake. ``coalesce_s`` merges triggers landing while an
    incident is already open (a breaker storm is one incident, not
    forty); ``lookback_s`` bounds the timeline walk; ``quiet_s`` is the
    auto-mitigate/auto-resolve quiet period :meth:`sweep` applies.
    """

    def __init__(self, out_dir: str, *, clock=time.time,
                 ring_size: int = 4096, lookback_s: float = 120.0,
                 coalesce_s: float = 60.0, quiet_s: float = 300.0,
                 open_on_fault: bool = False, replica: str = ""):
        self.out_dir = str(out_dir)
        self.clock = clock
        self.lookback_s = float(lookback_s)
        self.coalesce_s = float(coalesce_s)
        self.quiet_s = float(quiet_s)
        self.open_on_fault = bool(open_on_fault)
        self.replica = str(replica)
        self._ring: deque = deque(maxlen=int(ring_size))
        self._lock = threading.RLock()
        self._seq = 0
        self.incidents: list[dict] = []  # every incident, open or not

    # -- feeds ---------------------------------------------------------------

    def attach(self) -> "IncidentManager":
        add_row_tap(self._on_row)
        return self

    def detach(self) -> None:
        remove_row_tap(self._on_row)

    def _on_row(self, row: dict) -> None:
        kind = row.get("kind")
        if kind == "incident":
            return  # our own lifecycle rows never feed timelines
        with self._lock:
            if kind in _TIMELINE_KINDS or kind == "span":
                self._ring.append(row)
            if self.open_on_fault and kind == "fault":
                point = str(row.get("point", ""))
                fault = str(row.get("fault", ""))
                self._trigger(
                    trigger="fault",
                    detail=f"injected fault {fault} at {point}",
                    fault_hint=f"{point}:{fault}")

    def on_alert(self, event: dict) -> None:
        """AlertEngine listener: fire opens/coalesces, clear mitigates."""
        name = str(event.get("name", ""))
        if event.get("state") == "firing":
            with self._lock:
                inc = self._trigger(
                    trigger="alert",
                    alert=name,
                    severity=str(event.get("severity", "")),
                    detail=(f"alert {name} firing "
                            f"(value={event.get('value')}, "
                            f"threshold={event.get('threshold')})"))
                if name not in inc["alerts"]:
                    inc["alerts"].append(name)
                    self._write(inc)
            return
        # resolved: mitigate incidents that no longer have a firing alert
        with self._lock:
            for inc in self.incidents:
                if inc["status"] != "open" or name not in inc["alerts"]:
                    continue
                inc["alerts"] = [a for a in inc["alerts"] if a != name]
                if not inc["alerts"]:
                    self._transition(inc, "mitigated",
                                     f"alert {name} resolved")

    def on_flight_dump(self, reason: str, path: str, detail: str = "") -> None:
        """resil.flight dump listener (wired by the caller, not here)."""
        with self._lock:
            inc = self._trigger(
                trigger="flight_dump",
                detail=f"flight dump {reason}: {detail}".strip(": "))
            if path and path not in inc["flight_dumps"]:
                inc["flight_dumps"].append(str(path))
                self._write(inc)

    # -- lifecycle -----------------------------------------------------------

    def _current_open(self, now: float) -> dict | None:
        for inc in reversed(self.incidents):
            if inc["status"] == "open" and \
                    now - inc["last_event_t"] <= self.coalesce_s:
                return inc
        return None

    def _trigger(self, *, trigger: str, detail: str, alert: str = "",
                 severity: str = "", fault_hint: str = "") -> dict:
        now = self.clock()
        inc = self._current_open(now)
        if inc is not None:
            # coalesce: refresh the timeline, note the new trigger
            inc["last_event_t"] = now
            inc["detail"] += f"; {detail}"
            if fault_hint and fault_hint not in inc["fault_points"]:
                inc["fault_points"].append(fault_hint)
            self._assemble(inc, now)
            self._write(inc)
            return inc
        self._seq += 1
        iid = f"inc-{self._seq:04d}"
        inc = {
            "incident_version": INCIDENT_VERSION,
            "incident_id": iid,
            "status": "open",
            "trigger": trigger,
            "alert": alert,
            "severity": severity,
            "detail": detail,
            "replica": self.replica,
            "opened_t": now,
            "last_event_t": now,
            "mitigated_t": None,
            "resolved_t": None,
            "alerts": [alert] if alert else [],
            "flight_dumps": [],
            "fault_points": [fault_hint] if fault_hint else [],
            "trace_ids": [],
            "timeline": [],
            "n_events": 0,
            "path": os.path.join(self.out_dir,
                                 f"incident_{self._seq:04d}.json"),
        }
        self.incidents.append(inc)
        self._assemble(inc, now)
        self._write(inc)
        self._emit(inc)
        return inc

    def _transition(self, inc: dict, status: str, why: str) -> None:
        now = self.clock()
        inc["status"] = status
        inc["detail"] += f"; {why}"
        if status == "mitigated":
            inc["mitigated_t"] = now
        elif status == "resolved":
            inc["resolved_t"] = now
            if inc["mitigated_t"] is None:
                inc["mitigated_t"] = now
            self._assemble(inc, now)  # final timeline includes recovery
        self._write(inc)
        self._emit(inc)

    def sweep(self, now: float | None = None) -> None:
        """Quiet-period automation: an open incident whose alerts have
        all cleared mitigates after ``quiet_s`` without new triggers; a
        mitigated one resolves after another quiet period."""
        now = self.clock() if now is None else now
        with self._lock:
            for inc in self.incidents:
                if inc["status"] == "open" and not inc["alerts"] and \
                        now - inc["last_event_t"] >= self.quiet_s:
                    self._transition(inc, "mitigated",
                                     f"quiet for {self.quiet_s:g}s")
                elif inc["status"] == "mitigated" and \
                        now - (inc["mitigated_t"] or now) >= self.quiet_s:
                    self._transition(inc, "resolved",
                                     f"quiet for {self.quiet_s:g}s")

    def resolve_open(self, detail: str = "operator resolve") -> int:
        """Force-resolve everything still open/mitigated (the chaos
        harness calls this once its recovery checks pass)."""
        n = 0
        with self._lock:
            for inc in self.incidents:
                if inc["status"] != "resolved":
                    self._transition(inc, "resolved", detail)
                    n += 1
        return n

    # -- evidence assembly ---------------------------------------------------

    def _assemble(self, inc: dict, now: float) -> None:
        """Walk the row ring backward into a causal timeline (lock held)."""
        cutoff = now - self.lookback_s
        events: list[dict] = []
        trace_ids: list[str] = list(inc["trace_ids"])
        fault_points: list[str] = list(inc["fault_points"])
        spans_by_trace: dict[str, list[dict]] = {}
        for row in self._ring:
            t = float(row.get("t", now))
            if t < cutoff:
                continue
            kind = row.get("kind")
            if kind == "span":
                tid = row.get("trace_id")
                if isinstance(tid, str):
                    spans_by_trace.setdefault(tid, []).append(row)
                continue
            if kind not in _TIMELINE_KINDS:
                continue
            ev = {"t": t, "kind": kind}
            for f in _TIMELINE_KINDS[kind]:
                if f in row:
                    ev[f] = row[f]
            events.append(ev)
            if kind == "fault":
                fp = f"{row.get('point', '')}:{row.get('fault', '')}"
                if fp not in fault_points:
                    fault_points.append(fp)
            elif kind == "scale_decision":
                # evidence-linked decisions carry exemplar trace ids
                ex = row.get("evidence") or {}
                for tid in (ex.get("exemplar_trace_ids") or []):
                    if isinstance(tid, str) and tid not in trace_ids:
                        trace_ids.append(tid)
        # pull the spans of any exemplar trace onto the timeline
        for tid in trace_ids:
            for srow in spans_by_trace.get(tid, []):
                events.append({
                    "t": float(srow.get("t", now)), "kind": "span",
                    "trace_id": tid, "name": srow.get("name"),
                    "dur_s": srow.get("dur_s"),
                    "status": srow.get("status"),
                })
        events.sort(key=lambda e: e["t"])
        inc["timeline"] = events[-512:]
        inc["n_events"] = len(inc["timeline"])
        inc["trace_ids"] = trace_ids[:64]
        inc["fault_points"] = fault_points

    # -- persistence ---------------------------------------------------------

    def _write(self, inc: dict) -> None:
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            path = inc["path"]
            tmp = path + ".tmp"
            # graftlint: ok(blocking-under-lock: incident persistence is a rare control-plane event — alert fire / flight dump — never the serve dispatch path; writing under the lock serializes dump files against concurrent triggers)
            with open(tmp, "w") as fh:
                json.dump(inc, fh, indent=1, default=str)
            os.replace(tmp, path)
            md = path[:-len(".json")] + ".md"
            tmp = md + ".tmp"
            # graftlint: ok(blocking-under-lock: same rare control-plane write as the json dump above)
            with open(tmp, "w") as fh:
                fh.write(self._markdown(inc))
            os.replace(tmp, md)
        except OSError:
            # graftlint: ok(swallow: incident persistence must never take down the serving path; the in-memory record survives)
            pass

    def _emit(self, inc: dict) -> None:
        # graftlint: ok(blocking-under-lock: incident lifecycle rows are emitted at most a handful of times per incident; the lock orders them against the row tap feeding the ring)
        get_emitter().emit(
            "incident",
            incident_id=inc["incident_id"],
            status=inc["status"],
            trigger=inc["trigger"],
            alert=inc["alert"],
            severity=inc["severity"],
            n_events=inc["n_events"],
            fault_points=list(inc["fault_points"]),
            trace_ids=list(inc["trace_ids"]),
            path=inc["path"],
            opened_t=inc["opened_t"],
            resolved_t=inc["resolved_t"],
            detail=inc["detail"][-500:],
        )

    def _markdown(self, inc: dict) -> str:
        lines = [
            f"# Incident {inc['incident_id']} — {inc['status']}",
            "",
            f"- **trigger**: {inc['trigger']}"
            + (f" (alert `{inc['alert']}`, {inc['severity']})"
               if inc["alert"] else ""),
            f"- **opened**: t={inc['opened_t']:.3f}"
            + (f", resolved t={inc['resolved_t']:.3f}"
               if inc["resolved_t"] else ""),
            f"- **detail**: {inc['detail']}",
        ]
        if inc["fault_points"]:
            lines.append(
                "- **fault points**: " + ", ".join(
                    f"`{p}`" for p in inc["fault_points"]))
        if inc["trace_ids"]:
            lines.append(
                "- **exemplar traces**: " + ", ".join(
                    f"`{t}`" for t in inc["trace_ids"][:8]))
        if inc["flight_dumps"]:
            lines.append(
                "- **flight dumps**: " + ", ".join(inc["flight_dumps"]))
        lines += ["", "## Timeline", ""]
        for ev in inc["timeline"]:
            extras = ", ".join(f"{k}={v}" for k, v in ev.items()
                               if k not in ("t", "kind"))
            lines.append(f"- `t={ev['t']:.3f}` **{ev['kind']}** {extras}")
        lines.append("")
        return "\n".join(lines)

    def stats(self) -> dict:
        with self._lock:
            by = {s: 0 for s in _STATUSES}
            for inc in self.incidents:
                by[inc["status"]] += 1
            return {"n_incidents": len(self.incidents), **by,
                    "ring": len(self._ring)}


def validate_incident_dump(path: str) -> list[str]:
    """Schema problems in an incident dump file ([] == valid) — the
    check_telemetry_schema treatment flight dumps already get."""
    problems: list[str] = []
    try:
        with open(path) as fh:
            inc = json.load(fh)
    except (OSError, ValueError) as e:
        return [f"unreadable: {e}"]
    if not isinstance(inc, dict):
        return ["not a JSON object"]
    if inc.get("incident_version") != INCIDENT_VERSION:
        problems.append(
            f"incident_version {inc.get('incident_version')!r} != "
            f"{INCIDENT_VERSION}")
    for key, typ in (("incident_id", str), ("status", str),
                     ("trigger", str), ("detail", str),
                     ("opened_t", (int, float))):
        if not isinstance(inc.get(key), typ):
            problems.append(f"missing/mistyped field: {key}")
    if inc.get("status") not in _STATUSES:
        problems.append(f"bad status: {inc.get('status')!r}")
    if inc.get("trigger") not in _TRIGGERS:
        problems.append(f"bad trigger: {inc.get('trigger')!r}")
    for key in ("alerts", "fault_points", "trace_ids", "timeline",
                "flight_dumps"):
        if not isinstance(inc.get(key), list):
            problems.append(f"missing/mistyped list: {key}")
    if inc.get("status") == "resolved" and \
            not isinstance(inc.get("resolved_t"), (int, float)):
        problems.append("resolved incident without resolved_t")
    for i, ev in enumerate(inc.get("timeline") or []):
        if not isinstance(ev, dict) or "t" not in ev or "kind" not in ev:
            problems.append(f"timeline[{i}] missing t/kind")
            break
    return problems
