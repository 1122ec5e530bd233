"""Crash flight recorder: the last N spans, dumped at the moment of death.

``telemetry.jsonl`` records everything but answers slowly; when a chaos
run (or production) hits a breaker-open, a watchdog-detected worker
crash, a torn-scene ``SceneError``, or SIGTERM, the question is always
the same: *what was the failing request's timeline?* This module keeps a
bounded in-memory ring of the most recent finished spans (fed as a
tracer sink — see ``obs/trace.py``) plus a smaller ring of fault-point
events, and on any trigger writes one ``flight_<reason>.json`` snapshot
of both — a self-contained post-mortem next to the run's telemetry.

Dumps are atomic (tmp + rename) and deterministic under an injected
clock: ring contents are exactly the span rows in finish order, ids come
from the tracer's counter, and the only wall-clock field is the dump's
own ``t``. Same failure schedule → byte-identical dump.

Like everything in resil/, this is host-side pure Python — no torch
import. The obs→resil dependency points the safe way: ``install`` pulls
the tracer in lazily and registers itself as a sink; obs never imports
resil.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque

_REASON_RE = re.compile(r"[^A-Za-z0-9_.-]+")

FLIGHT_VERSION = 1


class FlightRecorder:
    """Bounded span+event rings with an atomic JSON dump.

    ``capacity`` bounds the span ring (the event ring is fixed small —
    fault hits are rare next to spans). ``clock`` stamps events and the
    dump header; tests inject a fake for deterministic output.
    """

    EVENT_CAPACITY = 64

    def __init__(self, out_dir: str, capacity: int = 256, clock=time.time):
        self.out_dir = str(out_dir)
        self.capacity = max(1, int(capacity))
        self.clock = clock
        self._spans: deque = deque(maxlen=self.capacity)
        self._events: deque = deque(maxlen=self.EVENT_CAPACITY)
        self._lock = threading.Lock()
        self._dumps = 0

    # -- feeds ---------------------------------------------------------------

    def record(self, span_row: dict) -> None:
        """Tracer sink: ring one finished span row."""
        with self._lock:
            self._spans.append(span_row)

    def note(self, **event) -> None:
        """Ring one non-span event (fault-point hit, breaker detail) —
        the annotations that let a dump *name* the injected fault."""
        event.setdefault("t", self.clock())
        with self._lock:
            self._events.append(event)

    # -- dump ----------------------------------------------------------------

    def dump(self, reason: str, detail: str | None = None) -> str:
        """Write ``flight_<reason>.json`` atomically; returns the path.
        A repeat trigger with the same reason overwrites (the newest
        occurrence is the one a post-mortem wants)."""
        reason_slug = _REASON_RE.sub("_", str(reason)) or "unknown"
        with self._lock:
            payload = {
                "v": FLIGHT_VERSION,
                "reason": str(reason),
                "t": self.clock(),
                "detail": detail,
                "spans": list(self._spans),
                "events": list(self._events),
            }
            self._dumps += 1
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"flight_{reason_slug}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(payload, fh, indent=1, sort_keys=True, default=str)
            fh.write("\n")
            fh.flush()
            try:
                os.fsync(fh.fileno())
            except OSError:
                pass
        os.replace(tmp, path)
        _fire_dump_listeners(str(reason), path, detail or "")
        return path

    def stats(self) -> dict:
        with self._lock:
            return {"spans": len(self._spans), "events": len(self._events),
                    "capacity": self.capacity, "dumps": self._dumps}


# -- dump listeners ----------------------------------------------------------
# In-process consumers notified after a flight dump lands on disk — the
# incident correlator (obs/incidents.py) opens an incident from here. The
# wiring direction matters: obs never imports resil, so the caller
# (serve.py, chaos_run) registers ``mgr.on_flight_dump`` with us.

_dump_listeners: list = []


def add_dump_listener(fn) -> None:
    """Subscribe ``fn(reason, path, detail)`` to every flight dump."""
    if fn not in _dump_listeners:
        _dump_listeners.append(fn)


def remove_dump_listener(fn) -> None:
    try:
        _dump_listeners.remove(fn)
    except ValueError:
        pass


def _fire_dump_listeners(reason: str, path: str, detail: str) -> None:
    for fn in list(_dump_listeners):
        try:
            fn(reason, path, detail)
        # graftlint: ok(swallow: a broken listener must never turn a crash dump into a second crash; it is dropped)
        except Exception:
            remove_dump_listener(fn)


# one recorder per process; None = flight recording disabled (the default
# outside serve.py / chaos_run — training runs don't pay the ring)
_recorder: FlightRecorder | None = None


def install_flight_recorder(recorder: FlightRecorder) -> FlightRecorder:
    """Activate ``recorder`` process-wide and subscribe it to the tracer
    so every finished span lands in the ring."""
    global _recorder
    from ..obs.trace import get_tracer

    if _recorder is not None:
        uninstall_flight_recorder()
    _recorder = recorder
    get_tracer().add_sink(recorder.record)
    return recorder


def uninstall_flight_recorder() -> None:
    global _recorder
    if _recorder is None:
        return
    from ..obs.trace import get_tracer

    get_tracer().remove_sink(_recorder.record)
    _recorder = None


def get_flight_recorder() -> FlightRecorder | None:
    return _recorder


def dump_flight(reason: str, detail: str | None = None) -> str | None:
    """Trigger a dump on the active recorder (no-op when none is
    installed, so fault paths call this unconditionally)."""
    rec = _recorder
    if rec is None:
        return None
    try:
        return rec.dump(reason, detail)
    # graftlint: ok(swallow: the recorder must never turn a crash dump into a second crash)
    except Exception:
        return None


def note_flight(**event) -> None:
    """Annotate the active recorder's event ring (no-op when none)."""
    rec = _recorder
    if rec is not None:
        rec.note(**event)


def validate_flight_dump(payload) -> list[str]:
    """Structural errors for one flight_<reason>.json payload (empty list
    = valid) — the shape scripts/check_telemetry_schema.py enforces."""
    if not isinstance(payload, dict):
        return [f"dump is {type(payload).__name__}, not an object"]
    errors = []
    if payload.get("v") != FLIGHT_VERSION:
        errors.append(f"missing/unknown flight version {payload.get('v')!r}")
    if not isinstance(payload.get("reason"), str) or not payload.get("reason"):
        errors.append("missing/empty 'reason'")
    if not isinstance(payload.get("t"), (int, float)):
        errors.append("missing/non-numeric 't'")
    spans = payload.get("spans")
    if not isinstance(spans, list):
        errors.append("'spans' is not a list")
        spans = []
    for i, row in enumerate(spans):
        if not isinstance(row, dict):
            errors.append(f"spans[{i}] is not an object")
            continue
        for field in ("trace_id", "span_id", "name"):
            if not isinstance(row.get(field), str):
                errors.append(f"spans[{i}]: missing/non-str {field!r}")
        for field in ("start_s", "dur_s"):
            if not isinstance(row.get(field), (int, float)):
                errors.append(f"spans[{i}]: missing/non-numeric {field!r}")
    events = payload.get("events")
    if not isinstance(events, list):
        errors.append("'events' is not a list")
    else:
        for i, ev in enumerate(events):
            if not isinstance(ev, dict):
                errors.append(f"events[{i}] is not an object")
    return errors
