"""Request-scoped span tracing across the serve pipeline's thread seams.

A request entering ``serve.py`` crosses four asynchronous boundaries —
the HTTP handler thread, the micro-batcher worker, the fleet prefetch
threads, and the engine's async dispatch — and since PR 1 every one of
them has emitted *flat* rows that cannot be joined back into "where did
this request's 240 ms go?". This module adds the join key: every unit of
work runs under a :class:`Span` carrying a ``(trace_id, span_id)``
context, propagated within a thread by a ``contextvars.ContextVar`` and
across threads by explicitly capturing :func:`current_ctx` into whatever
object crosses the seam (a ``_Pending`` queue entry, a prefetch closure).

Finished spans become schema-versioned ``span`` rows in the run's
``telemetry.jsonl`` (see ``obs/schema.py``) and fan out to registered
sinks — the resil flight recorder rings them, ``serve_bench`` aggregates
them — while stage-tagged spans also feed the live metrics histograms
(``obs/metrics.py``). ``scripts/trace_view.py`` exports any span source
to Chrome-trace JSON for chrome://tracing / Perfetto.

Everything here is host-side Python: no torch import, no work inside a
jitted body, and a disabled tracer costs one attribute load plus a null
context manager per call site, preserving the zero-steady-state-recompile
invariant (asserted with tracing ON in tests/test_serve.py).

Span identities come from a process-local counter, not ``uuid4`` — runs
are deterministic under a seeded test and ids stay 8 hex chars. Clocks
are injectable (tests pass a fake; production uses ``perf_counter``).
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from contextlib import contextmanager

from .emit import get_emitter

# sentinel: "inherit the calling thread's current span as parent"
_INHERIT = object()

# the HTTP header that carries a span context across a process boundary
# (W3C-traceparent-shaped: one value, ids joined by a dash)
TRACE_HEADER = "Traceparent"

_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "obs_trace_current", default=None
)


class SpanContext:
    """The portable half of a span: what crosses a thread seam — or, via
    :meth:`to_header` / :meth:`from_header`, a process boundary."""

    __slots__ = ("trace_id", "span_id", "remote")

    def __init__(self, trace_id: str, span_id: str, remote: bool = False):
        self.trace_id = trace_id
        self.span_id = span_id
        # True when this ctx was restored from a header: children record
        # ``remote_parent`` so fleet merges can tell propagated parents
        # from locally-missing ones
        self.remote = bool(remote)

    def to_header(self) -> str:
        """``trace_id-span_id`` — ids are alphanumeric by construction
        (hex counters, sanitized prefixes), so the dash is unambiguous."""
        return f"{self.trace_id}-{self.span_id}"

    @classmethod
    def from_header(cls, value: str | None) -> "SpanContext | None":
        """Parse a :data:`TRACE_HEADER` value; None on anything
        malformed (propagation must never fail a request)."""
        if not value or not isinstance(value, str):
            return None
        trace_id, sep, span_id = value.strip().rpartition("-")
        if not sep or not trace_id or not span_id:
            return None
        if not (trace_id.isalnum() and span_id.isalnum()):
            return None
        return cls(trace_id, span_id, remote=True)

    def __repr__(self) -> str:  # debugging aid only
        flag = "!remote" if self.remote else ""
        return f"SpanContext({self.trace_id}/{self.span_id}{flag})"


def trace_headers(ctx: "SpanContext | None" = None) -> dict[str, str]:
    """Headers to stamp on an outbound fleet HTTP call: the given ctx
    (or the calling thread's current one) as :data:`TRACE_HEADER`, or
    ``{}`` when there is nothing to propagate."""
    if ctx is None:
        ctx = current_ctx()
    if ctx is None:
        return {}
    return {TRACE_HEADER: ctx.to_header()}


class Span:
    """One timed unit of work. Created by :meth:`Tracer.span`; finished
    rows carry name/start/dur plus whatever attributes the body ``set``."""

    __slots__ = ("tracer", "name", "context", "parent_id", "start_s", "attrs")

    def __init__(self, tracer: "Tracer", name: str, context: SpanContext,
                 parent_id: str | None, start_s: float, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.context = context
        self.parent_id = parent_id
        self.start_s = start_s
        self.attrs = attrs

    @property
    def ctx(self) -> SpanContext:
        return self.context

    def set(self, **attrs) -> "Span":
        """Attach attributes discovered mid-span (tier picked at cut time,
        ``joined`` source of a prefetch, error status)."""
        self.attrs.update(attrs)
        return self


class _NullSpan:
    """What a disabled tracer hands out: absorbs the span protocol for
    free so call sites never branch on ``tracer.enabled``."""

    __slots__ = ()
    ctx = None
    context = None
    parent_id = None

    def set(self, **attrs) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class Tracer:
    """Span factory + sink fan-out. One per process via :func:`get_tracer`;
    tests construct their own with a fake clock for determinism."""

    def __init__(self, enabled: bool = False, clock=time.perf_counter,
                 id_prefix: str = ""):
        self.enabled = bool(enabled)
        self.clock = clock
        # ids must stay alphanumeric (the header joins them with a dash,
        # from_header splits on it) — strip anything else from the prefix
        self.id_prefix = "".join(c for c in str(id_prefix) if c.isalnum())
        self._ids = itertools.count(1)
        self._id_lock = threading.Lock()
        self._sinks: list = []
        self.n_spans = 0
        self.n_remote_parented = 0
        self.n_dropped_sink = 0

    # -- ids / clock ---------------------------------------------------------

    def _next_id(self) -> str:
        with self._id_lock:
            return f"{self.id_prefix}{next(self._ids):08x}"

    def now(self) -> float:
        """The tracer's clock — call sites stamp seam-crossing times with
        this so explicit-time spans share one timebase."""
        return self.clock()

    # -- sinks ---------------------------------------------------------------

    def add_sink(self, sink) -> None:
        """``sink(row: dict)`` is called with every finished span row (the
        flight recorder's ring, serve_bench's aggregator)."""
        if sink not in self._sinks:
            self._sinks.append(sink)

    def remove_sink(self, sink) -> None:
        if sink in self._sinks:
            self._sinks.remove(sink)

    # -- span lifecycle ------------------------------------------------------

    def _resolve_parent(self, parent) -> tuple[str, str | None, bool]:
        """(trace_id, parent_span_id, remote) for a new span. ``parent``
        is the _INHERIT sentinel (use this thread's current span), None
        (new root/trace), or an explicit SpanContext carried across a
        seam — possibly one restored from a :data:`TRACE_HEADER`."""
        if parent is _INHERIT:
            cur = _current.get()
            parent = cur.context if cur is not None else None
        if parent is None:
            return self._next_id(), None, False
        return (parent.trace_id, parent.span_id,
                bool(getattr(parent, "remote", False)))

    @contextmanager
    def span(self, name: str, *, parent=_INHERIT, **attrs):
        """Run the body under a new span; the span becomes the thread's
        current context for the duration (children nest automatically).
        An escaping exception stamps ``status: error:<Type>`` and
        re-raises — tracing never swallows."""
        if not self.enabled:
            yield _NULL_SPAN
            return
        trace_id, parent_id, remote = self._resolve_parent(parent)
        ctx = SpanContext(trace_id, self._next_id())
        sp = Span(self, name, ctx, parent_id, self.clock(), dict(attrs))
        if remote:
            sp.attrs.setdefault("remote_parent", True)
        token = _current.set(sp)
        try:
            yield sp
        except BaseException as exc:
            sp.attrs.setdefault("status", f"error:{type(exc).__name__}")
            raise
        finally:
            _current.reset(token)
            self._finish(sp, self.clock())

    def record(self, name: str, *, start_s: float, end_s: float | None = None,
               dur_s: float | None = None, parent=_INHERIT, **attrs) -> None:
        """Emit an already-elapsed span from explicit timestamps — the
        shape for intervals observed after the fact (queue wait measured
        at cut time, scatter measured per-request inside the batch)."""
        if not self.enabled:
            return
        trace_id, parent_id, remote = self._resolve_parent(parent)
        ctx = SpanContext(trace_id, self._next_id())
        sp = Span(self, name, ctx, parent_id, start_s, dict(attrs))
        if remote:
            sp.attrs.setdefault("remote_parent", True)
        if dur_s is None:
            dur_s = (end_s if end_s is not None else self.clock()) - start_s
        self._finish(sp, start_s + max(0.0, dur_s))

    def _finish(self, sp: Span, end_s: float) -> None:
        row = {
            "trace_id": sp.context.trace_id,
            "span_id": sp.context.span_id,
            "name": sp.name,
            "start_s": sp.start_s,
            "dur_s": max(0.0, end_s - sp.start_s),
            "parent_id": sp.parent_id,
            "thread": threading.current_thread().name,
            **sp.attrs,
        }
        self.n_spans += 1
        if row.get("remote_parent"):
            self.n_remote_parented += 1
        # graftlint: ok(emit-hot: span finish is the telemetry boundary itself, host-side after dispatch)
        get_emitter().emit("span", **row)
        stage = row.get("stage")
        if stage is not None:
            from .metrics import get_metrics

            # graftlint: ok(emit-hot: fixed-bucket histogram update, lock-cheap host-side)
            get_metrics().observe("serve_stage_seconds", row["dur_s"],
                                  stage=str(stage))
        for sink in list(self._sinks):
            try:
                sink(row)
            # graftlint: ok(swallow: a broken sink must not fail the traced request; the drop is counted and surfaced via stats()/healthz)
            except Exception:
                self.n_dropped_sink += 1

    def stats(self) -> dict:
        """Tracing health for ``/healthz`` and heartbeats: spans emitted,
        sink drops, and how many spans parented under a remote ctx."""
        return {
            "enabled": self.enabled,
            "spans": self.n_spans,
            "dropped_sink": self.n_dropped_sink,
            "remote_parented": self.n_remote_parented,
        }


def current_ctx() -> SpanContext | None:
    """The calling thread's current span context, or None — what gets
    captured into a queue entry / closure to cross a thread seam."""
    cur = _current.get()
    return cur.context if cur is not None else None


def current_span() -> Span | None:
    """The live span itself, for attaching attributes from deep callees
    (``acquire`` marking a prefetch join on whatever span is running)."""
    return _current.get()


_tracer = Tracer(enabled=False)


def get_tracer() -> Tracer:
    """The process's tracer (disabled until :func:`configure_tracing`)."""
    return _tracer


def configure_tracing(enabled: bool = True, clock=None,
                      id_prefix: str = "") -> Tracer:
    """Replace the process tracer (serve.py startup, test setup). A fresh
    tracer resets the id counter — deterministic ids per configure.
    ``id_prefix`` (e.g. the replica id) keeps span ids unique across the
    fleet so a ``--fleet`` merge joins on propagated ids collision-free."""
    global _tracer
    _tracer = Tracer(enabled=enabled, clock=clock or time.perf_counter,
                     id_prefix=id_prefix)
    return _tracer
