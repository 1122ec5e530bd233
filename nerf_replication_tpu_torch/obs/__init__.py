"""Run-scoped telemetry (port of ``nerf_replication_tpu/obs``).

Every entry point (the trainers, ``run``, the server) writes through one
schema-versioned JSONL emitter: a single ``telemetry.jsonl`` per run dir
with typed rows — ``run_meta`` / ``step`` / ``epoch`` / ``eval`` /
``compile`` / ``memory`` / ``heartbeat`` / ``fault`` / ``span`` ... —
chief-guarded and flushed crash-safely; the JAX package's
``scripts/tlm_report.py`` and ``scripts/check_telemetry_schema.py`` read
the port's runs as they read its own.

``obs.hooks.CompileTracker`` makes each CUDA-graph capture and kernel
library build a ``compile`` row, ``obs.hooks.sample_memory`` snapshots
the caching allocator per card, the trainers' dispatch-vs-block step-time
split tells latency-bound from compute-bound regressions,
``obs.profiling.ProfileWindow`` runs ``torch.profiler`` over a configured
step window, and ``obs.metrics`` / ``obs.trace`` are the serving path's
live aggregates (``GET /metrics``) and request spans. In-process readers
subscribe to the row stream with ``add_row_tap``.

The ops-intelligence layer closes the loop from telemetry to action:
``obs/alerts.py`` (multi-window multi-burn-rate SLO alerting),
``obs/incidents.py`` (auto-correlated incident reports with an
open→mitigated→resolved lifecycle), and ``obs/capacity.py`` (the
per-scene capacity/heat ledger the placement planner reads) — all fed
in-process from the emitter's row-tap bus (``add_row_tap``).
"""

from .alerts import AlertEngine, AlertOptions
from .capacity import CapacityLedger

from .emit import (
    Emitter,
    NullEmitter,
    add_row_tap,
    append_jsonl,
    get_emitter,
    init_run,
    remove_row_tap,
)
from .hooks import CompileTracker, sample_memory
from .incidents import IncidentManager, validate_incident_dump
from .metrics import MetricsRegistry, WindowRing, get_metrics, reset_metrics
from .profiling import ProfileWindow, annotate
from .schema import SCHEMA_VERSION, validate_bench_row, validate_row
from .trace import (
    TRACE_HEADER,
    Span,
    SpanContext,
    Tracer,
    configure_tracing,
    current_ctx,
    current_span,
    get_tracer,
    trace_headers,
)

__all__ = [
    "SCHEMA_VERSION",
    "TRACE_HEADER",
    "AlertEngine",
    "AlertOptions",
    "CapacityLedger",
    "Emitter",
    "IncidentManager",
    "MetricsRegistry",
    "NullEmitter",
    "CompileTracker",
    "ProfileWindow",
    "Span",
    "SpanContext",
    "Tracer",
    "WindowRing",
    "add_row_tap",
    "annotate",
    "append_jsonl",
    "configure_tracing",
    "current_ctx",
    "current_span",
    "get_emitter",
    "get_metrics",
    "get_tracer",
    "init_run",
    "remove_row_tap",
    "reset_metrics",
    "sample_memory",
    "trace_headers",
    "validate_bench_row",
    "validate_incident_dump",
    "validate_row",
]
