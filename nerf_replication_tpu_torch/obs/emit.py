"""Schema-versioned JSONL emitter: one ``telemetry.jsonl`` per run dir
(port of ``nerf_replication_tpu/obs/emit.py``).

Chief-guarded like ``Recorder`` (non-chief processes construct a no-op
emitter, so call sites never branch on rank) and flushed crash-safely:
every row is one ``write`` of a full line on a line-buffered handle,
fsync'd periodically and at close, so a SIGKILL mid-run loses at most the
rows since the last sync and can never tear a line in half.

The module keeps one active emitter per process (``init_run`` /
``get_emitter``) so deep call sites — the trainer's epoch loop, the
recorder's val records, the render gate — reach the run's stream without
threading it through every signature.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

from .schema import SCHEMA_VERSION

# -- row taps ----------------------------------------------------------------
# In-process consumers of the telemetry stream (the alert engine, the
# incident correlator, the capacity ledger — obs/alerts.py etc.) subscribe
# here and see every emitted row as a dict, the same pattern as
# ``Tracer.add_sink``. Taps fire on BOTH emitters — a non-chief process
# (NullEmitter) still feeds its local engines even though nothing reaches
# disk — and a raising tap is dropped from the fan-out, never allowed to
# break emission.

_row_taps: list = []


def add_row_tap(fn) -> None:
    """Subscribe ``fn(row_dict)`` to every emitted telemetry row."""
    if fn not in _row_taps:
        _row_taps.append(fn)


def remove_row_tap(fn) -> None:
    try:
        _row_taps.remove(fn)
    except ValueError:
        pass


def _fire_row_taps(row: dict) -> None:
    for fn in list(_row_taps):
        try:
            fn(row)
        # graftlint: ok(swallow: a broken tap must not break telemetry emission; it is dropped from the fan-out)
        except Exception:
            remove_row_tap(fn)


class NullEmitter:
    """No-op emitter: what non-chief processes (and uninitialized call
    sites) write through, so emission is unconditional at call sites.
    Row taps still fire — in-process consumers see the stream even when
    nothing reaches disk."""

    chief = False
    path = None
    run_id = ""

    def emit(self, kind: str, **fields) -> None:
        if _row_taps:
            _fire_row_taps(
                {"v": SCHEMA_VERSION, "kind": kind, "t": time.time(),
                 **fields})

    def close(self) -> None:
        pass


class Emitter:
    """Append typed rows to a JSONL file; rows stamped {v, kind, t}."""

    FSYNC_EVERY = 50  # rows between fsyncs (every row is still flushed)

    def __init__(self, path: str, chief: bool = True, run_id: str | None = None):
        self.chief = chief
        self.path = path
        self.run_id = run_id or f"{int(time.time())}-{os.getpid()}"
        self._fh = None
        self._rows_since_sync = 0
        if not chief:
            return
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # append: a resumed run adds a new run_meta row to the same file
        # rather than destroying the previous run's telemetry
        self._fh = open(path, "a", buffering=1)

    def emit(self, kind: str, **fields) -> None:
        if self._fh is None:
            return
        row = {"v": SCHEMA_VERSION, "kind": kind, "t": time.time(), **fields}
        self._fh.write(json.dumps(row, default=_jsonable) + "\n")
        self._rows_since_sync += 1
        if self._rows_since_sync >= self.FSYNC_EVERY:
            self._sync()
        if _row_taps:
            _fire_row_taps(row)

    def _sync(self) -> None:
        try:
            os.fsync(self._fh.fileno())
        except OSError:
            pass
        self._rows_since_sync = 0

    def close(self) -> None:
        if self._fh is not None:
            self._sync()
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _jsonable(value):
    """Last-resort coercion for device scalars/arrays reaching emit()."""
    try:
        import numpy as np

        if isinstance(value, np.generic):
            return value.item()
        if isinstance(value, np.ndarray):
            return value.tolist()
    # graftlint: ok(swallow: telemetry layer itself; str() fallback below is the record)
    except Exception:
        pass
    return str(value)


_active: Emitter | NullEmitter = NullEmitter()


def get_emitter() -> Emitter | NullEmitter:
    """The process's active emitter (NullEmitter before init_run)."""
    return _active


def config_hash(cfg) -> str:
    """Stable short hash of the merged config (run identity for diffs)."""
    try:
        dump = cfg.dump()
    # graftlint: ok(swallow: repr fallback is still hashed into the run identity)
    except Exception:
        dump = repr(cfg)
    return hashlib.sha256(dump.encode()).hexdigest()[:12]


def is_chief() -> bool:
    """Rank 0 of ``torch.distributed`` when a process group exists, else
    true: the one process that writes telemetry."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def _devices() -> tuple[str, int, str]:
    """``(platform, device_count, device_kind)`` of this process."""
    import torch

    if torch.cuda.is_available():
        return ("gpu", torch.cuda.device_count(),
                torch.cuda.get_device_name(0))
    return "cpu", 1, "cpu"


def init_run(cfg, component: str = "train", path: str | None = None):
    """Open the run's telemetry stream and emit its ``run_meta`` row.

    ``path`` defaults to ``<cfg.record_dir>/telemetry.jsonl`` — run-scoped
    the same way the TensorBoard events are. Only the chief process writes
    (every process still gets a valid no-op emitter back). Re-initializing
    (a second fit() in-process, tests) closes the previous stream.
    """
    global _active
    import torch
    import torch.distributed as dist

    _active.close()
    if path is None:
        telem_dir = str(cfg.get("record_dir", "."))
        path = os.path.join(telem_dir, "telemetry.jsonl")
    emitter = Emitter(path, chief=is_chief())
    grouped = dist.is_available() and dist.is_initialized()
    platform, device_count, device_kind = _devices()
    emitter.emit(
        "run_meta",
        run_id=emitter.run_id,
        component=component,
        config_hash=config_hash(cfg),
        task=str(cfg.get("task", "")),
        scene=str(cfg.get("scene", "")),
        exp_name=str(cfg.get("exp_name", "")),
        process_index=dist.get_rank() if grouped else 0,
        process_count=dist.get_world_size() if grouped else 1,
        device_count=device_count,
        local_device_count=device_count,
        platform=platform,
        device_kind=device_kind,
        argv=list(sys.argv),
        torch_version=torch.__version__,
    )
    _active = emitter
    return emitter


def append_jsonl(path: str, row: dict) -> None:
    """One-shot append of a bench-style row (crash-safe single write).

    The bench scripts' shared write path: one JSON line per call, parent
    dir created, file flushed before return — so a killed sweep keeps
    every completed point.
    """
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a", buffering=1) as fh:
        fh.write(json.dumps(row, default=_jsonable) + "\n")
        fh.flush()
        try:
            os.fsync(fh.fileno())
        except OSError:
            pass
