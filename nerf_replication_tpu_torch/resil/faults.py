"""Deterministic fault injection: failure as a first-class input.

Every reactive fix so far (the donated-buffer corruption, torn
bundle/sidecar pairs, the silent AOT-serialization skip) started as a
fault nobody could reproduce on demand. This module inverts that: the
library is instrumented with NAMED fault points, and a seeded
:class:`FaultPlan` decides — deterministically — which hits of which
point inject which fault. The same plan + seed always produces the same
failure schedule, so a chaos test is as reproducible as a unit test.

Fault kinds:

==========  ===============================================================
kind        behavior at the fault point
==========  ===============================================================
io_error    raise ``OSError`` (the retry/degrade paths must absorb it)
truncate    truncate the file at ``path`` on disk (torn-artifact simulation)
latency     ``sleep(delay_s)`` then continue (slow disk / network stall)
nan_loss    no side effect — the call site reads the returned spec and
            poisons its already-fetched loss scalar (train.loss only)
kill        raise :class:`SimulatedKill` (a ``BaseException``): the hard
            stop that ``except Exception`` recovery code must NOT absorb
==========  ===============================================================

Injection is host-side only — no fault point lives inside a jitted body,
so a chaos run compiles exactly the executables a clean run does (the
zero-steady-state-recompile invariant the chaos suite asserts).

Detected (not injected) faults — checksum mismatches, torn checkpoint
dirs, crashed worker threads — ride the same ``fault`` telemetry kind via
:func:`report` with ``injected: false``, so ``tlm_report`` summarizes
chaos and the wild identically.
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

from ..obs.emit import get_emitter
from .flight import note_flight

# The named fault points the library is instrumented with. A FaultSpec
# naming anything else is rejected at construction, so a chaos plan can
# never silently target nothing. (docs/robustness.md catalogs each.)
FAULT_POINTS: tuple[str, ...] = (
    "checkpoint.save",          # train/checkpoint.py: before the bundle write
    "checkpoint.save.sidecar",  # between bundle and sidecars (torn-dir window)
    "checkpoint.load",          # train/checkpoint.py: before the restore
    "artifact.save",            # compile/artifacts.py: before the .aot write
    "artifact.load",            # compile/artifacts.py: before the .aot read
    "occupancy.load",           # renderer/occupancy.py: before the .npz read
    "serve.dispatch",           # serve/engine.py: per-bucket dispatch
    "serve.flush",              # serve/batcher.py: worker batch flush
    "train.loss",               # train loop's fetched loss scalar (nan_loss)
    "fleet.load",               # fleet/residency.py: before a scene load
    "fleet.publish",            # fleet/publish.py: before a hot-update gate
)

FAULT_KINDS: tuple[str, ...] = (
    "io_error", "truncate", "latency", "nan_loss", "kill"
)


class SimulatedKill(BaseException):
    """kill-at-point: the process "dies" here. Deliberately a
    ``BaseException`` — recovery code catching ``Exception`` must not
    absorb a kill, exactly like a real SIGKILL."""


@dataclass(frozen=True)
class FaultSpec:
    """One injection rule: at ``point``, after letting ``after`` hits
    through, inject ``kind`` on up to ``times`` hits (None = every hit),
    each hit firing with probability ``prob`` (drawn from the plan's
    seeded stream)."""

    point: str
    kind: str
    after: int = 0
    times: int | None = 1
    prob: float = 1.0
    delay_s: float = 0.05

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r} (known: "
                f"{', '.join(FAULT_POINTS)})"
            )
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (known: "
                f"{', '.join(FAULT_KINDS)})"
            )


class FaultPlan:
    """A seeded, deterministic schedule of fault injections.

    Thread-safe: hit counting and the probability stream sit under one
    lock, so a given single-threaded call sequence always injects the
    same faults (the serve worker adds interleaving, but each test drives
    the batcher synchronously via ``pump()`` where determinism matters).
    """

    def __init__(self, specs=(), seed: int = 0):
        self.specs: list[FaultSpec] = list(specs)
        self.seed = seed
        self._rng = random.Random(seed)
        self._hits: dict[str, int] = {}
        self._fired: dict[int, int] = {}
        self._lock = threading.Lock()

    def add(self, point: str, kind: str, **kw) -> "FaultPlan":
        """Append one rule (chainable): ``plan.add("artifact.load",
        "io_error", times=2)``."""
        self.specs.append(FaultSpec(point, kind, **kw))
        return self

    def hit(self, point: str) -> FaultSpec | None:
        """Record one arrival at ``point``; the spec to inject, if any."""
        with self._lock:
            n = self._hits.get(point, 0)
            self._hits[point] = n + 1
            for i, spec in enumerate(self.specs):
                if spec.point != point or n < spec.after:
                    continue
                fired = self._fired.get(i, 0)
                if spec.times is not None and fired >= spec.times:
                    continue
                if spec.prob < 1.0 and self._rng.random() >= spec.prob:
                    continue
                self._fired[i] = fired + 1
                return spec
        return None

    def counts(self) -> dict[str, int]:
        """Total arrivals per point (injected or not)."""
        with self._lock:
            return dict(self._hits)

    def injected(self) -> int:
        """Total injections performed so far."""
        with self._lock:
            return sum(self._fired.values())


# one active plan per process — None means every fault point is free
_active_plan: FaultPlan | None = None


def install(plan: FaultPlan) -> FaultPlan:
    global _active_plan
    _active_plan = plan
    return plan


def uninstall() -> None:
    global _active_plan
    _active_plan = None


def active() -> FaultPlan | None:
    return _active_plan


@contextmanager
def injecting(plan: FaultPlan):
    """``with injecting(plan): ...`` — install for the block, always
    uninstall (even across a SimulatedKill)."""
    install(plan)
    try:
        yield plan
    finally:
        uninstall()


def fault_point(point: str, path: str | None = None,
                step: int | None = None) -> FaultSpec | None:
    """The library-side hook: a no-op (one global read) when no plan is
    installed. Side-effect faults (io_error/latency/truncate/kill) act
    before returning; value faults (nan_loss) return the spec for the
    call site to apply. Every injection emits one ``fault`` row."""
    plan = _active_plan
    if plan is None:
        return None
    spec = plan.hit(point)
    if spec is None:
        return None
    fields: dict = {"injected": True, "hit": plan.counts().get(point, 0)}
    if path is not None:
        fields["path"] = str(path)
    if step is not None:
        fields["step"] = int(step)
    if spec.kind == "latency":
        fields["delay_s"] = spec.delay_s
    get_emitter().emit("fault", point=point, fault=spec.kind, **fields)
    # same row into the flight recorder's event ring, so a post-mortem
    # dump names the injected fault next to the span timeline
    note_flight(point=point, fault=spec.kind, **fields)
    if spec.kind == "latency":
        time.sleep(spec.delay_s)
    elif spec.kind == "truncate":
        if path is not None:
            truncate_file(path)
    elif spec.kind == "io_error":
        raise OSError(f"injected fault at {point}"
                      + (f" ({path})" if path else ""))
    elif spec.kind == "kill":
        raise SimulatedKill(point)
    return spec


def truncate_file(path: str, frac: float = 0.5) -> None:
    """Tear a file on disk: keep the leading ``frac`` of its bytes.

    A directory path (a scene checkpoint, an orbax bundle) tears its
    largest file — deterministic, and the most likely victim of a real
    torn write — so ``truncate`` faults compose with dir-level artifacts
    and their tree checksums."""
    try:
        import os

        if os.path.isdir(path):
            files = sorted(
                (os.path.getsize(os.path.join(d, f)),
                 os.path.join(d, f))
                for d, _dirs, fnames in os.walk(path) for f in fnames
                if not f.endswith(".sha256")
            )
            if not files:
                return
            path = files[-1][1]
        size = os.path.getsize(path)
        with open(path, "r+b") as fh:
            fh.truncate(max(0, int(size * frac)))
    except OSError:
        pass  # a missing file is already as torn as it gets


def report(point: str, fault: str, *, path: str | None = None,
           detail: str | None = None, step: int | None = None) -> None:
    """Record a DETECTED fault (``injected: false``): checksum mismatch,
    torn checkpoint dir, crashed worker — same telemetry kind as chaos
    injections, so report/diff treat them uniformly."""
    fields: dict = {"injected": False}
    if path is not None:
        fields["path"] = str(path)
    if detail is not None:
        fields["detail"] = str(detail)
    if step is not None:
        fields["step"] = int(step)
    get_emitter().emit("fault", point=point, fault=fault, **fields)
    note_flight(point=point, fault=fault, **fields)
