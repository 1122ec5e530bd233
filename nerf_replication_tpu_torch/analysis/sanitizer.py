"""Runtime companion to the static pass: assert a code region is clean
(port of ``nerf_replication_tpu/analysis/sanitizer.py``).

``with sanitizer(tracker):`` brackets a steady-state region (replayed
train steps, a serving request stream) and raises :class:`SanitizerError`
on exit if the region compiled: ``tracker`` is the port's
:class:`~..obs.hooks.CompileTracker` (a row per CUDA-graph capture and
kernel-library build), or anything with ``total_compiles()``, such as
``RenderEngine`` (``nvcc`` builds plus captures after warm-up).
``syncs="error"`` (the default) additionally arms
``torch.cuda.set_sync_debug_mode`` for the region, so a call that makes
the host wait for the card (``.item()``, ``.cpu()``, a copy from a host
tensor, ``nonzero``) raises AT the offending call instead of showing up
later as a dispatch stall; ``syncs="warn"`` warns at each such call
instead. The previous mode comes back on every exit, a raise included.

Two differences from JAX's ``transfers`` guard:

* the mode is process-wide (torch's own switch), where
  ``jax.transfer_guard`` is per thread: a sanitized region sees the syncs
  of every thread of the process, and two regions must not overlap;
* it flags every synchronizing copy, an explicit ``.cpu()`` included,
  where JAX lets ``jax.device_get`` through.

Without CUDA, asking for ``syncs`` raises :class:`SanitizerError` (the
guard is never left silently unarmed); CPU callers pass ``syncs=None``.

Typical usage (tests/test_torch_cuda_sanitizer.py, chip_smoke.py phase
22)::

    trainer.aot_register_steps(state, bank)      # captures, outside
    trainer.step(state, *bank)                   # one warm replay
    with sanitizer(trainer.tracker, syncs="error") as probe:
        for _ in range(20):
            state, stats = trainer.step(state, *bank)   # a sync -> raises
    assert probe.compiles == 0

Only this module imports torch, and only inside :func:`sanitizer`.
"""

from __future__ import annotations

from contextlib import ExitStack, contextmanager
from dataclasses import dataclass, field

# torch.cuda.set_sync_debug_mode's levels, by name
SYNC_MODES = ("default", "warn", "error")


class SanitizerError(AssertionError):
    """A sanitized region compiled unexpectedly, or its sync guard could not
    be armed."""


@dataclass
class SanitizerProbe:
    """What the region did; populated on (clean) exit."""

    compiles: int = 0
    allow_compiles: int = 0
    compile_names: dict = field(default_factory=dict)


@contextmanager
def _sync_guard(mode: str, name: str):
    """``torch.cuda.set_sync_debug_mode(mode)`` for the block; the mode the
    process had before comes back on every exit."""
    import torch

    if mode not in SYNC_MODES[1:]:
        raise SanitizerError(f"{name}: syncs={mode!r} is not one of "
                             f"{SYNC_MODES[1:]} (or None)")
    if not torch.cuda.is_available():
        raise SanitizerError(
            f"{name}: syncs={mode!r} needs CUDA (torch.cuda."
            "set_sync_debug_mode), which this host does not have; pass "
            "syncs=None to check compiles only")
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)


@contextmanager
def sanitizer(
    tracker=None,
    syncs: str | None = "error",
    allow_compiles: int = 0,
    name: str = "sanitizer",
):
    """Assert zero-compile / zero-sync over a region.

    ``tracker``: a CompileTracker (or an engine) whose total_compiles()
    must not grow by more than ``allow_compiles`` inside the region (None
    skips the check). ``syncs``: the sync debug mode for the region —
    "error" (default), "warn", or None to leave syncs unguarded (the only
    choice on a host without CUDA). Yields a :class:`SanitizerProbe`
    filled in on exit.
    """
    probe = SanitizerProbe(allow_compiles=allow_compiles)
    counts = getattr(tracker, "counts", None)
    before_total = tracker.total_compiles() if tracker is not None else 0
    before_counts = dict(counts()) if counts is not None else {}
    with ExitStack() as stack:
        if syncs is not None:
            stack.enter_context(_sync_guard(syncs, name))
        yield probe
    if tracker is not None:
        probe.compiles = tracker.total_compiles() - before_total
        probe.compile_names = {
            k: v - before_counts.get(k, 0)
            for k, v in (counts() if counts is not None else {}).items()
            if v - before_counts.get(k, 0) > 0
        }
        if probe.compiles > allow_compiles:
            raise SanitizerError(
                f"{name}: {probe.compiles} compile(s) inside a sanitized "
                f"region (allowed {allow_compiles}) — a capture or kernel "
                f"build in the steady state; offenders: "
                f"{probe.compile_names} — capture every shape during "
                "warm-up or pad into buckets"
            )


# --------------------------------------------------------------------------
# runtime lock-order sanitizer — the dynamic witness for R10 (lock-order)
# --------------------------------------------------------------------------


class LockOrderError(AssertionError):
    """Two threads acquired instrumented locks in conflicting orders."""


class _InstrumentedLock:
    """Transparent proxy: records edges in the recorder, forwards the
    rest. ``wait``/``notify`` keep working because the INNER lock really
    is acquired — the proxy only observes."""

    __slots__ = ("_rec", "_name", "_inner")

    def __init__(self, recorder: "LockOrderRecorder", name: str, inner):
        self._rec = recorder
        self._name = name
        self._inner = inner

    def acquire(self, *a, **kw):
        # inner first, record second: the recorder's own mutex is only
        # ever taken AFTER a real lock, never around one — the
        # instrumentation cannot itself create a lock-order cycle
        got = self._inner.acquire(*a, **kw)
        if got:
            self._rec._note_acquire(self._name)
        return got

    def release(self, *a, **kw):
        self._rec._note_release(self._name)
        return self._inner.release(*a, **kw)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, attr):
        return getattr(self._inner, attr)


class LockOrderRecorder:
    """Per-thread acquisition-order DAG over instrumented locks.

    Wrap the fleet's locks (``instrument(obj, "_lock")`` swaps the
    attribute for a recording proxy), run the live multi-threaded
    traffic, then ``assert_acyclic()`` at teardown: a cycle in the
    observed held->acquired edges is the dynamic witness of the deadlock
    R10 reports statically, and the error names the two stacks."""

    def __init__(self):
        import threading

        self._mu = threading.Lock()       # guards edges/threads maps only
        self._tls = threading.local()     # per-thread held stack
        self._names: list[str] = []
        # (held, acquired) -> (stack_held, stack_acquired, thread_name)
        self.edges: dict = {}
        self.n_acquires = 0
        self._threads: set = set()

    # -- instrumentation -------------------------------------------------------

    def wrap(self, name: str, lock) -> _InstrumentedLock:
        with self._mu:
            if name not in self._names:
                self._names.append(name)
        return _InstrumentedLock(self, name, lock)

    def instrument(self, obj, *attrs, cls_name: str | None = None) -> None:
        """Swap ``obj.<attr>`` for a recording proxy, named
        ``ClassName.attr`` to match the static lock model's spelling."""
        prefix = cls_name or type(obj).__name__
        for attr in attrs:
            inner = getattr(obj, attr)
            if isinstance(inner, _InstrumentedLock):
                continue
            setattr(obj, attr, self.wrap(f"{prefix}.{attr}", inner))

    # -- recording (called from the proxies) -----------------------------------

    def _stack(self) -> list[str]:
        import traceback

        # drop the two proxy/recorder frames at the top
        return [ln.rstrip() for ln in traceback.format_stack()[:-2][-8:]]

    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _note_acquire(self, name: str) -> None:
        import threading

        held = self._held()
        first = name not in [h for h, _ in held]
        stack = self._stack() if first else None
        if first:
            tname = threading.current_thread().name
            with self._mu:
                self.n_acquires += 1
                self._threads.add(tname)
                for h, hstack in held:
                    if h == name:
                        continue
                    self.edges.setdefault(
                        (h, name), (hstack, stack, tname))
        # re-entrant re-acquires still push, for release balancing
        held.append((name, stack))

    def _note_release(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                del held[i]
                return

    # -- teardown assertions ---------------------------------------------------

    def find_cycle(self) -> list[str] | None:
        graph: dict[str, set] = {}
        for a, b in self.edges:
            graph.setdefault(a, set()).add(b)
        on_path: list[str] = []
        visited: set = set()

        def dfs(n: str) -> list[str] | None:
            if n in on_path:
                return on_path[on_path.index(n):] + [n]
            if n in visited or n not in graph:
                return None
            visited.add(n)
            on_path.append(n)
            for nxt in sorted(graph[n]):
                cyc = dfs(nxt)
                if cyc:
                    return cyc
            on_path.pop()
            return None

        for start in sorted(graph):
            cyc = dfs(start)
            if cyc:
                return cyc
        return None

    def assert_acyclic(self, name: str = "lock-order") -> None:
        cycle = self.find_cycle()
        if cycle is None:
            return
        pairs = [(a, b) for a, b in zip(cycle, cycle[1:])
                 if (a, b) in self.edges]
        detail = []
        for a, b in pairs[:2]:
            hstack, astack, tname = self.edges[(a, b)]
            frames = "\n".join((astack or hstack or ["<no stack>"])[-3:])
            detail.append(
                f"{a} -> {b} (thread {tname}):\n{frames}")
        raise LockOrderError(
            f"{name}: lock-order cycle {' -> '.join(cycle)} observed at "
            "runtime — two threads acquired these locks in conflicting "
            "orders; acquisition sites:\n" + "\n".join(detail)
        )

    def emit(self, emitter=None, source: str = "tier1") -> dict:
        """One ``lock_order`` telemetry row summarizing the run."""
        cycle = self.find_cycle()
        row = dict(
            n_locks=len(self._names),
            n_edges=len(self.edges),
            acyclic=cycle is None,
            n_threads=len(self._threads),
            locks=sorted(self._names),
            source=source,
        )
        if cycle is not None:
            row["cycle"] = cycle
        if emitter is None:
            from ..obs.emit import get_emitter

            emitter = get_emitter()
        emitter.emit("lock_order", **row)
        return row
