"""The warm-up contract as CUDA graphs (port of
``nerf_replication_tpu/compile/registry.py``).

The JAX package registers every jitted entry point up front and compiles it
before the hot loop, so that the steady state performs zero builds. The
port's counterpart of an executable is a captured CUDA graph: one replay
launches every kernel of a train step or a serving route without the host
issuing them one by one (the NGP and proposal steps were host-bound, with
the card idle 31-55% of a step).

* Callers :meth:`~AOTRegistry.register` a capturable function (device work
  only: no host read of a device value, no host-to-device copy of a Python
  value, no data-dependent shape) with the static tensors it reads as
  inputs and the ``torch.Generator`` s it draws from.
* :meth:`~AOTRegistry.compile_all` runs each entry once on a side stream
  (kernel libraries load, lazy state such as Adam's moments and the
  chain's weight layouts is made, first-use attributes are set), then
  captures one ``torch.cuda.CUDAGraph`` per entry, all in one memory pool.
* :meth:`~AOTRegistry.take` hands the caller a :class:`CapturedFn`, which
  copies the caller's tensors into the static inputs, replays and returns
  the static outputs (the same tensors on every call: read or copy them
  before the next replay of any entry of the registry).

``captures`` counts the graphs taken; it does not grow after warm-up, the
JAX contract "zero builds in the steady state". A generator registered with
an entry is reseeded by the caller before each replay
(``CUDAGraph.register_generator_state``), so a replay draws what an eager
call draws after the same ``manual_seed``.

The kernels' launch counters (``LAUNCHES`` of ``ops.fused_mlp``,
``ops.fused_march``, ``ops.hash_encode``) are bumped in Python, where a
wrapper launches; a replay runs no Python. Each entry records the counters'
change during its capture (:func:`launch_delta`) and adds it on every
replay (:func:`add_launches`); the capture itself launched nothing, so its
change is taken back.

A capture that raises is recorded in ``summary()["errors"]`` and ``take``
returns None, as in JAX: the caller then runs the same kernels eagerly on
the card (``chip_smoke.py`` fails a run whose entries error). On a CPU
device the registry is disabled: a CPU has no graphs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

# the modules whose LAUNCHES counters a replay accounts for
_COUNTED = ("fused_march", "fused_mlp", "hash_encode")


def _counters() -> dict:
    from ..ops import fused_march, fused_mlp, hash_encode

    mods = {"fused_march": fused_march, "fused_mlp": fused_mlp,
            "hash_encode": hash_encode}
    return {m: mods[m].LAUNCHES for m in _COUNTED}


def launch_snapshot() -> dict:
    """Every kernel launch counter as ``{(module, kernel): count}``."""
    return {(m, k): v for m, c in _counters().items() for k, v in c.items()}


def launch_delta(before: dict, after: dict | None = None) -> dict:
    """The counters that changed from ``before`` to ``after`` (default:
    now), as ``{(module, kernel): change}``."""
    after = launch_snapshot() if after is None else after
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def add_launches(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the launch counters."""
    counters = _counters()
    for (m, k), v in delta.items():
        counters[m][k] = counters[m].get(k, 0) + times * v


def _describe(exc: BaseException) -> str:
    """``Type: message (at file:line in function)``, the innermost frame
    of the port that raised."""
    import traceback

    where = ""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "nerf_replication_tpu_torch" in f.filename]
    if frames:
        f = frames[-1]
        where = (f" (at {f.filename.split('nerf_replication_tpu_torch')[-1]}"
                 f":{f.lineno} in {f.name})")
    return f"{type(exc).__name__}: {exc}{where}"


class CapturedFn:
    """One captured entry point (the JAX ``PrecompiledFn``): ``fn(*args)``
    copies each ``args[i]`` into static input ``i`` (skipped when it is
    that tensor), replays the graph, adds the captured launches to the
    counters and returns the static outputs."""

    __slots__ = ("name", "graph", "inputs", "outputs", "launches",
                 "source", "replays")

    def __init__(self, name, graph, inputs, outputs, launches, source):
        self.name = name
        self.graph = graph
        self.inputs = tuple(inputs)
        self.outputs = outputs
        self.launches = launches
        self.source = source  # "disk" | "compiled": the kernels' build
        self.replays = 0

    def __call__(self, *args):
        if len(args) != len(self.inputs):
            raise TypeError(f"{self.name} takes {len(self.inputs)} inputs, "
                            f"got {len(args)}")
        for dst, src in zip(self.inputs, args):
            if src is not dst:
                dst.copy_(src)
        self.graph.replay()
        add_launches(self.launches)
        self.replays += 1
        return self.outputs


@dataclass
class _Entry:
    name: str
    fn: object
    static_inputs: tuple
    generators: tuple = ()
    result: CapturedFn | None = None
    error: str | None = None
    wall_s: float = 0.0
    done: bool = field(default=False)


class AOTRegistry:
    """Named captured entry points of one process on one card (see the
    module docstring). ``enabled=False`` (a CPU device) keeps the API and
    captures nothing: ``take`` returns None."""

    def __init__(self, device=None, enabled: bool = True, tracker=None):
        self.device = device
        self.enabled = enabled
        # an obs.CompileTracker: one ``compile`` row per capture
        self.tracker = tracker
        self.captures = 0
        self._entries: dict[str, _Entry] = {}
        self._pool = None
        self._stream = None

    # -- registration --------------------------------------------------------

    def register(self, name: str, fn, static_inputs=(),
                 generators=()) -> None:
        """Declare ``fn(*static_inputs)``; re-registering a name replaces
        the entry."""
        self._entries[name] = _Entry(name, fn, tuple(static_inputs),
                                     tuple(generators))

    def names(self) -> list[str]:
        return list(self._entries)

    # -- capture -------------------------------------------------------------

    def compile_all(self) -> None:
        """Warm up and capture every entry not yet done, one by one."""
        if not self.enabled:
            return
        for entry in self._entries.values():
            if not entry.done:
                self._capture(entry)
                entry.done = True

    def _capture(self, entry: _Entry) -> None:
        import torch

        t0 = time.perf_counter()
        dev = torch.device("cuda") if self.device is None else self.device
        before = None
        try:
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
                self._pool = torch.cuda.graph_pool_handle()
            side, main = self._stream, torch.cuda.current_stream(dev)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                entry.fn(*entry.static_inputs)
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            for gen in entry.generators:
                graph.register_generator_state(gen)
            before = launch_snapshot()
            # the outer stream context restores the caller's stream even
            # when the capture's own exit raises
            with torch.cuda.stream(side):
                with torch.cuda.graph(graph, pool=self._pool, stream=side):
                    outputs = entry.fn(*entry.static_inputs)
            torch.cuda.synchronize(dev)
        # graftlint: ok(swallow: the error is recorded in summary()['errors'] and status()['error_text'])
        except Exception as exc:  # recorded; take() then gives None
            entry.error = _describe(exc)
            if before is not None:
                add_launches(launch_delta(before), times=-1)
            self._recover(dev)
            return
        delta = launch_delta(before)
        add_launches(delta, times=-1)  # the capture launched nothing
        self.captures += 1
        entry.wall_s = time.perf_counter() - t0
        entry.result = CapturedFn(entry.name, graph, entry.static_inputs,
                                  outputs, delta, self.warm_source())
        if self.tracker is not None:
            self.tracker.note_compile(entry.name, entry.wall_s,
                                      phase="capture")

    def _recover(self, dev) -> None:
        """After a failed capture: later entries take a new stream and
        pool, and the error the failure left behind is drained (a kernel
        launch check would report it again)."""
        import torch

        self._stream = self._pool = None
        for _ in range(2):
            try:
                torch.cuda.synchronize(dev)
                torch.zeros(1, device=dev).add_(1)
            # graftlint: ok(swallow: draining the failed capture's stale error is the handling)
            except Exception:  # the stale error itself
                pass

    def take(self, name: str) -> CapturedFn | None:
        """The captured entry ``name``, or None: unknown name, disabled
        registry, not yet captured or a capture that failed, in which case
        the caller runs its eager path."""
        if not self.enabled:
            return None
        entry = self._entries.get(name)
        return None if entry is None else entry.result

    # -- introspection -------------------------------------------------------

    def summary(self) -> dict:
        """``{entries, sources, wall_s, errors}``, the JAX keys: per-source
        counts of the captured entries, their warm-up + capture wall time
        and the names whose capture failed."""
        sources: dict[str, int] = {}
        errors = []
        wall = 0.0
        for e in self._entries.values():
            if e.result is not None:
                sources[e.result.source] = sources.get(e.result.source, 0) + 1
                wall += e.wall_s
            elif e.error is not None:
                errors.append(e.name)
        return {"entries": len(self._entries), "sources": sources,
                "wall_s": round(wall, 3), "errors": errors}

    def status(self) -> dict:
        """:meth:`summary` with ``captures``, ``warm_source`` and each
        failed capture's error (the line a fit loop logs)."""
        return {**self.summary(), "captures": self.captures,
                "warm_source": self.warm_source(),
                "error_text": {e.name: e.error[:400]
                               for e in self._entries.values() if e.error}}

    @staticmethod
    def warm_source() -> str:
        """``disk`` when this process ran no ``nvcc`` (every kernel
        library was on disk), else ``compiled``."""
        from ..ops import kernels

        return "disk" if kernels.builds == 0 else "compiled"


def registry_from_cfg(cfg, device="cuda", tracker=None) -> AOTRegistry | None:
    """The config-gated registry (``cfg.compile.aot``): None when it is
    switched off, so callers keep their eager path; a disabled registry on
    a CPU device. ``tracker`` (an ``obs.CompileTracker``) gets a
    ``compile`` row per capture."""
    import torch

    c = cfg.get("compile", {})
    if not bool(c.get("aot", True)):
        return None
    dev = torch.device(device)
    return AOTRegistry(device=dev, enabled=dev.type == "cuda",
                       tracker=tracker)
