"""Request micro-batching: coalesce pending ray batches across requests.

Port of the core of ``nerf_replication_tpu/serve/batcher.py``. One worker
thread cuts a batch when EITHER edge fires: pending rays reach
``max_batch_rays``, or the oldest request has waited ``max_delay_s``. The
batch concatenates whole requests, renders through the engine in one flat
call, and hands each request its slice. The tier of a batch comes from
``DegradationPolicy.tier_for(queue_depth)`` at the cut; requests that waited
past ``request_timeout_s`` fail with :class:`ServeTimeoutError` before any
compute is spent on them.

Not ported here (operations slices): the circuit breaker, per-tenant QoS,
multi-scene fleets, telemetry and span tracing.

Determinism for tests: construct with ``start=False`` and an injectable
``clock``, enqueue with ``submit`` and drive batches with ``pump()`` — the
same code path the worker thread runs.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..renderer.gate import check_baked_bounds
from .policy import TIER_IMPL, DegradationPolicy


class ServeTimeoutError(TimeoutError):
    """The request exceeded its deadline while queued (never rendered)."""


class ServeFuture:
    """Completion handle for one submitted request."""

    def __init__(self, n_rays: int):
        self.n_rays = n_rays
        self._event = threading.Event()
        self._result: dict | None = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def set_result(self, result: dict) -> None:
        self._result = result
        self._event.set()

    def set_exception(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def result(self, timeout: float | None = None) -> dict:
        if not self._event.wait(timeout):
            raise ServeTimeoutError(
                f"no result within {timeout}s (request still queued?)"
            )
        if self._error is not None:
            raise self._error
        return self._result


@dataclass
class _Pending:
    rays: np.ndarray
    future: ServeFuture
    t_enqueued: float
    n_rays: int = field(init=False)

    def __post_init__(self):
        self.n_rays = int(self.rays.shape[0])


class MicroBatcher:
    """Deadline-coalescing request queue in front of a RenderEngine."""

    def __init__(self, engine, policy: DegradationPolicy | None = None,
                 clock=time.monotonic, start: bool = True):
        self.engine = engine
        self.options = engine.options
        self.policy = policy or DegradationPolicy(
            thresholds=engine.options.shed_queue_depths
        )
        self.clock = clock
        self._queue: deque[_Pending] = deque()
        self._cond = threading.Condition()  # guards _queue and _stop
        self._stop = False
        # counters, written by the batch-rendering thread only
        self.n_batches = 0
        self.n_shed = 0
        self.n_timeouts = 0
        self.n_completed = 0
        self.n_dispatch_errors = 0
        self._thread: threading.Thread | None = None
        if start:
            self._thread = threading.Thread(
                target=self._worker, name="serve-batcher", daemon=True
            )
            self._thread.start()

    def submit(self, rays, near, far) -> ServeFuture:
        """Enqueue a [N, C] ray request; returns a future. Bounds are
        checked here, so a bad request never occupies the queue."""
        check_baked_bounds(self.engine.near, self.engine.far, near, far,
                           surface="serve micro-batcher")
        rays = np.asarray(rays, np.float32)
        if rays.ndim != 2 or rays.shape[0] == 0:
            raise ValueError(
                f"rays must be a non-empty [N, C] array, got {rays.shape}"
            )
        pending = _Pending(rays, ServeFuture(rays.shape[0]), self.clock())
        with self._cond:
            if self._stop:
                raise RuntimeError("batcher is closed")
            self._queue.append(pending)
            self._cond.notify_all()
        return pending.future

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def close(self, drain: bool = True) -> None:
        """Stop the worker; with ``drain`` the queue renders first,
        otherwise queued futures fail with ServeTimeoutError."""
        with self._cond:
            self._stop = True
            if not drain:
                while self._queue:
                    self._queue.popleft().future.set_exception(
                        ServeTimeoutError("batcher closed before render")
                    )
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            self._thread = None

    def _cut_batch(self) -> tuple[list[_Pending], int] | None:
        """Block until a batch edge fires; pop and return (batch, depth
        left behind). None only on close with an empty queue."""
        with self._cond:
            while not self._queue and not self._stop:
                self._cond.wait()
            if not self._queue:
                return None
            max_rays = self.options.max_batch_rays
            while not self._stop:
                if sum(p.n_rays for p in self._queue) >= max_rays:
                    break
                remaining = self.options.max_delay_s - (
                    self.clock() - self._queue[0].t_enqueued
                )
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            # whole requests up to the ray budget (always >= 1: an oversize
            # request still renders — the engine splits it)
            batch: list[_Pending] = []
            total = 0
            while self._queue and (
                not batch or total + self._queue[0].n_rays <= max_rays
            ):
                p = self._queue.popleft()
                batch.append(p)
                total += p.n_rays
            return batch, len(self._queue)

    def pump(self) -> int:
        """Cut and render one batch synchronously; returns the number of
        requests completed (0 when the queue is empty and closed)."""
        cut = self._cut_batch()
        if cut is None:
            return 0
        return self._render_batch(*cut)

    def _worker(self) -> None:
        while True:
            with self._cond:
                if self._stop and not self._queue:
                    return
            self.pump()

    def _render_batch(self, batch: list[_Pending], queue_depth: int) -> int:
        now = self.clock()
        live: list[_Pending] = []
        for p in batch:
            waited = now - p.t_enqueued
            if waited > self.options.request_timeout_s:
                self.n_timeouts += 1
                p.future.set_exception(ServeTimeoutError(
                    f"request waited {waited:.3f}s in queue "
                    f"(timeout {self.options.request_timeout_s}s)"
                ))
            else:
                live.append(p)
        if not live:
            return 0
        tier = self.policy.tier_for(queue_depth)
        family, stride = TIER_IMPL[tier]
        if tier != "full":
            self.n_shed += 1
        segments = []
        offset = 0
        for p in live:
            length = p.rays[::stride].shape[0]
            segments.append((offset, length))
            offset += length
        flat = np.concatenate([p.rays[::stride] for p in live], axis=0)
        try:
            out, _info = self.engine.render_flat(flat, family)
        except Exception as err:  # fail this batch's requests, keep serving
            self.n_dispatch_errors += 1
            for p in live:
                p.future.set_exception(err)
            return 0
        self.n_batches += 1
        for p, (start, length) in zip(live, segments):
            sliced = {k: v[start:start + length] for k, v in out.items()}
            if stride > 1:
                sliced = {k: np.repeat(v, stride, axis=0)[:p.n_rays]
                          for k, v in sliced.items()}
            sliced["tier"] = tier
            self.n_completed += 1
            self.engine.n_requests += 1
            p.future.set_result(sliced)
        return len(live)

    def stats(self) -> dict:
        return {
            "queue_depth": self.queue_depth(),
            "n_batches": self.n_batches,
            "n_completed": self.n_completed,
            "n_shed": self.n_shed,
            "n_timeouts": self.n_timeouts,
            "n_dispatch_errors": self.n_dispatch_errors,
        }
