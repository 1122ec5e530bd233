"""Request micro-batching: coalesce pending ray batches across requests.

Port of ``nerf_replication_tpu/serve/batcher.py``. One worker thread cuts a
batch when EITHER edge fires: pending rays reach ``max_batch_rays``, or the
oldest request has waited ``max_delay_s``. The batch concatenates whole
requests, renders through the engine in one flat call, and hands each
request its slice. The tier of a batch comes from
``DegradationPolicy.tier_for(queue_depth)`` at the cut; requests that waited
past ``request_timeout_s`` fail with :class:`ServeTimeoutError` before any
compute is spent on them.

The ops layers, as in the JAX batcher:

* a :class:`~..resil.CircuitBreaker` (``CircuitBreaker.from_cfg``: the
  ``resil:`` block): consecutive dispatch failures push the tier down the
  same ladder load does, then open the breaker — submissions fail fast
  with :class:`~..resil.BreakerOpenError` (503 + Retry-After at the HTTP
  edge) until the cooldown lets one batch probe (half open);
* the ``serve.flush`` fault point around each batch's render, and a
  watchdog (:meth:`MicroBatcher.ensure_worker`, on every submit and
  health probe) that restarts a worker thread that died, failing its
  stranded batch at once;
* spans, each parented to the request that submitted it (the context
  captured at ``submit``): its queue wait (``serve.queue``, with
  ``behind_s``: the part of the wait the worker spent on other batches,
  from its busy intervals; the rest is the batch edge's), its time from
  the cut to its own slice (``serve.render``), its slice
  (``serve.scatter``) and the hand-off to the client thread
  (``serve.handoff``: from the future's result to ``result()``
  returning); and the batch (``serve.batch``), parented to its first
  request;
* telemetry rows ``serve_request`` / ``serve_batch`` / ``serve_shed``,
  ``fault`` rows, and the live metrics behind ``GET /metrics``.

Multi-scene fleets and tenants, as in the JAX batcher:

* ``scene`` and ``tenant`` ride each request. An unknown scene raises at
  ``submit`` (404 at the HTTP edge); a known one that is not resident
  starts its prefetch there. A batch is cut for ONE scene, the queue
  head's (the engine renders one scene a call); other scenes' requests
  keep their order.
* A scene-scoped failure (:class:`~..fleet.SceneError`: a torn or
  unloadable scene, a residency overload) fails that batch's requests
  alone, counts ``n_scene_errors`` and leaves the breaker closed: the
  other scenes keep serving.
* With a :class:`~..fleet.QosController` (``qos``): token-bucket
  admission at ``submit`` (:class:`~..fleet.TenantQuotaError`, 429), the
  weighted-fair pop (the least-served backlogged tenant picks the
  batch's scene; every popped request advances its tenant's virtual time
  by rays / weight) and per-tenant breakers (a single-tenant batch's
  failures open that tenant's breaker, not the engine's).

Determinism for tests: construct with ``start=False`` and an injectable
``clock``, enqueue with ``submit`` and drive batches with ``pump()`` — the
same code path the worker thread runs.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np

from ..fleet.errors import SceneError
from ..fleet.qos import TenantQuotaError
from ..obs import get_emitter
from ..obs.metrics import get_metrics
from ..obs.trace import current_ctx, get_tracer
from ..renderer.gate import check_baked_bounds
from ..resil import (
    BreakerOpenError,
    CircuitBreaker,
    dump_flight,
    fault_point,
    report,
)
from .policy import TIER_IMPL, TIER_NAMES, DegradationPolicy


class ServeTimeoutError(TimeoutError):
    """The request exceeded its deadline while queued (never rendered)."""


class BatcherClosedError(RuntimeError):
    """The batcher was closed (a drain or shutdown): it admits nothing
    more (503 at the HTTP edge; a router fails over)."""


class ServeFuture:
    """Completion handle for one submitted request. ``ctx`` (the request's
    span context) parents the ``serve.handoff`` span that :meth:`result`
    records, with tracing on, from :meth:`set_result` to its return."""

    def __init__(self, n_rays: int, ctx=None):
        self.n_rays = n_rays
        self.ctx = ctx
        self._event = threading.Event()
        self._result: dict | None = None
        self._error: BaseException | None = None
        self._t_set: float | None = None  # set_result, on the tracer's clock

    def done(self) -> bool:
        return self._event.is_set()

    def set_result(self, result: dict) -> None:
        trs = get_tracer()
        if trs.enabled:
            self._t_set = trs.now()
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
        if self._t_set is not None:
            t_set, self._t_set = self._t_set, None
            get_tracer().record("serve.handoff", start_s=t_set,
                                parent=self.ctx, stage="handoff")
        return self._result


@dataclass
class _Pending:
    rays: np.ndarray
    future: ServeFuture
    t_enqueued: float
    scene: str | None = None
    tenant: str | None = None
    # the trace context captured on the submitting thread (how a request's
    # identity crosses into the worker thread) and the enqueue time on the
    # TRACER's clock, so queue-wait spans share the trace's timebase
    ctx: object | None = None
    t_trace: float = 0.0
    n_rays: int = field(init=False)

    def __post_init__(self):
        self.n_rays = int(self.rays.shape[0])


class MicroBatcher:
    """Deadline-coalescing request queue in front of a RenderEngine."""

    def __init__(self, engine, policy: DegradationPolicy | None = None,
                 clock=time.monotonic, start: bool = True,
                 breaker: CircuitBreaker | None = None, qos=None):
        self.engine = engine
        self.options = engine.options
        self.policy = policy or DegradationPolicy(
            thresholds=engine.options.shed_queue_depths
        )
        self.clock = clock
        self.breaker = breaker or CircuitBreaker(clock=clock)
        # per-tenant QoS (fleet.QosController; None: FIFO) and each
        # tenant's virtual time for the weighted-fair pop ("": tenant-less)
        self.qos = qos
        self._vtime: dict[str, float] = {}
        self._queue: deque[_Pending] = deque()
        # guards _queue, _stop, _vtime and _inflight; the counters below
        # are written by the batch-rendering thread only
        self._cond = threading.Condition()
        self._stop = False
        self.n_batches = 0
        self.n_shed = 0
        self.n_timeouts = 0
        self.n_completed = 0
        self.n_dispatch_errors = 0
        self.n_scene_errors = 0
        self.n_quota_denied = 0
        self.worker_restarts = 0
        self._inflight: list[_Pending] = []
        self._worker_dead = False
        # the worker's busy intervals (cut to last reply of each batch) on
        # the tracer's clock, oldest first; kept with tracing on only
        self._busy: deque[tuple[float, float]] = deque()
        self._last_dispatch_t: float | None = None
        self._thread: threading.Thread | None = None
        self._started = start
        if start:
            self._spawn_worker()

    def _spawn_worker(self) -> None:
        self._worker_dead = False
        self._thread = threading.Thread(
            target=self._worker_main, name="serve-batcher", daemon=True
        )
        self._thread.start()

    def _worker_main(self) -> None:
        try:
            self._worker()
        except BaseException:
            # flag FIRST: a client unblocked below may resubmit before this
            # thread finishes unwinding; then fail the in-flight batch, so
            # its callers get an error now, not at their timeout. Recovery
            # is the watchdog's job.
            self._worker_dead = True
            self._fail_inflight()
            raise

    def ensure_worker(self) -> bool:
        """Watchdog: restart a dead worker thread (a crash that escaped the
        batch-level handler, such as a kill fault) so the queue keeps
        draining. Runs on every submit and health probe; returns whether a
        worker is running."""
        if not self._started or self._stop:
            return self._thread is not None and self._thread.is_alive()
        t = self._thread
        if t is None or not t.is_alive() or self._worker_dead:
            self.worker_restarts += 1
            report("serve.flush", "crash",
                   detail=f"worker dead; restart #{self.worker_restarts}")
            dump_flight(
                "watchdog_crash",
                detail=f"serve worker dead; restart #{self.worker_restarts}",
            )
            self._fail_inflight()
            self._spawn_worker()
        return True

    def _fail_inflight(self) -> None:
        with self._cond:
            stranded = [p for p in self._inflight if not p.future.done()]
            self._inflight = []
        for p in stranded:
            p.future.set_exception(RuntimeError(
                "serve worker crashed mid-batch; request lost"
            ))

    # -- submission -----------------------------------------------------------

    def submit(self, rays, near, far, scene: str | None = None,
               tenant: str | None = None, ctx=None) -> ServeFuture:
        """Enqueue a [N, C] ray request; returns a future. ``ctx`` (a
        ``SpanContext``) parents the request's spans; default: the calling
        thread's current span. With the breaker (or the tenant's) open,
        submission fails fast with :class:`BreakerOpenError`; the tenant's
        token bucket admits it or raises :class:`TenantQuotaError`; bounds
        and the scene are checked here (an unknown scene raises
        ``UnknownSceneError``), so a bad request never occupies the queue;
        a known scene that is not resident starts its prefetch."""
        tenant = None if tenant is None else str(tenant)
        if self.qos is not None:
            tb = self.qos.breaker(tenant)
            if not tb.allow():
                raise BreakerOpenError(tb.retry_after_s())
        if not self.breaker.allow():
            raise BreakerOpenError(self.breaker.retry_after_s())
        if self.qos is not None:
            try:
                self.qos.admit(tenant)
            except TenantQuotaError:  # 429 at the HTTP edge
                self.n_quota_denied += 1
                raise
        self.ensure_worker()
        check_baked_bounds(self.engine.near, self.engine.far, near, far,
                           surface="serve micro-batcher")
        rays = np.asarray(rays, np.float32)
        if rays.ndim != 2 or rays.shape[0] == 0:
            raise ValueError(
                f"rays must be a non-empty [N, C] array, got {rays.shape}"
            )
        if scene is None or self.engine._is_default_scene(scene):
            scene = None
        else:
            self.engine.require_scene(scene)   # 404 before queueing
            self.engine.prefetch_scene(scene)  # overlap its copy to the card
        ctx = ctx if ctx is not None else current_ctx()
        pending = _Pending(rays, ServeFuture(rays.shape[0], ctx),
                           self.clock(), scene=scene, tenant=tenant, ctx=ctx,
                           t_trace=get_tracer().now())
        with self._cond:
            if self._stop:
                raise BatcherClosedError("batcher is closed")
            self._queue.append(pending)
            depth = len(self._queue)
            self._cond.notify_all()
        get_metrics().gauge("serve_queue_depth", depth)
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

    # -- batching core --------------------------------------------------------

    def _cut_batch(self) -> tuple[list[_Pending], int] | None:
        """Block until a batch edge fires; pop and return (batch, depth
        left behind). None only on close with an empty queue. A batch is
        the queue head's scene's (the fair pop's with a QoS controller)."""
        with self._cond:
            while not self._queue and not self._stop:
                self._cond.wait()
            if not self._queue:
                return None
            max_rays = self.options.max_batch_rays
            while not self._stop:
                head = self._queue[0].scene
                if sum(p.n_rays for p in self._queue
                       if p.scene == head) >= max_rays:
                    break
                remaining = self.options.max_delay_s - (
                    self.clock() - self._queue[0].t_enqueued
                )
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            if self.qos is not None:
                batch = self._fair_pop(max_rays)
                return batch, len(self._queue)
            # whole head-scene requests up to the ray budget (always >= 1:
            # an oversize request still renders — the engine splits it);
            # other scenes and over-budget stragglers keep their order
            scene = self._queue[0].scene
            batch: list[_Pending] = []
            kept: list[_Pending] = []
            total = 0
            full = False
            for p in self._queue:
                if p.scene != scene or full:
                    kept.append(p)
                elif not batch or total + p.n_rays <= max_rays:
                    batch.append(p)
                    total += p.n_rays
                else:
                    full = True
                    kept.append(p)
            self._queue.clear()
            self._queue.extend(kept)
            return batch, len(self._queue)

    def _fair_pop(self, max_rays: int) -> list[_Pending]:
        """Weighted-fair batch assembly (caller holds the lock): the scene
        of the least-served backlogged tenant's head; the budget fills
        tenant by tenant in virtual-time order (arrival order within a
        tenant, that scene only), each popped request advancing its
        tenant by ``rays / weight``. A tenant (re)joining the backlog
        starts at the active floor (idle time banks no credit)."""
        by_tenant: dict[str, list[_Pending]] = {}
        for p in self._queue:
            by_tenant.setdefault(p.tenant or "", []).append(p)
        floor = min((self._vtime[t] for t in by_tenant if t in self._vtime),
                    default=0.0)
        for t in by_tenant:
            self._vtime[t] = max(self._vtime.get(t, floor), floor)
        order = sorted(by_tenant, key=lambda t: self._vtime[t])
        scene = by_tenant[order[0]][0].scene
        batch: list[_Pending] = []
        total = 0
        for t in order:
            weight = self.qos.weight(t or None)
            for p in by_tenant[t]:
                if p.scene != scene:
                    continue
                if batch and total + p.n_rays > max_rays:
                    break
                batch.append(p)
                total += p.n_rays
                self._vtime[t] += p.n_rays / weight
            if total >= max_rays:
                break
        picked = set(map(id, batch))
        kept = [p for p in self._queue if id(p) not in picked]
        self._queue.clear()
        self._queue.extend(kept)
        return batch

    def pump(self) -> int:
        """Cut and render one batch synchronously; returns the number of
        requests completed (0 when the queue is empty and closed)."""
        cut = self._cut_batch()
        if cut is None:
            return 0
        trs = get_tracer()
        t_cut = trs.now()
        try:
            return self._render_batch(*cut, t_cut)
        finally:
            if trs.enabled:
                self._note_busy(t_cut, trs.now())

    def _note_busy(self, start: float, end: float) -> None:
        """Keep one busy interval; forget those that ended before any
        request still waiting could have been submitted (a request older
        than twice its timeout has failed at its cut)."""
        self._busy.append((start, end))
        horizon = end - 2.0 * self.options.request_timeout_s
        while self._busy and self._busy[0][1] < horizon:
            self._busy.popleft()

    def _behind_s(self, t_submit: float, t_cut: float) -> float:
        """Seconds of ``[t_submit, t_cut]`` the worker spent on other
        batches (the busy intervals, newest first, until one ends before
        the submit)."""
        behind = 0.0
        for start, end in reversed(self._busy):
            if end <= t_submit:
                break
            behind += max(0.0, min(end, t_cut) - max(start, t_submit))
        return behind

    def _worker(self) -> None:
        while True:
            with self._cond:
                if self._stop and not self._queue:
                    return
            self.pump()

    def _request_row(self, p: _Pending, status: str, tier: str,
                     latency_s: float, queue_s: float) -> None:
        """The request's row and metrics (JAX's fields: a timeout row names
        no scene or tenant; the metrics label an ok request's tenant)."""
        fields = {}
        if status != "timeout":
            fields = {**({} if p.scene is None else {"scene": str(p.scene)}),
                      **({} if p.tenant is None else {"tenant": p.tenant})}
        labels = ({"tenant": p.tenant} if status == "ok"
                  and p.tenant is not None else {})
        # graftlint: ok(emit-hot: per-request completion record, post-sync host slicing)
        get_emitter().emit("serve_request", latency_s=latency_s,
                           n_rays=p.n_rays, tier=tier, status=status,
                           queue_s=queue_s, **fields)
        mx = get_metrics()
        # graftlint: ok(emit-hot: per-request counter+histogram, lock-cheap post-sync)
        mx.counter("serve_requests_total", status=status, tier=tier,
                   **labels)
        if status in ("ok", "timeout"):
            # graftlint: ok(emit-hot: per-request counter+histogram, lock-cheap post-sync)
            mx.observe("serve_request_latency_seconds", latency_s,
                       trace_id=(p.ctx.trace_id if p.ctx is not None
                                 else None), tier=tier, **labels)

    # graftlint: hot
    def _render_batch(self, batch: list[_Pending], queue_depth: int,
                      t_cut: float) -> int:
        """Render one cut batch; ``t_cut``: the cut, on the tracer's clock
        (each request's queue wait ends there)."""
        emitter = get_emitter()
        trs = get_tracer()
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
                self._request_row(p, "timeout", "none", waited, waited)
                trs.record("serve.queue", start_s=p.t_trace, end_s=t_cut,
                           parent=p.ctx, stage="queue", n_rays=p.n_rays,
                           behind_s=self._behind_s(p.t_trace, t_cut),
                           status="timeout")
            else:
                live.append(p)
        if not live:
            return 0
        for p in live:
            trs.record("serve.queue", start_s=p.t_trace, end_s=t_cut,
                       parent=p.ctx, stage="queue", n_rays=p.n_rays,
                       behind_s=self._behind_s(p.t_trace, t_cut),
                       **({} if p.tenant is None else {"tenant": p.tenant}))

        # a single-tenant batch (the fair pop's usual cut) charges that
        # tenant's breaker and carries the tenant on its rows
        tenants = {p.tenant for p in live}
        batch_tenant = next(iter(tenants)) if len(tenants) == 1 else None
        tenant_breaker = (self.qos.breaker(batch_tenant)
                          if self.qos is not None and batch_tenant is not None
                          else None)
        tenant_fields = ({} if batch_tenant is None
                         else {"tenant": batch_tenant})

        # failure degrades through the SAME ladder load does: consecutive
        # dispatch failures push the tier further down before the breaker
        # opens (cheaper captured routes, never a new capture)
        tier = self.policy.tier_for(queue_depth)
        steps = self.breaker.degrade_steps()
        if tenant_breaker is not None:
            steps = max(steps, tenant_breaker.degrade_steps())
        if steps:
            i = TIER_NAMES.index(tier)
            tier = TIER_NAMES[min(i + steps, len(TIER_NAMES) - 1)]
        family, stride = TIER_IMPL[tier]
        if tier != "full":
            self.n_shed += 1
            # graftlint: ok(emit-hot: batch-cadence shed record, host-side)
            emitter.emit("serve_shed", tier=tier, queue_depth=queue_depth,
                         n_requests=len(live),
                         n_rays=sum(p.n_rays for p in live), **tenant_fields)
            # graftlint: ok(emit-hot: batch-cadence counter bump, lock-cheap)
            get_metrics().counter("serve_sheds_total", tier=tier)

        segments = []
        offset = 0
        for p in live:
            length = p.rays[::stride].shape[0]
            segments.append((offset, length))
            offset += length
        flat = np.concatenate([p.rays[::stride] for p in live], axis=0)
        scene = live[0].scene
        scene_fields = {} if scene is None else {"scene": str(scene)}
        t0 = self.clock()
        # no try/finally around _inflight: a kill must LEAVE it set, so
        # the watchdog fails the stranded futures
        with self._cond:
            self._inflight = live
        try:
            # the batch span runs on the worker thread, parented to the
            # first coalesced request (a batch has one timeline, many
            # riders); it nests the engine's dispatch/device spans
            with trs.span("serve.batch", parent=live[0].ctx, tier=tier,
                          n_requests=len(live), n_rays=int(flat.shape[0]),
                          queue_depth=queue_depth, **scene_fields):
                # the lease pins the scene for the whole render; the
                # default scene takes none (the two-argument call)
                with (nullcontext() if scene is None
                      else self.engine.scene_lease(scene)) as data:
                    fault_point("serve.flush")
                    out, info = (
                        self.engine.render_flat(flat, family)
                        if data is None
                        else self.engine.render_flat(flat, family, data))
        except SceneError as err:
            # scene-scoped: this scene's requests fail, the breaker stays
            # closed, the other scenes keep serving
            self.n_scene_errors += 1
            self._last_dispatch_t = self.clock()
            for p in live:
                p.future.set_exception(err)
                self._request_row(p, "scene_error", tier,
                                  self.clock() - p.t_enqueued,
                                  t0 - p.t_enqueued)
            dump_flight("scene_error",
                        detail=f"scene={scene} {type(err).__name__}: "
                               f"{err}"[:200])
            with self._cond:
                self._inflight = []
            return 0
        except Exception as err:  # fail this batch's requests, keep serving
            self.n_dispatch_errors += 1
            self._last_dispatch_t = self.clock()
            if tenant_breaker is not None:
                tenant_breaker.record_failure()
            else:
                self.breaker.record_failure()
            for p in live:
                p.future.set_exception(err)
                self._request_row(p, "error", tier,
                                  self.clock() - p.t_enqueued,
                                  t0 - p.t_enqueued)
            report("serve.dispatch", "error",
                   detail=f"{type(err).__name__}: {err}"[:200])
            with self._cond:
                self._inflight = []
            return 0
        render_s = self.clock() - t0
        self._last_dispatch_t = self.clock()
        self.breaker.record_success()
        if tenant_breaker is not None:
            tenant_breaker.record_success()
        self.n_batches += 1
        # graftlint: ok(emit-hot: one row per coalesced batch, post-sync)
        emitter.emit("serve_batch", n_requests=len(live),
                     n_rays=int(flat.shape[0]),
                     occupancy=float(info["occupancy"]), tier=tier,
                     render_s=float(render_s), queue_depth=queue_depth,
                     bucket_rays=int(info["bucket_rays"]), **scene_fields,
                     **tenant_fields)
        t_done = self.clock()
        for p, (start, length) in zip(live, segments):
            t_sc = trs.now()
            # the cut to this request's own slice: the batch's assembly and
            # render, and the slices cut before its own
            trs.record("serve.render", start_s=t_cut, end_s=t_sc,
                       parent=p.ctx, stage="render", n_requests=len(live))
            sliced = {k: v[start:start + length] for k, v in out.items()}
            if stride > 1:
                sliced = {k: np.repeat(v, stride, axis=0)[:p.n_rays]
                          for k, v in sliced.items()}
            sliced["tier"] = tier
            self.n_completed += 1
            self.engine.n_requests += 1
            self._request_row(p, "ok", tier, t_done - p.t_enqueued,
                              t0 - p.t_enqueued)
            trs.record("serve.scatter", start_s=t_sc, parent=p.ctx,
                       stage="scatter", n_rays=p.n_rays, tier=tier)
            p.future.set_result(sliced)
        # graftlint: ok(emit-hot: one gauge store per batch)
        get_metrics().gauge("serve_queue_depth", queue_depth)
        with self._cond:
            self._inflight = []
        return len(live)

    def stats(self) -> dict:
        out = {
            "queue_depth": self.queue_depth(),
            "n_batches": self.n_batches,
            "n_completed": self.n_completed,
            "n_shed": self.n_shed,
            "n_timeouts": self.n_timeouts,
            "n_dispatch_errors": self.n_dispatch_errors,
            "n_scene_errors": self.n_scene_errors,
            "n_quota_denied": self.n_quota_denied,
            "worker_restarts": self.worker_restarts,
            "breaker": self.breaker.snapshot(),
        }
        if self.qos is not None:
            with self._cond:
                depths: dict[str, int] = {}
                for p in self._queue:
                    depths[p.tenant or ""] = depths.get(p.tenant or "", 0) + 1
            out["tenant_queue_depth"] = depths
            out["qos"] = self.qos.stats()
        return out

    def last_dispatch_age_s(self) -> float | None:
        """Seconds since the last dispatch attempt (None before the
        first) — the liveness number /healthz reports."""
        if self._last_dispatch_t is None:
            return None
        return max(0.0, self.clock() - self._last_dispatch_t)

    def health(self) -> dict:
        """The /healthz payload: queue depth, last-dispatch age, breaker
        state, worker liveness. ``ok`` is false when the breaker is open or
        the worker is dead and could not be restarted."""
        worker_alive = self.ensure_worker() if self._started else True
        breaker = self.breaker.snapshot()
        age = self.last_dispatch_age_s()
        return {
            "ok": bool(worker_alive and breaker["state"] != "open"),
            "queue_depth": self.queue_depth(),
            "last_dispatch_age_s": None if age is None else round(age, 3),
            "breaker": breaker,
            "worker_alive": bool(worker_alive),
            "worker_restarts": self.worker_restarts,
        }
