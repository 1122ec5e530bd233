"""Front-door router: least-loaded dispatch with scene-affinity (port of
``nerf_replication_tpu/scale/router.py``).

The router owns the replica registry. Replicas register at spawn and are
swept by PULL heartbeats (one code path for in-process and HTTP
replicas): a beat that keeps failing past ``heartbeat_timeout_s`` marks
the replica dead — transient hiccups inside the window don't, so a GC
pause can't trigger a spurious replacement.

Dispatch picks among accepting replicas by **scene-affinity first**
(prefer a replica whose fleet ladder already holds the request's scene
resident — routing there is an argument swap; routing elsewhere pays a
disk load), **least-loaded second** (queue depth from the last beat),
id-ordered for determinism. Failover is synchronous: a replica that
refuses or dies mid-submit is excluded and the next candidate tried, so
the caller sees one submit, not the failure.

With a :class:`~.placement.PlacementPlanner` attached
(:meth:`Router.set_planner`), the current plan is consulted BEFORE the
passive ordering: candidates the plan assigned the scene to are
stably promoted to the front (within the planned and unplanned groups
the affinity/load/id order is untouched), so a plan hit routes to the
planned replica and a plan miss — or an empty/disabled plan — is
bitwise today's behavior. Dispatches against an active plan are
counted planned/unplanned; the unplanned share is tlm_report's
is-the-plan-working signal.

Candidates are also filtered on the replica ``capabilities`` flag
(ray-level ``submit`` vs whole-pose ``render``): a capability mismatch
is a FILTER, not a failover — the replica is healthy, it just doesn't
speak that protocol — and when no capable replica exists the typed
:class:`NoCapableReplicaError` says so instead of a generic no-replica.

Retirement is drain-before-retire: the replica leaves the candidate set
FIRST (no new admissions), renders everything already queued, and only
then stops — zero in-flight requests fail (``tests/test_torch_scale.py``
holds the count to exactly 0).
"""

from __future__ import annotations

import threading
import time

from ..obs import get_emitter
from ..obs.metrics import get_metrics
from ..obs.trace import get_tracer
from .replica import ReplicaState, ReplicaUnavailableError


class NoReplicaAvailableError(RuntimeError):
    """Every registered replica is draining, retired, or dead."""


class NoCapableReplicaError(NoReplicaAvailableError):
    """Accepting replicas exist, but none serves this request shape
    (e.g. a ray-level submit against a pose-only HTTP fleet)."""


class _Entry:
    def __init__(self, replica, now: float):
        self.replica = replica
        self.last_ok_t = now
        self.beat: dict = {}


class Router:
    def __init__(self, heartbeat_timeout_s: float = 10.0,
                 clock=time.monotonic):
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._entries: dict[str, _Entry] = {}
        self.planner = None  # optional scale/placement.PlacementPlanner
        self.n_dispatches = 0
        self.n_affinity_hits = 0
        self.n_planned_hits = 0
        self.n_unplanned = 0
        self.n_failovers = 0
        self.n_dead_marked = 0

    def set_planner(self, planner) -> None:
        """Attach a placement planner; its current plan is consulted on
        every dispatch (None or an empty plan leaves dispatch exactly
        as before)."""
        self.planner = planner

    # -- registry -------------------------------------------------------------

    def register(self, replica) -> None:
        with self._lock:
            self._entries[replica.replica_id] = _Entry(replica, self.clock())
        get_metrics().gauge("scale_replicas_registered",
                            len(self._entries))

    def deregister(self, replica_id: str) -> None:
        with self._lock:
            self._entries.pop(str(replica_id), None)

    def replicas(self) -> list:
        with self._lock:
            return [e.replica for e in self._entries.values()]

    def _snapshot(self) -> list:
        """Entries at a point in time: readers (sweep, candidate scans,
        views) iterate the snapshot so a concurrent register/deregister
        never mutates the dict under them — and slow replica probes
        (heartbeat, load) run with the router lock NOT held."""
        with self._lock:
            return list(self._entries.values())

    def n_ready(self) -> int:
        return sum(
            1 for r in self.replicas()
            if r.state in (ReplicaState.STARTING, ReplicaState.READY)
        )

    def sweep(self) -> dict:
        """Pull one heartbeat round. A replica whose beats have failed
        for longer than ``heartbeat_timeout_s`` is marked dead (and its
        queued work is already failing — the supervisor replaces it)."""
        now = self.clock()
        dead: list[str] = []
        for entry in self._snapshot():
            r = entry.replica
            if r.state in (ReplicaState.RETIRED, ReplicaState.DEAD):
                continue
            try:
                entry.beat = r.heartbeat()
                entry.last_ok_t = now
            # graftlint: ok(swallow: the timeout ladder IS the handler — failures inside the window are the hysteresis, past it _mark_dead emits)
            except Exception as exc:
                if now - entry.last_ok_t >= self.heartbeat_timeout_s:
                    self._mark_dead(r, f"heartbeat: {exc}")
                    dead.append(r.replica_id)
        return {"t": now, "dead": dead, "n_ready": self.n_ready()}

    def _mark_dead(self, replica, detail: str) -> None:
        if replica.state in (ReplicaState.DEAD, ReplicaState.DRAINING,
                             ReplicaState.RETIRED):
            # draining/retired is a deliberate exit, not a death — marking
            # it dead would make the supervisor "replace" a retirement
            return
        replica.state = ReplicaState.DEAD
        self.n_dead_marked += 1
        get_emitter().emit("router", event="dead",
                           replica=replica.replica_id,
                           detail=detail[:200])
        get_metrics().counter("scale_router_events_total", event="dead")

    # -- dispatch -------------------------------------------------------------

    def _planned_set(self, scene) -> frozenset:
        """Replica ids the current placement plan wants ``scene`` on
        (empty without a planner / active plan / plan entry — every one
        of those leaves dispatch bitwise pre-placement)."""
        if self.planner is None or scene is None:
            return frozenset()
        try:
            return frozenset(self.planner.planned_replicas(scene))
        # graftlint: ok(swallow: the plan is advisory; a planner error must degrade to passive dispatch, not fail the request)
        except Exception:
            return frozenset()

    def _count_plan_hit(self, replica_id: str, planned: frozenset) -> None:
        if self.planner is None or not getattr(
                self.planner, "active", lambda: False)():
            return
        if replica_id in planned:
            self.n_planned_hits += 1
        else:
            self.n_unplanned += 1
            get_metrics().counter("scale_router_events_total",
                                  event="unplanned_dispatch")

    def _candidates(self, scene, need=None) -> list:
        """Accepting replicas as (no_affinity, load, id, replica), sorted
        so ``[0]`` is the pick: affinity beats load beats id. ``need``
        filters on the replica ``capabilities`` flag (replicas without
        one are assumed universal — test doubles predate the flag). A
        planned scene stably promotes its planned replicas to the
        front; an empty plan changes nothing."""
        out = []
        for entry in self._snapshot():
            r = entry.replica
            if not r.accepting():
                continue
            caps = getattr(r, "capabilities", None)
            if need is not None and caps is not None and need not in caps:
                continue
            affinity = (
                scene is not None
                and scene in entry.beat.get("scenes", ())
            )
            try:
                load = int(r.load())
            # graftlint: ok(swallow: routing probe; a failed load sorts the replica last, the sweep owns dead-marking)
            except Exception:
                load = 1 << 30
            out.append((not affinity, load, r.replica_id, r))
        out.sort(key=lambda c: c[:3])
        planned = self._planned_set(scene)
        if planned:
            # stable: planned candidates first, passive order within
            out.sort(key=lambda c: c[2] not in planned)
        return out

    def pick(self, scene=None):
        """The replica the next request for ``scene`` should land on."""
        cands = self._candidates(scene)
        if not cands:
            raise NoReplicaAvailableError(
                f"no accepting replica among {len(self.replicas())} "
                "registered"
            )
        return cands[0][3]

    def _no_replica(self, scene, need=None) -> NoReplicaAvailableError:
        entries = self._snapshot()
        n_accepting = sum(1 for e in entries
                          if e.replica.accepting())
        if need is not None and n_accepting:
            # accepting replicas exist but every one was capability-
            # filtered: a protocol mismatch, not an availability outage
            get_emitter().emit("router", event="no_capable",
                               need=str(need),
                               **({} if scene is None
                                  else {"scene": str(scene)}))
            get_metrics().counter("scale_router_events_total",
                                  event="no_capable")
            return NoCapableReplicaError(
                f"{n_accepting} accepting replicas, none capable of "
                f"{need!r} requests"
            )
        get_emitter().emit("router", event="no_replica",
                           **({} if scene is None
                              else {"scene": str(scene)}))
        get_metrics().counter("scale_router_events_total",
                              event="no_replica")
        return NoReplicaAvailableError(
            f"no accepting replica among {len(entries)} registered"
        )

    def _record_failover(self, trs, replica, exc, n_left, scene,
                         t0: float) -> None:
        self.n_failovers += 1
        self._mark_dead(replica, f"submit: {exc}")
        get_emitter().emit(
            "router", event="failover",
            replica=replica.replica_id,
            n_candidates=n_left,
            **({} if scene is None else {"scene": str(scene)}),
        )
        trs.record("route.failover", start_s=t0, stage="failover",
                   replica=replica.replica_id,
                   status=f"error:{type(exc).__name__}")
        get_metrics().counter("scale_router_events_total",
                              event="failover")

    def submit(self, rays, near, far, scene=None, tenant=None):
        """One request through the front door: pick, submit, fail over.

        A replica that refuses (draining/closed/dead) is skipped; one
        that dies mid-submit is marked dead and the NEXT candidate gets
        the request — the caller never sees a failover.

        Runs under a ``route.submit`` span (stage ``route``) covering
        pick + enqueue; the replica's queue/batch/scatter spans parent
        under it (in-process: the ctx is passed as an argument), so a
        routed request stays ONE trace."""
        trs = get_tracer()
        with trs.span("route.submit", stage="route",
                      **({} if scene is None
                         else {"scene": str(scene)})) as sp:
            cands = self._candidates(scene, need="rays")
            if not cands:
                raise self._no_replica(scene, need="rays")
            planned = self._planned_set(scene)
            last_exc: Exception | None = None
            for i, (no_aff, load, _rid, replica) in enumerate(cands):
                t_try = trs.now()
                try:
                    # FakeReplica doubles in tests predate the ctx
                    # argument — only replicas advertising accepts_ctx
                    # get the explicit SpanContext
                    if getattr(replica, "accepts_ctx", False):
                        future = replica.submit(rays, near, far, scene=scene,
                                                tenant=tenant, ctx=sp.ctx)
                    else:
                        future = replica.submit(rays, near, far, scene=scene,
                                                tenant=tenant)
                except (ReplicaUnavailableError, RuntimeError) as exc:
                    # RuntimeError covers a closed batcher (a racing
                    # kill/retire): treat both as this-replica failures
                    last_exc = exc
                    self._record_failover(trs, replica, exc,
                                          len(cands) - i - 1, scene, t_try)
                    continue
                self.n_dispatches += 1
                if not no_aff:
                    self.n_affinity_hits += 1
                self._count_plan_hit(replica.replica_id, planned)
                sp.set(replica=replica.replica_id)
                get_metrics().counter("scale_router_dispatch_total",
                                      replica=replica.replica_id)
                return future
            raise NoReplicaAvailableError(
                f"all {len(cands)} accepting replicas failed the submit"
            ) from last_exc

    def render(self, body: dict, scene=None, timeout_s: float = 30.0) -> dict:
        """Route one whole-pose request to an HTTP replica (the
        :class:`~.replica.ProcessReplica` surface): pick, POST /render
        with the span ctx stamped as the Traceparent header, fail over on
        a 5xx/transport failure. The root ``route.submit`` span plus a
        ``route.dispatch`` span per attempt make the router's share of
        the wall time explicit in the merged fleet trace."""
        import http.client
        import urllib.error

        trs = get_tracer()
        scene = scene if scene is not None else body.get("scene")
        with trs.span("route.submit",
                      **({} if scene is None
                         else {"scene": str(scene)})) as root:
            cands = [c for c in self._candidates(scene, need="pose")
                     if hasattr(c[3], "render")]
            if not cands:
                raise self._no_replica(scene, need="pose")
            planned = self._planned_set(scene)
            last_exc: Exception | None = None
            for i, (no_aff, _load, _rid, replica) in enumerate(cands):
                t_try = trs.now()
                try:
                    # route.dispatch wraps the whole HTTP round trip; the
                    # child's serve.request parents under ITS ctx via the
                    # propagated header
                    with trs.span("route.dispatch", stage="route",
                                  replica=replica.replica_id):
                        out = replica.render(body, timeout_s=timeout_s)
                except urllib.error.HTTPError as exc:
                    if exc.code < 500:
                        raise  # the request is bad, not the replica
                    last_exc = exc
                    self._record_failover(trs, replica, exc,
                                          len(cands) - i - 1, scene, t_try)
                    continue
                except (ReplicaUnavailableError, urllib.error.URLError,
                        OSError, http.client.HTTPException) as exc:
                    # HTTPException: a child killed mid-reply cuts its
                    # body short (IncompleteRead); a pose render is
                    # idempotent, so it goes to the next candidate
                    last_exc = exc
                    self._record_failover(trs, replica, exc,
                                          len(cands) - i - 1, scene, t_try)
                    continue
                self.n_dispatches += 1
                if not no_aff:
                    self.n_affinity_hits += 1
                self._count_plan_hit(replica.replica_id, planned)
                root.set(replica=replica.replica_id)
                get_metrics().counter("scale_router_dispatch_total",
                                      replica=replica.replica_id)
                return out
            raise NoReplicaAvailableError(
                f"all {len(cands)} accepting replicas failed the render"
            ) from last_exc

    # -- retirement -----------------------------------------------------------

    def drain(self, replica_id: str, timeout_s: float = 60.0) -> int:
        """Drain-before-retire ``replica_id``. Returns the in-flight
        failure count (the contract wants 0). The replica leaves the
        candidate set at the state flip inside ``drain`` — before any
        queued render — so no new work can race in."""
        with self._lock:
            entry = self._entries.get(str(replica_id))
        if entry is None:
            return 0
        load_before = 0
        try:
            load_before = int(entry.replica.load())
        # graftlint: ok(swallow: telemetry-only load snapshot; the drain below is the real work)
        except Exception:
            pass
        failed = entry.replica.drain(timeout_s=timeout_s)
        get_emitter().emit("router", event="drain", replica=str(replica_id),
                           load=load_before, n_failed=int(failed))
        get_metrics().counter("scale_router_events_total", event="drain")
        return failed

    def residency_view(self) -> dict[str, dict]:
        """Per-replica residency state off the last heartbeat round —
        the placement planner's fleet-side input (scene sets, byte
        watermarks, ladder budgets; zeros for replicas whose beats
        predate the planner fields)."""
        out: dict[str, dict] = {}
        for entry in self._snapshot():
            r = entry.replica
            if not r.accepting():
                continue
            b = entry.beat
            out[r.replica_id] = {
                "scenes": list(b.get("scenes", ())),
                "staging": list(b.get("staging", ())),
                "hbm_bytes": int(b.get("hbm_bytes", 0)),
                "staging_bytes": int(b.get("staging_bytes", 0)),
                "hbm_budget_bytes": int(b.get("hbm_budget_bytes", 0)),
                "staging_budget_bytes": int(
                    b.get("staging_budget_bytes", 0)),
                "param_shards": int(b.get("param_shards", 1)),
            }
        return out

    def load_view(self) -> dict[str, int]:
        """Per-replica queue depth from the last heartbeat round — the
        ``queue_depths`` half of a scale decision's evidence block."""
        out: dict[str, int] = {}
        for entry in self._snapshot():
            load = entry.beat.get("load")
            if load is not None:
                out[entry.replica.replica_id] = int(load)
        return out

    def stats(self) -> dict:
        per = {}
        entries = self._snapshot()
        for entry in entries:
            per[entry.replica.replica_id] = {
                "state": entry.replica.state,
                "load": entry.beat.get("load"),
                "warm_source": entry.beat.get("warm_source"),
            }
        return {
            "n_registered": len(entries),
            "n_ready": self.n_ready(),
            "n_dispatches": self.n_dispatches,
            "n_affinity_hits": self.n_affinity_hits,
            "n_planned_hits": self.n_planned_hits,
            "n_unplanned": self.n_unplanned,
            "n_failovers": self.n_failovers,
            "n_dead_marked": self.n_dead_marked,
            "replicas": per,
        }
