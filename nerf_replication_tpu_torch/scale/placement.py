"""Scene placement planner: which replica holds which scene (port of
``nerf_replication_tpu/scale/placement.py``).

Replicas scale (scale/supervisor.py), scenes page through a two-tier
residency ladder (fleet/ladder.py), and the
:class:`~..obs.capacity.CapacityLedger` measures per-scene heat and byte
watermarks; without a planner the router only reacts to residency it
observes passively, so a hot scene stays one-replica-wide until traffic
happens to spill. The :class:`PlacementPlanner` DECIDES placement:

* **inputs** — the scene catalog (a :class:`~..fleet.store.SceneStore`
  or any registry duck), per-replica residency state off router
  heartbeats (:meth:`~.router.Router.residency_view`: HBM + staging
  scene sets, byte watermarks, ladder budgets), and windowed scene heat
  (requests/s, rays/s) from one or more capacity ledgers;
* **policy** — a scene at/above ``hot_rps`` is hot and is replicated
  ``hot_width``-wide, plus one replica per ``width_rps`` of additional
  heat (capped at ``max_width``); every other observed scene gets one
  planned holder, bin-packed greedily (hottest first, prefer replicas
  that already hold the scene, then least-packed) under each replica's
  HBM+staging byte budget — the two ladder tiers are one byte pool for
  planning, the ladder itself decides tiering. A scene nothing can fit
  stays unassigned: the router falls back to passive dispatch for it;
* **output** — a versioned :class:`PlacementPlan`. The version bumps
  only when the scene→replicas assignment changes, so identical inputs
  produce identical plans (the determinism tier-1 asserts). Rebalance
  deltas come out as an ORDERED move list — publishes, then prefetches
  (hottest scene first), then demotes — so a planned scene is never
  globally unresident mid-rebalance, and a demote is always the
  ladder's tier transition (``evict`` refuses pinned leases and the
  refusal is counted as a failed move), never a raw drop.

The :class:`PlacementExecutor` applies moves against per-replica
primitives (``TieredResidencyManager.prefetch``/``evict``,
``ScenePublisher.publish``); a replica without a local backend (a
serve child process) realizes prefetches lazily — the router's plan
consult steers traffic there and the engine's on-demand load makes the
scene resident — and leaves demotes to its own ladder TTL sweep.

Every replan emits a ``placement_plan`` telemetry row (version, moves
by kind, convergence wall time once the move list drains to empty,
evidence scene-heat snapshot) and every applied move a
``placement_move`` row; tlm_report.py summarizes both and ``--diff``
gates on grown unplanned-dispatch share and failed moves.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..obs import get_emitter
from ..obs.metrics import get_metrics
from .options import PlacementOptions

MOVE_KINDS = ("publish", "prefetch", "demote")


@dataclass(frozen=True)
class PlacementMove:
    """One ordered rebalance step: ``kind`` applied to ``scene`` on
    ``replica``."""

    kind: str
    scene: str
    replica: str


@dataclass(frozen=True)
class PlacementPlan:
    """A versioned scene→replicas assignment plus the ordered moves
    that take the fleet from its observed residency to it."""

    version: int
    assignments: dict = field(default_factory=dict)  # scene -> (rid, ...)
    moves: tuple = ()                                # ordered PlacementMoves
    reason: str = ""
    scene_heat: dict = field(default_factory=dict)   # evidence snapshot

    @property
    def converged(self) -> bool:
        return not self.moves

    def replicas_for(self, scene) -> tuple:
        return self.assignments.get(scene, ())

    def moves_by_kind(self) -> dict:
        out = {k: 0 for k in MOVE_KINDS}
        for m in self.moves:
            out[m.kind] = out.get(m.kind, 0) + 1
        return out


def merge_heat(*views) -> dict:
    """Fold capacity views into one ``scene -> heat`` dict.

    Accepts full :meth:`~..obs.capacity.CapacityLedger.view` dicts
    (their ``scenes`` block) or already-flat scene->heat dicts; rates
    sum across replicas (each ledger sees its replica's share)."""
    out: dict[str, dict] = {}
    for view in views:
        if view is None:
            continue
        scenes = view.get("scenes", view)
        for sid, h in scenes.items():
            if not isinstance(h, dict):
                continue
            agg = out.setdefault(str(sid), {"requests_per_s": 0.0,
                                            "rays_per_s": 0.0})
            agg["requests_per_s"] += float(h.get("requests_per_s", 0.0))
            agg["rays_per_s"] += float(h.get("rays_per_s", 0.0))
    return out


class PlacementPlanner:
    """Computes :class:`PlacementPlan` s from catalog + residency + heat.

    ``heat_fn`` (optional) returns the merged heat view
    :meth:`replan_from_router` uses; ``scene_bytes_fn`` (optional) maps
    a scene id to its device-byte estimate — without one the planner
    uses the fleet-wide mean bytes-per-resident-scene it can observe
    (and no budget pressure at all before any residency is observed).
    """

    def __init__(self, catalog=None, *,
                 options: PlacementOptions | None = None,
                 heat_fn=None, scene_bytes_fn=None, clock=time.monotonic):
        self.catalog = catalog
        self.options = options or PlacementOptions(enabled=True)
        self.heat_fn = heat_fn
        self.scene_bytes_fn = scene_bytes_fn
        self.clock = clock
        self._lock = threading.Lock()
        self.current: PlacementPlan | None = None
        self.pending: list[PlacementMove] = []
        self._pending_publishes: set[str] = set()
        self._unconverged_t: float | None = None
        self.n_plans = 0
        self.n_version_bumps = 0
        self.n_moves_planned = 0
        self.n_moves_applied = {k: 0 for k in MOVE_KINDS}
        self.n_failed_moves = 0
        self.n_skipped_moves = 0
        self.convergence_s: list[float] = []

    # -- plan consult (the router's read path) --------------------------------

    def active(self) -> bool:
        plan = self.current
        return bool(self.options.enabled and plan is not None
                    and plan.assignments)

    def planned_replicas(self, scene) -> tuple:
        """The replicas the current plan wants ``scene`` on (empty when
        disabled, unplanned, or no plan yet — the router then behaves
        exactly as before this module existed)."""
        if scene is None or not self.active():
            return ()
        return self.current.replicas_for(str(scene))

    # -- replan triggers ------------------------------------------------------

    def note_publish(self, scene_id: str) -> None:
        """A scene version was published: the next plan carries publish
        moves pushing it to every assigned replica."""
        with self._lock:
            self._pending_publishes.add(str(scene_id))

    # -- planning -------------------------------------------------------------

    def _width(self, rps: float) -> int:
        opt = self.options
        if rps < opt.hot_rps:
            return 1
        extra = int((rps - opt.hot_rps) // opt.width_rps)
        return min(opt.max_width, opt.hot_width + extra)

    def _scene_bytes(self, sid: str, states: dict) -> int:
        if self.scene_bytes_fn is not None:
            try:
                return int(self.scene_bytes_fn(sid))
            # graftlint: ok(swallow: byte estimate only; the mean fallback keeps the pack running)
            except Exception:
                pass
        total = sum(int(s.get("hbm_bytes", 0)) + int(s.get("staging_bytes", 0))
                    for s in states.values())
        count = sum(len(s.get("scenes", ())) + len(s.get("staging", ()))
                    for s in states.values())
        return total // count if count else 0

    def _budget(self, state: dict) -> float:
        opt = self.options
        hbm = opt.hbm_budget_bytes or int(state.get("hbm_budget_bytes", 0))
        stg = (opt.staging_budget_bytes
               or int(state.get("staging_budget_bytes", 0)))
        total = hbm + stg
        return float(total) if total > 0 else float("inf")

    def plan(self, replica_states: dict, heat: dict | None = None, *,
             reason: str = "periodic",
             dispatch_counters: dict | None = None) -> PlacementPlan:
        """One replan: observed residency + heat in, versioned plan out.

        ``replica_states`` is ``replica_id -> {scenes, staging,
        hbm_bytes, staging_bytes, hbm_budget_bytes,
        staging_budget_bytes}`` (:meth:`~.router.Router.residency_view`);
        ``heat`` is ``scene -> {requests_per_s, rays_per_s}``
        (:func:`merge_heat`). Deterministic: identical inputs yield an
        identical assignment, version, and move list."""
        heat = dict(heat or {})
        with self._lock:
            publishes = sorted(self._pending_publishes)
            self._pending_publishes.clear()
            plan = self._plan_locked(replica_states, heat, publishes, reason)
        self._emit_plan(plan, len(replica_states), dispatch_counters)
        return plan

    def _plan_locked(self, states: dict, heat: dict,
                     publishes: list, reason: str) -> PlacementPlan:
        rids = sorted(states)
        resident = {r: set(states[r].get("scenes", ())) for r in rids}
        staged = {r: set(states[r].get("staging", ())) for r in rids}
        # place every scene the fleet has evidence about: measured heat,
        # a resident/staged copy, or a pending publish. The full catalog
        # (10k scenes) is NOT eagerly placed — an unobserved scene costs
        # nothing until its first request, which creates the heat that
        # places it on the next replan.
        scenes = set(heat)
        for r in rids:
            scenes |= resident[r] | staged[r]
        scenes |= set(publishes)
        if self.catalog is not None:
            # only catalog scenes are plannable — "default" (the
            # engine's own checkpoint) and stray heat keys have no
            # record to prefetch or publish from
            scenes &= set(self.catalog.ids())

        def rps(s):
            return float(heat.get(s, {}).get("requests_per_s", 0.0))

        order = sorted(scenes, key=lambda s: (-rps(s), s))
        used = {r: 0.0 for r in rids}
        budget = {r: self._budget(states[r]) for r in rids}
        # a mesh-backed replica serving model-parallel (param_shards > 1)
        # holds only ~1/shards of a scene's params per device, so its
        # budget packs that fraction — a scene a replicated copy would
        # overflow can still be planned onto a sharded replica
        shards = {r: max(1, int(states[r].get("param_shards", 1)))
                  for r in rids}
        assignments: dict[str, tuple] = {}
        for s in order:
            nbytes = self._scene_bytes(s, states)
            width = min(self._width(rps(s)), len(rids))
            ranked = sorted(
                rids, key=lambda r: (s not in resident[r] and
                                     s not in staged[r], used[r], r))
            chosen = []
            for r in ranked:
                if len(chosen) >= width:
                    break
                eff = -(-nbytes // shards[r])
                if used[r] + eff <= budget[r]:
                    chosen.append(r)
                    used[r] += eff
            if chosen:
                assignments[s] = tuple(sorted(chosen))
        moves = self._moves(order, assignments, resident, staged, publishes)
        prev = self.current
        version = prev.version if prev is not None else 0
        if prev is None or prev.assignments != assignments:
            version += 1
            self.n_version_bumps += 1
        plan = PlacementPlan(
            version=version, assignments=assignments, moves=tuple(moves),
            reason=str(reason),
            scene_heat={s: dict(heat[s]) for s in order[:16] if s in heat},
        )
        self.current = plan
        self.pending = list(moves)
        self.n_plans += 1
        self.n_moves_planned += len(moves)
        now = self.clock()
        if moves and self._unconverged_t is None:
            self._unconverged_t = now
        return plan

    def _moves(self, order, assignments, resident, staged,
               publishes) -> list:
        """Ordered deltas: publishes, then prefetches hottest-first,
        then demotes — a planned scene keeps >=1 resident copy through
        the whole sequence because every new copy lands before any old
        one is demoted."""
        moves: list[PlacementMove] = []
        for s in publishes:
            for r in assignments.get(s, ()):
                moves.append(PlacementMove("publish", s, r))
        for s in order:
            for r in assignments.get(s, ()):
                if s not in resident[r]:
                    moves.append(PlacementMove("prefetch", s, r))
        for r in sorted(resident):
            keep = {s for s, rs in assignments.items() if r in rs}
            for s in sorted(resident[r]):
                if s not in keep:
                    moves.append(PlacementMove("demote", s, r))
        return moves

    def replan_from_router(self, router, *, heat=None,
                           reason: str = "periodic") -> PlacementPlan:
        """Replan straight off the router's heartbeat view (what the
        supervisor calls on its step cadence and on scale/death/publish
        events). The plan row carries the router's planned/unplanned
        dispatch counters — the unplanned share tlm_report gates on."""
        if heat is None and self.heat_fn is not None:
            try:
                heat = merge_heat(self.heat_fn())
            # graftlint: ok(swallow: heat is advisory; a replan without it still packs residency correctly)
            except Exception:
                heat = {}
        counters = {
            "planned_hits": int(getattr(router, "n_planned_hits", 0)),
            "unplanned": int(getattr(router, "n_unplanned", 0)),
        }
        return self.plan(router.residency_view(), heat or {}, reason=reason,
                         dispatch_counters=counters)

    # -- convergence + telemetry ----------------------------------------------

    def note_converged(self) -> None:
        """Called by the executor when the pending move list drains (or
        by :meth:`plan` emitting a move-free plan): closes the
        convergence wall-time measurement."""
        if self._unconverged_t is None:
            return
        dt = max(0.0, self.clock() - self._unconverged_t)
        self._unconverged_t = None
        self.convergence_s.append(dt)
        get_metrics().counter("placement_convergences_total")

    def _emit_plan(self, plan: PlacementPlan, n_replicas: int,
                   dispatch_counters: dict | None = None) -> None:
        closed = False
        if plan.converged:
            before = len(self.convergence_s)
            self.note_converged()
            closed = len(self.convergence_s) > before
        by_kind = plan.moves_by_kind()
        row = {
            "version": plan.version,
            "reason": plan.reason,
            "n_scenes": len(plan.assignments),
            "n_replicas": int(n_replicas),
            "n_moves": len(plan.moves),
            "moves_by_kind": by_kind,
            "converged": plan.converged,
            "evidence": {"scene_heat": plan.scene_heat},
        }
        if dispatch_counters:
            row["planned_hits"] = int(
                dispatch_counters.get("planned_hits", 0))
            row["unplanned"] = int(dispatch_counters.get("unplanned", 0))
        if closed:
            row["convergence_s"] = round(self.convergence_s[-1], 4)
        get_emitter().emit("placement_plan", **row)
        mx = get_metrics()
        mx.gauge("placement_plan_version", float(plan.version))
        mx.gauge("placement_pending_moves", float(len(plan.moves)))

    def note_move(self, move: PlacementMove, ok: bool, detail: str,
                  *, skipped: bool = False) -> None:
        """Record one applied move (the executor's write-back) and emit
        its ``placement_move`` row."""
        if skipped:
            self.n_skipped_moves += 1
        elif ok:
            self.n_moves_applied[move.kind] = (
                self.n_moves_applied.get(move.kind, 0) + 1)
        else:
            self.n_failed_moves += 1
        version = self.current.version if self.current is not None else 0
        # the move kind rides the "move" field ("kind" is the row kind)
        get_emitter().emit(
            "placement_move", version=version, move=move.kind,
            scene=move.scene, replica=move.replica, ok=bool(ok),
            **({} if not detail else {"detail": str(detail)[:200]}),
        )
        get_metrics().counter("placement_moves_total", kind=move.kind,
                              ok=str(bool(ok)).lower())

    def stats(self) -> dict:
        plan = self.current
        return {
            "enabled": bool(self.options.enabled),
            "version": 0 if plan is None else plan.version,
            "n_plans": self.n_plans,
            "n_version_bumps": self.n_version_bumps,
            "n_assigned_scenes": 0 if plan is None else len(plan.assignments),
            "n_pending_moves": len(self.pending),
            "n_moves_planned": self.n_moves_planned,
            "moves_applied": dict(self.n_moves_applied),
            "n_failed_moves": self.n_failed_moves,
            "n_skipped_moves": self.n_skipped_moves,
            "n_convergences": len(self.convergence_s),
            "convergence_s_last": (round(self.convergence_s[-1], 4)
                                   if self.convergence_s else None),
        }


class PlacementExecutor:
    """Applies a plan's pending moves against per-replica primitives.

    ``residency_of(replica_id)`` resolves a replica's local
    :class:`~..fleet.ladder.TieredResidencyManager` (None for a remote
    serve child — its prefetches realize lazily via routed
    traffic and its demotes via its own ladder TTL);
    ``publisher_of(replica_id)`` resolves its
    :class:`~..fleet.publish.ScenePublisher`; ``catalog`` supplies the
    record a publish move pushes."""

    def __init__(self, *, residency_of=None, publisher_of=None,
                 catalog=None):
        self.residency_of = residency_of
        self.publisher_of = publisher_of
        self.catalog = catalog
        self.n_executed = 0

    def _apply(self, move: PlacementMove) -> tuple[bool, str, bool]:
        """(ok, detail, skipped) for one move."""
        mgr = (self.residency_of(move.replica)
               if self.residency_of is not None else None)
        if move.kind == "prefetch":
            if mgr is None:
                return True, "lazy", True  # routed traffic realizes it
            return bool(mgr.prefetch(move.scene)), "", False
        if move.kind == "demote":
            if mgr is None:
                return True, "remote_ttl", True  # the child's ladder owns it
            # evict() is the ladder's tier transition: it REFUSES a
            # pinned lease (returns False) — that refusal is the
            # never-raw-evict contract and counts as a failed move
            ok = bool(mgr.evict(move.scene))
            return ok, "" if ok else "pinned", False
        if move.kind == "publish":
            pub = (self.publisher_of(move.replica)
                   if self.publisher_of is not None else None)
            if pub is None or self.catalog is None:
                return True, "no_publisher", True
            try:
                pub.publish(self.catalog.get(move.scene))
                return True, "", False
            # graftlint: ok(swallow: one failed publish move must not stall the move queue; it is counted and gated in --diff)
            except Exception as exc:
                return False, f"{type(exc).__name__}: {exc}", False
        return False, f"unknown kind {move.kind!r}", False

    def execute(self, planner: PlacementPlanner,
                limit: int | None = None) -> dict:
        """Pop and apply up to ``limit`` pending moves (all when None).
        Returns ``{applied, failed, skipped, remaining}``; drained-to-
        empty closes the planner's convergence measurement."""
        applied = failed = skipped = 0
        n = len(planner.pending) if limit is None else min(
            int(limit), len(planner.pending))
        for _ in range(n):
            move = planner.pending.pop(0)
            ok, detail, was_skipped = self._apply(move)
            planner.note_move(move, ok, detail, skipped=was_skipped)
            self.n_executed += 1
            if was_skipped:
                skipped += 1
            elif ok:
                applied += 1
            else:
                failed += 1
        if not planner.pending:
            planner.note_converged()
        return {"applied": applied, "failed": failed, "skipped": skipped,
                "remaining": len(planner.pending)}
