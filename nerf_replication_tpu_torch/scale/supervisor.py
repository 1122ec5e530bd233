"""Closed-loop replica supervision against the SLO signal (port of
``nerf_replication_tpu/scale/supervisor.py``).

The serving processes publish the signal (``/metrics`` + the ``/healthz``
SLO block, per-tenant deny rates); this loop ACTS on it. Each
``step(attainment, deny_rate)`` evaluates one observation window:

* **scale-out** — attainment below ``out_below`` OR deny rate above
  ``deny_above`` for ``out_windows`` CONSECUTIVE windows, the out
  cooldown has elapsed, and the fleet is under ``max_replicas``:
  spawn one replica (warm-started from the shared artifact store, so
  the capacity arrives in seconds).
* **scale-in** — attainment at/above the STRICTER ``in_above`` and deny
  rate at/below ``deny_above`` for ``in_windows`` consecutive windows,
  the in cooldown has elapsed, and the fleet is over ``min_replicas``:
  drain-before-retire the least-loaded replica.
* **replace** — a dead replica (missed heartbeats, crash) is replaced
  immediately, outside the cooldowns: that is capacity repair, not a
  scaling decision, and waiting out a cooldown would serve the outage.

The asymmetric thresholds + consecutive-window streaks are the
hysteresis; the cooldowns bound the rate of change. Both exist so the
loop converges instead of flapping (``tests/test_torch_scale.py`` holds
the decision table to the JAX supervisor's on a fake clock).

Every decision (including holds) emits a ``scale_decision`` telemetry
row, so ``tlm_report`` can show the loop's reasoning and ``--diff`` can
gate on grown SLO-miss windows / replica churn.
"""

from __future__ import annotations

import time
from collections import deque

from ..obs import get_emitter
from ..obs.metrics import get_metrics
from ..resil import dump_flight, note_flight
from .options import ScaleOptions
from .replica import ReplicaState


class Supervisor:
    """One decision loop over a :class:`~.router.Router`.

    ``spawn_fn(index) -> replica`` builds a new replica (a
    :class:`~.launcher.ProcessLauncher`, an engine factory against the
    shared kernel-library store, or a test's fake). The supervisor registers what it spawns.

    ``evidence_source`` (optional) links every decision to what the loop
    saw: any object with ``slo_miss_exemplars(target_s)`` — the process
    :class:`~..obs.metrics.MetricsRegistry` or a fleet
    :class:`~.fleet_metrics.FleetMetricsAggregator`. With it attached,
    each ``scale_decision`` row carries an ``evidence`` block (attainment
    series, per-replica queue depths, deny rate, exemplar trace ids of
    SLO-missing requests) and every out/in dumps a
    ``flight_scale_<dir>.json`` naming that evidence."""

    def __init__(self, router, spawn_fn, options: ScaleOptions | None = None,
                 clock=time.monotonic, evidence_source=None,
                 slo_target_s: float = 0.25, alerts=None,
                 planner=None, placement_executor=None):
        self.router = router
        self.spawn_fn = spawn_fn
        self.options = options or ScaleOptions()
        self.clock = clock
        self.evidence_source = evidence_source
        self.slo_target_s = float(slo_target_s)
        # optional obs.alerts.AlertEngine fed the fleet-merged window in
        # step_from_fleet — the burn-rate alerts see what the loop sees
        self.alerts = alerts
        # optional scale/placement wiring: the supervisor owns the plan
        # lifecycle — replan on scale-out/in, replica death, and scene
        # publish, plus a periodic cadence; execute pending moves (rate-
        # limited) on every step
        self.planner = planner
        self.placement_executor = placement_executor
        self._last_plan_t = -float("inf")
        self._publish_pending = False
        self._spawn_index = 0
        self._out_streak = 0
        self._in_streak = 0
        # cooldown anchors start "elapsed": the first legitimate streak
        # may act immediately
        self._last_out_t = -float("inf")
        self._last_in_t = -float("inf")
        self._attainment_history: deque = deque(maxlen=16)
        self._last_deny_rate = 0.0
        self.n_spawned = 0
        self.n_retired = 0
        self.n_replaced = 0
        self.n_miss_windows = 0
        self.drain_failures = 0
        self.decisions: list[dict] = []

    # -- capacity actions -----------------------------------------------------

    def _spawn(self, reason: str) -> object:
        replica = self.spawn_fn(self._spawn_index)
        self._spawn_index += 1
        self.n_spawned += 1
        self.router.register(replica)
        get_emitter().emit(
            "replica", replica=replica.replica_id, event="spawn",
            state=replica.state, n_ready=self.router.n_ready(),
            detail=reason,
        )
        return replica

    def ensure_min(self) -> int:
        """Bring the fleet up to ``min_replicas`` (boot path)."""
        spawned = 0
        while self.router.n_ready() < self.options.min_replicas:
            self._spawn("ensure_min")
            spawned += 1
        return spawned

    def replace_dead(self) -> int:
        """Sweep heartbeats and replace every dead replica 1:1 (bounded
        by ``max_replicas``). Runs outside the cooldowns — repair, not
        scaling."""
        self.router.sweep()
        replaced = 0
        for r in self.router.replicas():
            if r.state != ReplicaState.DEAD:
                continue
            self.router.deregister(r.replica_id)
            if self.router.n_ready() < self.options.max_replicas:
                fresh = self._spawn(f"replace:{r.replica_id}")
                replaced += 1
                self._decide("replace", f"dead:{r.replica_id}",
                             replica=fresh.replica_id)
        self.n_replaced += replaced
        if replaced:
            # capacity repair invalidates the plan: the dead replica's
            # assignments must land somewhere that exists
            self._placement_tick("replace")
        return replaced

    # -- placement ------------------------------------------------------------

    def note_publish(self, scene_id: str) -> None:
        """A scene version went out (fleet/publish.py): replan at the
        next step so publish moves push it to every assigned replica."""
        if self.planner is not None:
            self.planner.note_publish(scene_id)
            self._publish_pending = True

    def _placement_tick(self, action: str) -> None:
        """One plan-lifecycle beat: replan when triggered (scale/death/
        publish) or the cadence is due, then apply up to
        ``max_moves_per_step`` pending moves."""
        if self.planner is None:
            return
        popt = self.options.placement
        now = self.clock()
        trigger = action in ("out", "in", "replace")
        if self._publish_pending:
            trigger, action = True, "publish"
            self._publish_pending = False
        if trigger or now - self._last_plan_t >= popt.replan_every_s:
            self._last_plan_t = now
            self.planner.replan_from_router(
                self.router,
                reason=action if trigger else "periodic")
        if self.placement_executor is not None and self.planner.pending:
            self.placement_executor.execute(
                self.planner, limit=popt.max_moves_per_step)

    def _retire_pick(self):
        """Least-loaded ready replica (fastest drain, least disruption)."""
        ready = [r for r in self.router.replicas()
                 if r.state == ReplicaState.READY]
        if not ready:
            return None

        def load_of(r):
            try:
                return int(r.load())
            # graftlint: ok(swallow: retire-pick probe; an unreadable load just makes the replica least attractive)
            except Exception:
                return 1 << 30

        return min(ready, key=lambda r: (load_of(r), r.replica_id))

    # -- the decision loop ----------------------------------------------------

    def _evidence(self) -> dict | None:
        """The metric-window snapshot a decision links to (None when no
        evidence source is attached: the decision row then carries no
        ``evidence`` block)."""
        if self.evidence_source is None:
            return None
        try:
            tids = list(self.evidence_source.slo_miss_exemplars(
                self.slo_target_s))
        # graftlint: ok(swallow: evidence must never fail the decision that cites it; an empty id list is itself visible to the --diff gate)
        except Exception:
            tids = []
        return {
            "attainment_series": [None if a is None else round(float(a), 4)
                                  for a in self._attainment_history],
            "queue_depths": self.router.load_view(),
            "deny_rate": round(float(self._last_deny_rate), 4),
            "exemplar_trace_ids": tids,
        }

    def _decide(self, action: str, reason: str, *, attainment=None,
                deny_rate=None, streak=0, replica=None) -> str:
        n = self.router.n_ready()
        row = {"action": action, "reason": reason, "n_replicas": n,
               "streak": int(streak)}
        if attainment is not None:
            row["attainment"] = float(attainment)
        if deny_rate is not None:
            row["deny_rate"] = float(deny_rate)
        if replica is not None:
            row["replica"] = str(replica)
        evidence = self._evidence()
        if evidence is not None:
            row["evidence"] = evidence
        self.decisions.append(row)
        get_emitter().emit("scale_decision", **row)
        mx = get_metrics()
        mx.counter("scale_decisions_total", action=action)
        mx.gauge("scale_replicas_ready", n)
        if action in ("out", "in"):
            # the post-mortem trail: the flight ring gets the decision
            # with its evidence, then flight_scale_<dir>.json snapshots
            # the spans (the exemplar traces among them) at the moment
            # the loop acted
            note_flight(point="scale.decision", action=action,
                        reason=reason, n_replicas=n,
                        **({} if replica is None
                           else {"replica": str(replica)}),
                        **({} if evidence is None
                           else {"evidence": evidence}))
            dump_flight(f"scale_{action}",
                        detail=f"{reason}; exemplars="
                               + ",".join((evidence or {}).get(
                                   "exemplar_trace_ids", [])[:4]))
        return action

    def step(self, attainment: float | None, deny_rate: float = 0.0) -> str:
        """Evaluate one observation window; returns the action taken
        (``out`` / ``in`` / ``replace`` / ``hold``). ``attainment`` is
        the window's SLO attainment in [0, 1] (None = no traffic, which
        counts toward scale-IN: an idle fleet should shrink). With a
        planner attached, every step also beats the plan lifecycle
        (replan on scale actions / publish / cadence, then apply a
        bounded batch of pending moves)."""
        action = self._step_window(attainment, deny_rate)
        if action != "replace":  # replace_dead already ticked the plan
            self._placement_tick(action)
        return action

    def _step_window(self, attainment: float | None,
                     deny_rate: float = 0.0) -> str:
        opt = self.options
        now = self.clock()
        self._attainment_history.append(
            None if attainment is None else float(attainment))
        self._last_deny_rate = float(deny_rate)
        if self.replace_dead():
            return "replace"
        missing = (attainment is not None and attainment < opt.out_below)
        denying = deny_rate > opt.deny_above
        good = ((attainment is None or attainment >= opt.in_above)
                and deny_rate <= opt.deny_above)
        if missing or denying:
            self.n_miss_windows += 1
            self._out_streak += 1
            self._in_streak = 0
        elif good:
            self._in_streak += 1
            self._out_streak = 0
        else:
            # the hysteresis band: neither streak advances
            self._out_streak = 0
            self._in_streak = 0
        n = self.router.n_ready()
        if (self._out_streak >= opt.out_windows
                and now - self._last_out_t >= opt.cooldown_out_s
                and n < opt.max_replicas):
            self._last_out_t = now
            self._out_streak = 0
            reason = "deny_rate" if (denying and not missing) else "slo_miss"
            fresh = self._spawn(reason)
            return self._decide("out", reason, attainment=attainment,
                                deny_rate=deny_rate,
                                streak=opt.out_windows,
                                replica=fresh.replica_id)
        if (self._in_streak >= opt.in_windows
                and now - self._last_in_t >= opt.cooldown_in_s
                and n > opt.min_replicas):
            self._last_in_t = now
            self._in_streak = 0
            victim = self._retire_pick()
            if victim is not None:
                failed = self.router.drain(victim.replica_id,
                                           timeout_s=opt.drain_timeout_s)
                self.drain_failures += int(failed)
                self.n_retired += 1
                return self._decide("in", "sustained_attainment",
                                    attainment=attainment,
                                    deny_rate=deny_rate,
                                    streak=opt.in_windows,
                                    replica=victim.replica_id)
        return self._decide(
            "hold",
            "miss_streak" if self._out_streak else
            ("good_streak" if self._in_streak else "steady"),
            attainment=attainment, deny_rate=deny_rate,
            streak=max(self._out_streak, self._in_streak),
        )

    def step_from_fleet(self, aggregator) -> str:
        """One window read straight off the fleet aggregator — the loop
        acts on the SAME merged signal ``GET /fleet/metrics`` shows the
        operator. A window where nothing completed (attainment None) but
        replicas hold queued work is total overload, not idleness: it
        counts as attainment 0.0 so the loop scales OUT instead of
        reading a wedged fleet as a shrink signal."""
        w = aggregator.window()
        attainment = w["attainment"]
        if attainment is None:
            backlog = sum(aggregator.router.load_view().values())
            if backlog > 0 or w.get("no_replica", 0) > 0:
                attainment = 0.0
        if self.alerts is not None:
            # a wedged fleet completes nothing, so weight the forced-0.0
            # attainment by at least one observation or no bad count
            # would ever accumulate and the page would never fire
            n = max(int(w.get("requests", 0)),
                    1 if attainment is not None else 0)
            self.alerts.observe_window(attainment, w["deny_rate"], n)
            self.alerts.evaluate()
        return self.step(attainment, deny_rate=w["deny_rate"])

    def stats(self) -> dict:
        return {
            "n_spawned": self.n_spawned,
            "n_retired": self.n_retired,
            "n_replaced": self.n_replaced,
            "n_miss_windows": self.n_miss_windows,
            "drain_failures": self.drain_failures,
            "churn": self.n_spawned + self.n_retired,
            "n_decisions": len(self.decisions),
            "router": self.router.stats(),
            "placement": (None if self.planner is None
                          else self.planner.stats()),
        }
