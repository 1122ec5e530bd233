"""Multi-window multi-burn-rate SLO alerting (the SRE workbook shape;
port of ``nerf_replication_tpu/obs/alerts.py``).

The fleet emits raw telemetry — spans, /metrics, flight dumps,
evidence-linked scale decisions; this engine consumes it while traffic
flows, so nobody has to read a report to learn that the fleet has been
burning its SLO for an hour.

**Burn rate** is error budget spent per unit budget: with a 99% SLO the
budget is 1%, so an error rate of 14.4% burns at 14.4x — the classic
page threshold (a 30-day budget gone in ~2 days). A burn-rate alert
fires only when BOTH a short and a long window exceed the threshold:
the short window makes the alert fast to clear, the long window keeps a
10-second blip from paging. Two severities ride the same math:

* **page** — fast windows (5m / 1h), burn >= ``fast_burn`` (14.4x)
* **ticket** — slow windows (30m / 6h), burn >= ``slow_burn`` (6x)

evaluated against two budgeted signals (SLO latency attainment, tenant
deny rate) plus three direct conditions: breaker open (page while any
dispatch breaker is open), orphan-span rate (spans whose parent never
arrived — broken propagation), and staging thrash (demote->re-promote
churn at the residency ladder). Hysteresis: an alert clears only after
its condition has been continuously false for ``clear_hold_s`` — no
flapping at the threshold.

Feeds, either or both:

* :meth:`AlertEngine.attach` — subscribe to the telemetry row stream
  (``obs.emit.add_row_tap``): serve_request / tenant_admit / breaker /
  span / scene_load / scene_evict rows update the windows in-process
  (the HTTP server's shape, ``serve/__main__.py``).
* :meth:`AlertEngine.observe_window` — explicit (attainment, deny_rate,
  n) samples: the Supervisor's fleet-merged view
  (``Supervisor.step_from_fleet``), where the engine sees what the
  closed loop sees.

Every state TRANSITION (never steady state) emits a schema-versioned
``alert`` telemetry row and notifies listeners — the incident correlator
(obs/incidents.py) opens/mitigates on these. ``GET /alerts`` renders
:meth:`status`; ``/healthz`` carries the firing set.

Host-side pure Python: no torch import, injectable clock, deterministic
under a fake clock (``tests/test_torch_alerts.py`` holds it to the JAX
engine under one).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from .emit import add_row_tap, get_emitter, remove_row_tap
from .metrics import WindowRing, get_metrics

# page when the fast windows burn >= 14.4x (a 30-day budget in ~2 days);
# ticket when the slow windows burn >= 6x (budget in ~5 days)
DEFAULT_FAST_BURN = 14.4
DEFAULT_SLOW_BURN = 6.0


class AlertOptions:
    """Targets + windows for the engine (defaults mirror cfg.obs.alerts).

    ``slo_objective``/``deny_objective`` are attainment objectives in
    (0, 1); the error budget each burn rate divides is ``1 - objective``.
    The latency target itself (what "attained" means) is the engine's
    ``slo_target_s``, not an option here — it mirrors ``obs.slo_target_ms``.
    """

    def __init__(self, *,
                 slo_objective: float = 0.99,
                 deny_objective: float = 0.99,
                 fast_burn: float = DEFAULT_FAST_BURN,
                 slow_burn: float = DEFAULT_SLOW_BURN,
                 fast_short_s: float = 300.0,
                 fast_long_s: float = 3600.0,
                 slow_short_s: float = 1800.0,
                 slow_long_s: float = 21600.0,
                 clear_hold_s: float = 60.0,
                 min_count: float = 1.0,
                 orphan_grace_s: float = 30.0,
                 orphan_rate_max: float = 0.05,
                 thrash_per_min_max: float = 6.0):
        self.slo_objective = float(slo_objective)
        self.deny_objective = float(deny_objective)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.fast_short_s = float(fast_short_s)
        self.fast_long_s = float(fast_long_s)
        self.slow_short_s = float(slow_short_s)
        self.slow_long_s = float(slow_long_s)
        self.clear_hold_s = float(clear_hold_s)
        self.min_count = float(min_count)
        self.orphan_grace_s = float(orphan_grace_s)
        self.orphan_rate_max = float(orphan_rate_max)
        self.thrash_per_min_max = float(thrash_per_min_max)

    @classmethod
    def from_cfg(cls, cfg) -> "AlertOptions":
        """Options from the ``obs.alerts`` config block."""
        return cls(
            slo_objective=float(cfg.obs.alerts.slo_objective),
            deny_objective=float(cfg.obs.alerts.deny_objective),
            fast_burn=float(cfg.obs.alerts.fast_burn),
            slow_burn=float(cfg.obs.alerts.slow_burn),
            fast_short_s=float(cfg.obs.alerts.fast_short_s),
            fast_long_s=float(cfg.obs.alerts.fast_long_s),
            slow_short_s=float(cfg.obs.alerts.slow_short_s),
            slow_long_s=float(cfg.obs.alerts.slow_long_s),
            clear_hold_s=float(cfg.obs.alerts.clear_hold_s),
            orphan_grace_s=float(cfg.obs.alerts.orphan_grace_s),
            orphan_rate_max=float(cfg.obs.alerts.orphan_rate_max),
            thrash_per_min_max=float(cfg.obs.alerts.thrash_per_min_max),
        )


class _BudgetSignal:
    """bad/total event pair over time — the burn-rate numerator."""

    __slots__ = ("bad", "total")

    def __init__(self, slot_s: float):
        self.bad = WindowRing(slot_s=slot_s)
        self.total = WindowRing(slot_s=slot_s)

    def rate(self, window_s: float, now: float) -> tuple[float, float]:
        n = self.total.total(window_s, now)
        if not n:
            return 0.0, 0.0
        return self.bad.total(window_s, now) / n, n


class AlertEngine:
    """Burn-rate + direct-condition alerting over the telemetry stream.

    ``slo_target_s`` is the per-request latency target a serve_request
    row is judged against (row-tap feed); the fleet feed
    (:meth:`observe_window`) brings pre-judged attainment instead.
    ``replica`` stamps emitted alert rows (multi-replica merges).
    """

    def __init__(self, options: AlertOptions | None = None,
                 slo_target_s: float = 0.25,
                 clock=time.monotonic, replica: str = ""):
        self.options = options or AlertOptions()
        self.slo_target_s = float(slo_target_s)
        self.clock = clock
        self.replica = str(replica)
        opt = self.options
        # slot resolution scales with the shortest window so bench and test
        # configurations with second-scale windows still resolve
        slot = max(0.25, min(5.0, opt.fast_short_s / 10.0))
        self._lock = threading.Lock()
        self._slo = _BudgetSignal(slot)
        self._deny = _BudgetSignal(slot)
        self._orphan = _BudgetSignal(slot)
        self._demote = WindowRing(slot_s=slot)
        self._repromote = WindowRing(slot_s=slot)
        self._breaker: dict[str, str] = {}          # point -> last state
        self._seen_spans: set[str] = set()
        self._seen_q: deque = deque()
        self._pending_parents: deque = deque()      # (t, parent_id)
        self._states: dict[str, dict] = {}
        self._listeners: list = []
        self.transitions: list[dict] = []
        self.alert_seconds: dict[str, float] = {}
        self.self_s = 0.0  # wall seconds spent in the engine (overhead)

    # -- feeds ---------------------------------------------------------------

    def attach(self) -> "AlertEngine":
        """Subscribe to the process's telemetry row stream."""
        add_row_tap(self._on_row)
        return self

    def detach(self) -> None:
        remove_row_tap(self._on_row)

    def add_listener(self, fn) -> None:
        """``fn(event_dict)`` on every fire/clear transition (the
        incident correlator's hook)."""
        if fn not in self._listeners:
            self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    def _on_row(self, row: dict) -> None:
        t0 = time.perf_counter()
        kind = row.get("kind")
        now = self.clock()
        with self._lock:
            if kind == "serve_request":
                bad = (float(row.get("latency_s", 0.0)) > self.slo_target_s
                       or str(row.get("status", "ok")) not in ("ok", ""))
                self._slo.total.add(1.0, now)
                if bad:
                    self._slo.bad.add(1.0, now)
            elif kind == "tenant_admit":
                self._deny.total.add(1.0, now)
                if row.get("decision") == "deny":
                    self._deny.bad.add(1.0, now)
            elif kind == "breaker":
                self._breaker[str(row.get("point") or "")] = \
                    str(row.get("state", ""))
            elif kind == "span":
                self._note_span(row, now)
            elif kind == "scene_evict":
                if row.get("reason") == "demoted":
                    self._demote.add(1.0, now)
            elif kind == "scene_load":
                if row.get("source") == "staging":
                    self._repromote.add(1.0, now)
        self.self_s += time.perf_counter() - t0

    def _note_span(self, row: dict, now: float) -> None:
        # children finish BEFORE their parents, so a parent id unseen at
        # child-finish time is normal: judge only after a grace period
        sid = row.get("span_id")
        if isinstance(sid, str):
            self._seen_spans.add(sid)
            self._seen_q.append(sid)
            while len(self._seen_q) > 8192:
                self._seen_spans.discard(self._seen_q.popleft())
        pid = row.get("parent_id")
        if isinstance(pid, str) and not row.get("remote_parent"):
            self._pending_parents.append((now, pid))

    def observe_window(self, attainment: float | None, deny_rate: float,
                       n: int, now: float | None = None) -> None:
        """One fleet-merged observation window (Supervisor feed):
        ``n`` completed requests at ``attainment``, admissions denied at
        ``deny_rate``. ``attainment`` None with n==0 records nothing."""
        now = self.clock() if now is None else now
        n = max(0, int(n))
        with self._lock:
            if attainment is not None:
                k = max(n, 1)
                self._slo.total.add(float(k), now)
                self._slo.bad.add((1.0 - float(attainment)) * k, now)
            if n:
                self._deny.total.add(float(n), now)
                self._deny.bad.add(float(deny_rate) * n, now)

    # -- evaluation ----------------------------------------------------------

    def _judge_pending(self, now: float) -> None:
        grace = self.options.orphan_grace_s
        while self._pending_parents and \
                now - self._pending_parents[0][0] >= grace:
            _t, pid = self._pending_parents.popleft()
            self._orphan.total.add(1.0, now)
            if pid not in self._seen_spans:
                self._orphan.bad.add(1.0, now)

    def _conditions(self, now: float) -> list[dict]:
        """Raw per-alert condition verdicts at ``now`` (lock held)."""
        opt = self.options
        out: list[dict] = []

        def burn(name, signal, sig, objective, severity, thr, short_s,
                 long_s):
            budget = max(1e-9, 1.0 - objective)
            r_s, n_s = sig.rate(short_s, now)
            r_l, _n_l = sig.rate(long_s, now)
            b_s, b_l = r_s / budget, r_l / budget
            out.append({
                "name": name, "signal": signal, "severity": severity,
                "threshold": thr, "window_s": short_s,
                "burn_fast": round(b_s, 2), "burn_slow": round(b_l, 2),
                "value": round(r_s, 4),
                "condition": (n_s >= opt.min_count and b_s >= thr
                              and b_l >= thr),
            })

        burn("slo_burn_page", "slo", self._slo, opt.slo_objective,
             "page", opt.fast_burn, opt.fast_short_s, opt.fast_long_s)
        burn("slo_burn_ticket", "slo", self._slo, opt.slo_objective,
             "ticket", opt.slow_burn, opt.slow_short_s, opt.slow_long_s)
        burn("deny_burn_page", "deny", self._deny, opt.deny_objective,
             "page", opt.fast_burn, opt.fast_short_s, opt.fast_long_s)
        burn("deny_burn_ticket", "deny", self._deny, opt.deny_objective,
             "ticket", opt.slow_burn, opt.slow_short_s, opt.slow_long_s)

        open_points = sorted(p for p, s in self._breaker.items()
                             if s == "open")
        out.append({
            "name": "breaker_open", "signal": "breaker", "severity": "page",
            "threshold": 1.0, "window_s": 0.0,
            "burn_fast": None, "burn_slow": None,
            "value": float(len(open_points)),
            "condition": bool(open_points),
            "detail": ",".join(open_points),
        })

        self._judge_pending(now)
        orate, on = self._orphan.rate(opt.fast_short_s, now)
        out.append({
            "name": "orphan_spans", "signal": "orphan_spans",
            "severity": "ticket", "threshold": opt.orphan_rate_max,
            "window_s": opt.fast_short_s,
            "burn_fast": None, "burn_slow": None,
            "value": round(orate, 4),
            "condition": (on >= opt.min_count
                          and orate >= opt.orphan_rate_max),
        })

        minutes = max(opt.fast_short_s / 60.0, 1e-9)
        churn = min(self._demote.total(opt.fast_short_s, now),
                    self._repromote.total(opt.fast_short_s, now)) / minutes
        out.append({
            "name": "staging_thrash", "signal": "staging_thrash",
            "severity": "ticket", "threshold": opt.thrash_per_min_max,
            "window_s": opt.fast_short_s,
            "burn_fast": None, "burn_slow": None,
            "value": round(churn, 2),
            "condition": churn >= opt.thrash_per_min_max,
        })
        return out

    def evaluate(self, now: float | None = None) -> dict:
        """One evaluation pass: update every alert's state machine,
        emit ``alert`` rows + notify listeners on transitions, return
        the current status (the ``GET /alerts`` body)."""
        t0 = time.perf_counter()
        now = self.clock() if now is None else now
        hold = self.options.clear_hold_s
        fired: list[dict] = []
        statuses: list[dict] = []
        with self._lock:
            for c in self._conditions(now):
                st = self._states.setdefault(
                    c["name"], {"state": "ok", "since": now,
                                "clear_since": None})
                if c.pop("condition"):
                    st["clear_since"] = None
                    if st["state"] != "firing":
                        st["state"] = "firing"
                        st["since"] = now
                        fired.append({**c, "state": "firing"})
                else:
                    if st["state"] == "firing":
                        if st["clear_since"] is None:
                            st["clear_since"] = now
                        if now - st["clear_since"] >= hold:
                            self.alert_seconds[c["name"]] = (
                                self.alert_seconds.get(c["name"], 0.0)
                                + (now - st["since"]))
                            st["state"] = "ok"
                            st["since"] = now
                            st["clear_since"] = None
                            fired.append({**c, "state": "resolved"})
                statuses.append({**c, "state": st["state"],
                                 "since": st["since"]})
        # transitions emit/notify OUTSIDE the lock: the emitted alert row
        # re-enters this engine through its own row tap
        mx = get_metrics()
        for ev in fired:
            ev = dict(ev)
            ev.setdefault("detail", "")
            self.transitions.append({**ev, "t": now})
            get_emitter().emit(
                "alert", name=ev["name"], state=ev["state"],
                severity=ev["severity"], signal=ev["signal"],
                burn_fast=ev["burn_fast"], burn_slow=ev["burn_slow"],
                value=ev["value"], threshold=ev["threshold"],
                window_s=ev["window_s"], replica=self.replica,
                detail=ev["detail"],
            )
            mx.counter("alert_transitions_total", alert=ev["name"],
                       state=ev["state"])
            for fn in list(self._listeners):
                try:
                    fn({**ev, "t": now})
                # graftlint: ok(swallow: a broken listener must not break alerting; it is dropped)
                except Exception:
                    self.remove_listener(fn)
        for s in statuses:
            mx.gauge("alert_firing", 1.0 if s["state"] == "firing" else 0.0,
                     alert=s["name"])
        firing = [s["name"] for s in statuses if s["state"] == "firing"]
        self.self_s += time.perf_counter() - t0
        return {"t": now, "firing": firing, "alerts": statuses}

    # -- read surfaces -------------------------------------------------------

    def active(self) -> list[str]:
        with self._lock:
            return sorted(n for n, st in self._states.items()
                          if st["state"] == "firing")

    def status(self, now: float | None = None) -> dict:
        """The ``GET /alerts`` body: a fresh evaluation + totals."""
        view = self.evaluate(now)
        with self._lock:
            now_t = view["t"]
            seconds = dict(self.alert_seconds)
            for name, st in self._states.items():
                if st["state"] == "firing":
                    seconds[name] = (seconds.get(name, 0.0)
                                     + (now_t - st["since"]))
        view["enabled"] = True
        view["n_transitions"] = len(self.transitions)
        view["alert_seconds"] = {k: round(v, 3)
                                 for k, v in sorted(seconds.items())}
        return view

    def healthz_block(self) -> dict:
        """The compact ``alerts`` block /healthz carries."""
        firing = self.active()
        return {"firing": firing, "n_firing": len(firing),
                "n_transitions": len(self.transitions)}

    def stats(self) -> dict:
        with self._lock:
            return {
                "n_transitions": len(self.transitions),
                "firing": sorted(n for n, st in self._states.items()
                                 if st["state"] == "firing"),
                "self_s": round(self.self_s, 4),
                "breaker_points": dict(self._breaker),
            }
