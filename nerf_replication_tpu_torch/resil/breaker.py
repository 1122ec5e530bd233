"""Circuit breaker for the serve dispatch path.

The shed-tier ladder (serve/policy.py) handles *load*; this handles
*failure*. Repeated dispatch exceptions first push requests down the same
degradation ladder (cheaper executables are both faster AND exercise less
of the failing surface), and once ``threshold`` consecutive dispatches
have failed the breaker opens: submissions fast-fail with
:class:`BreakerOpenError` (HTTP 503 + Retry-After at serve.py) instead of
queueing work that will die anyway. After ``cooldown_s`` the breaker goes
half-open — one batch probes the dispatch path — and a success closes it.

Every state transition emits one ``breaker`` telemetry row. The breaker
never touches executables or caches, so a recovery is compile-free by
construction (the chaos suite asserts it via CompileTracker).
"""

from __future__ import annotations

import threading
import time

from ..obs.emit import get_emitter
from ..obs.metrics import get_metrics
from .flight import dump_flight


class BreakerOpenError(RuntimeError):
    """Fast-fail: the dispatch path is known-bad; retry after cooldown."""

    def __init__(self, retry_after_s: float):
        self.retry_after_s = max(0.0, float(retry_after_s))
        super().__init__(
            f"circuit breaker open; retry after {self.retry_after_s:.1f}s"
        )


class CircuitBreaker:
    """closed → (consecutive failures ≥ threshold) open → (cooldown)
    half_open → success closes / failure re-opens."""

    def __init__(self, threshold: int = 5, cooldown_s: float = 5.0,
                 clock=time.monotonic, point: str = "serve.dispatch"):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self.point = point
        self._lock = threading.Lock()
        self._state = "closed"
        self._opened_at: float | None = None
        self._consecutive = 0
        self._failures = 0
        self._opens = 0
        # transition side effects (telemetry row + flight dump) queued
        # under the lock, performed after it is released — the emitter
        # writes a file and dump_flight walks the whole recorder ring;
        # neither belongs inside the breaker's critical section
        self._pending: list[tuple[str, int, int, float]] = []

    @classmethod
    def from_cfg(cls, cfg, clock=time.monotonic,
                 point: str = "serve.dispatch") -> "CircuitBreaker":
        """Breaker with thresholds from the ``resil:`` config block."""
        r = cfg.get("resil", {}) if cfg is not None else {}
        return cls(
            threshold=int(r.get("breaker_threshold", 5)),
            cooldown_s=float(r.get("breaker_cooldown_s", 5.0)),
            clock=clock,
            point=point,
        )

    # -- state ---------------------------------------------------------------

    def _tick(self) -> str:
        """Advance open → half_open when the cooldown has elapsed.
        Callers hold the lock."""
        if (self._state == "open" and self._opened_at is not None
                and self.clock() - self._opened_at >= self.cooldown_s):
            self._transition("half_open")
        return self._state

    def _transition(self, state: str) -> None:
        """Mutate state and queue the side effects; callers hold the lock
        and ``_flush()`` after releasing it."""
        self._state = state
        self._pending.append((state, self._failures, self._consecutive,
                              self._retry_after_locked()))

    def _flush(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        for state, failures, consecutive, retry_after in pending:
            get_emitter().emit(
                "breaker", state=state, point=self.point,
                failures=failures, consecutive=consecutive,
                retry_after_s=retry_after,
            )
            get_metrics().counter(
                "serve_breaker_transitions_total", state=state)
            if state == "open":
                # post-mortem snapshot at the moment the dispatch path was
                # declared dead; the recorder has its own lock, never ours
                dump_flight(
                    "breaker_open",
                    detail=f"point={self.point} failures={failures} "
                           f"consecutive={consecutive}",
                )

    @property
    def state(self) -> str:
        with self._lock:
            state = self._tick()
        self._flush()
        return state

    def allow(self) -> bool:
        """May a new request enter? half_open allows (the probe)."""
        with self._lock:
            allowed = self._tick() != "open"
        self._flush()
        return allowed

    def _retry_after_locked(self) -> float:
        if self._state != "open" or self._opened_at is None:
            return 0.0
        return max(0.0, self.cooldown_s - (self.clock() - self._opened_at))

    def retry_after_s(self) -> float:
        with self._lock:
            return self._retry_after_locked()

    # -- outcomes ------------------------------------------------------------

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._consecutive += 1
            state = self._tick()
            if state == "half_open" or (
                state == "closed" and self._consecutive >= self.threshold
            ):
                self._opened_at = self.clock()
                self._opens += 1
                self._transition("open")
        self._flush()

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            if self._tick() != "closed":
                self._opened_at = None
                self._transition("closed")
        self._flush()

    # -- degradation coupling ------------------------------------------------

    def degrade_steps(self) -> int:
        """Extra shed-ladder steps from consecutive dispatch failures —
        the pre-open pressure valve the batcher folds into its tier pick."""
        with self._lock:
            return self._consecutive

    def snapshot(self) -> dict:
        with self._lock:
            snap = {
                "state": self._tick(),
                "failures": self._failures,
                "consecutive": self._consecutive,
                "opens": self._opens,
                "retry_after_s": round(self._retry_after_locked(), 3),
            }
        self._flush()
        return snap
