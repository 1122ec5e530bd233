"""Training robustness: finite-loss guard and SIGTERM preemption (port of
``nerf_replication_tpu/resil/guard.py``).

Both guards are host-side and free of extra device syncs:

* :func:`check_finite` inspects the loss scalar the logging path has
  ALREADY fetched (train/trainer.py reads the stats every
  ``log_interval`` steps regardless) — a NaN/Inf raises :class:`DivergenceError`, which
  the fit loop answers by rolling back to the last good checkpoint.
* :class:`PreemptionGuard` turns SIGTERM into a flag the step loop polls
  at its existing host-sync points; the loop flushes one atomic
  checkpoint (bundle + phase sidecar) and exits, so the resumed run
  re-enters bitwise.
"""

from __future__ import annotations

import math
import signal
import threading

from .faults import fault_point, report
from .flight import dump_flight


class DivergenceError(RuntimeError):
    """The fetched loss went non-finite: roll back, don't checkpoint."""

    def __init__(self, step: int, value: float):
        self.step = int(step)
        self.value = float(value)
        super().__init__(f"non-finite loss {value!r} at step {step}")


def check_finite(stats_host: dict, step: int) -> dict:
    """Finite guard over already-fetched host stats. Applies an active
    ``train.loss`` nan_loss fault first (chaos), then raises
    :class:`DivergenceError` on a non-finite loss. Returns the (possibly
    poisoned) stats so the caller logs what the guard actually saw."""
    spec = fault_point("train.loss", step=step)
    if spec is not None and spec.kind == "nan_loss":
        stats_host = dict(stats_host)
        stats_host["loss"] = float("nan")
    loss = stats_host.get("loss")
    if loss is not None and not math.isfinite(float(loss)):
        if spec is None:  # detected in the wild, not injected
            report("train.loss", "nan_loss", step=step,
                   detail=f"loss={loss!r}")
        raise DivergenceError(step, float(loss))
    return stats_host


class PreemptionGuard:
    """SIGTERM → a polled flag; the loop owns the flush.

    The handler body only sets an event (signal-safe); the training loop
    notices at its next host-sync point, saves ``latest`` with the phase
    sidecar, and stops cleanly. ``install()`` returns None off the main
    thread (signal.signal would raise) — callers treat that as disabled.
    """

    def __init__(self):
        self._event = threading.Event()
        self._prev = None
        self._installed = False

    @classmethod
    def install(cls) -> "PreemptionGuard | None":
        guard = cls()
        try:
            guard._prev = signal.signal(signal.SIGTERM, guard._on_signal)
        except ValueError:  # not the main thread: no signal delivery here
            return None
        guard._installed = True
        return guard

    def _on_signal(self, signum, frame):
        self._event.set()
        try:
            dump_flight("sigterm", detail=f"signum={signum}")
        # graftlint: ok(swallow: a signal handler must never raise)
        except Exception:
            pass

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def clear(self) -> None:
        self._event.clear()

    def uninstall(self) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev or signal.SIG_DFL)
            self._installed = False
