"""Finite-loss guard (port of ``check_finite`` in
``nerf_replication_tpu/resil/guard.py``, without its fault-injection hook).

It inspects the loss the logging path has already fetched to the host, so
it adds no device synchronisation."""

from __future__ import annotations

import math


class DivergenceError(RuntimeError):
    """The fetched loss went non-finite."""

    def __init__(self, step: int, value: float):
        self.step = int(step)
        self.value = float(value)
        super().__init__(f"non-finite loss {value!r} at step {step}")


def check_finite(stats_host: dict, step: int) -> dict:
    """Raise :class:`DivergenceError` on a non-finite ``loss``; returns the
    stats unchanged."""
    loss = stats_host.get("loss")
    if loss is not None and not math.isfinite(float(loss)):
        raise DivergenceError(step, float(loss))
    return stats_host
