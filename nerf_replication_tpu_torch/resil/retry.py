"""Bounded exponential-backoff retry for every load path.

A transient ``OSError`` on a checkpoint/artifact/grid read should cost a
few retries, not a cold restart — but an unbounded retry loop turns a
hard failure into a hang, which is worse. So: a hard attempt cap, a
capped exponential backoff, and one ``retry`` telemetry row per decision
(status ``retry`` | ``ok`` | ``exhausted``) so recovery is measurable.
``tlm_report`` counts ``exhausted`` rows as unrecovered faults and
``--diff`` flags a run that grew them.
"""

from __future__ import annotations

import time

from ..obs.emit import get_emitter

# module defaults; the `resil:` config block overrides where a cfg is in
# scope (trainer resume), deep load paths use these as-is
RETRY_ATTEMPTS = 3
RETRY_BASE_S = 0.05
RETRY_MAX_S = 2.0


def with_retry(fn, *, point: str, attempts: int = RETRY_ATTEMPTS,
               base_s: float = RETRY_BASE_S, max_s: float = RETRY_MAX_S,
               retry_on: tuple = (OSError,), sleep=time.sleep):
    """Call ``fn()`` with up to ``attempts`` tries. Exceptions outside
    ``retry_on`` (including SimulatedKill, a BaseException) propagate
    immediately; the final failure re-raises after an ``exhausted`` row."""
    attempts = max(1, int(attempts))
    t0 = time.perf_counter()
    for attempt in range(1, attempts + 1):
        try:
            out = fn()
        except retry_on as err:
            detail = f"{type(err).__name__}: {err}"
            if attempt >= attempts:
                get_emitter().emit(
                    "retry", point=point, attempt=attempt,
                    status="exhausted", error=detail,
                    wall_s=time.perf_counter() - t0,
                )
                raise
            backoff = min(max_s, base_s * (2 ** (attempt - 1)))
            get_emitter().emit(
                "retry", point=point, attempt=attempt, status="retry",
                error=detail, backoff_s=backoff,
            )
            sleep(backoff)
        else:
            if attempt > 1:  # recovered: close the loop in telemetry
                get_emitter().emit(
                    "retry", point=point, attempt=attempt, status="ok",
                    wall_s=time.perf_counter() - t0,
                )
            return out


def retry_params(cfg) -> dict:
    """The ``resil:`` config block's retry knobs as ``with_retry`` kwargs."""
    r = cfg.get("resil", {})
    return {
        "attempts": int(r.get("retry_attempts", RETRY_ATTEMPTS)),
        "base_s": float(r.get("retry_base_s", RETRY_BASE_S)),
        "max_s": float(r.get("retry_max_s", RETRY_MAX_S)),
    }
