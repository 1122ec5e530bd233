"""Per-tenant QoS: admission quotas, fair-share weights, scoped breakers.
(port of ``nerf_replication_tpu/fleet/qos.py``, host-side: no torch).

One hot client behind the shared micro-batcher can starve every other
tenant — the queue is FIFO, the breaker is global, and nothing meters
submissions. This module gives the serve edge a tenant dimension:

* **Token-bucket admission.** Each tenant owns a bucket (``burst``
  capacity, ``rate`` tokens/s refill). ``admit(tenant)`` takes a token
  or raises :class:`TenantQuotaError` — a typed 429 (``Retry-After`` =
  time until a token exists) that the HTTP edge maps before the request
  touches the queue. Every decision emits a ``tenant_admit`` row and a
  ``tenant_admits_total{tenant,decision}`` counter.
* **Fair-share weights.** ``weight(tenant)`` feeds the micro-batcher's
  weighted fair batch cuts (serve/batcher.py): batch assembly drains
  tenant queues in virtual-time order, so a saturated tenant gets its
  weighted share of rays and no more while a quiet tenant's requests
  never wait behind the flood.
* **Per-tenant breakers.** ``breaker(tenant)`` is a lazily-built
  :class:`~..resil.CircuitBreaker` (point ``tenant.<name>``): dispatch
  failures attributable to one tenant's batches degrade and eventually
  fast-fail THAT tenant (``resil``'s shed ladder and breaker semantics,
  scoped), leaving the engine-level breaker — and every other tenant —
  untouched.

A sustained deny streak (``dump_after_denies``) snapshots the flight
recorder once per tenant, naming the throttled tenant — chaos_run's
multi-tenant scenario asserts the dump exists next to the injected
fault's.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from ..obs import get_emitter
from ..obs.metrics import get_metrics
from ..resil import CircuitBreaker, dump_flight


class TenantQuotaError(RuntimeError):
    """Admission denied: the tenant's token bucket is empty (HTTP 429 +
    Retry-After at the serve edge; never a dispatch failure — the
    engine-level breaker must not see quota pressure)."""

    def __init__(self, tenant: str, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.tenant = tenant
        self.retry_after_s = max(0.0, float(retry_after_s))


@dataclass(frozen=True)
class TenantPolicy:
    """One tenant's quota + share. ``rate`` is sustained requests/s,
    ``burst`` the bucket capacity, ``weight`` the fair-batching share."""

    tenant: str
    rate: float = 200.0
    burst: float = 50.0
    weight: float = 1.0


class _Bucket:
    __slots__ = ("tokens", "last", "admits", "denies", "deny_streak",
                 "dumped")

    def __init__(self, burst: float, now: float):
        self.tokens = float(burst)
        self.last = now
        self.admits = 0
        self.denies = 0
        self.deny_streak = 0
        self.dumped = False


# sentinel policy name for tenant-less requests (classic single-tenant
# serving rides the default bucket/weight and stays API-compatible)
DEFAULT_TENANT = "_default"


class QosController:
    """Admission + weights + scoped breakers for the serve edge."""

    def __init__(self, policies=(), *,
                 default: TenantPolicy | None = None,
                 clock=time.monotonic,
                 breaker_threshold: int = 5,
                 breaker_cooldown_s: float = 5.0,
                 dump_after_denies: int = 8):
        self.clock = clock
        self.default = default or TenantPolicy(DEFAULT_TENANT)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.dump_after_denies = int(dump_after_denies)
        self._policies: dict[str, TenantPolicy] = {
            p.tenant: p for p in policies
        }
        self._lock = threading.Lock()
        self._buckets: dict[str, _Bucket] = {}
        self._breakers: dict[str, CircuitBreaker] = {}

    @classmethod
    def from_cfg(cls, cfg, clock=time.monotonic) -> "QosController | None":
        """Controller from the ``fleet.qos`` block (None when disabled).
        Breaker thresholds ride the shared ``resil:`` knobs so the
        per-tenant ladder degrades exactly like the engine-level one."""
        f = cfg.get("fleet", {}) if cfg is not None else {}
        q = f.get("qos", {})
        if not q or not bool(q.get("enabled", False)):
            return None
        r = cfg.get("resil", {})
        default = TenantPolicy(
            DEFAULT_TENANT,
            rate=float(q.get("default_rate", 200.0)),
            burst=float(q.get("default_burst", 50.0)),
            weight=float(q.get("default_weight", 1.0)),
        )
        policies = []
        for name, spec in dict(q.get("tenants", {})).items():
            spec = dict(spec or {})
            policies.append(TenantPolicy(
                str(name),
                rate=float(spec.get("rate", default.rate)),
                burst=float(spec.get("burst", default.burst)),
                weight=float(spec.get("weight", default.weight)),
            ))
        return cls(
            policies, default=default, clock=clock,
            breaker_threshold=int(r.get("breaker_threshold", 5)),
            breaker_cooldown_s=float(r.get("breaker_cooldown_s", 5.0)),
        )

    # -- policy lookup --------------------------------------------------------

    def policy(self, tenant: str | None) -> TenantPolicy:
        name = DEFAULT_TENANT if tenant is None else str(tenant)
        p = self._policies.get(name)
        if p is None:
            # unknown tenants get the default quota under their own
            # bucket — isolation without preregistration
            p = TenantPolicy(name, rate=self.default.rate,
                             burst=self.default.burst,
                             weight=self.default.weight)
            self._policies[name] = p
        return p

    def weight(self, tenant: str | None) -> float:
        return max(1e-6, float(self.policy(tenant).weight))

    # -- admission ------------------------------------------------------------

    def admit(self, tenant: str | None) -> float:
        """Take one token from the tenant's bucket; returns the level
        after the take. Raises :class:`TenantQuotaError` when empty."""
        p = self.policy(tenant)
        now = self.clock()
        with self._lock:
            b = self._buckets.get(p.tenant)
            if b is None:
                b = self._buckets[p.tenant] = _Bucket(p.burst, now)
            b.tokens = min(p.burst, b.tokens + (now - b.last) * p.rate)
            b.last = now
            if b.tokens >= 1.0:
                b.tokens -= 1.0
                b.admits += 1
                b.deny_streak = 0
                remaining = b.tokens
                denied = False
            else:
                b.denies += 1
                b.deny_streak += 1
                remaining = b.tokens
                denied = True
                retry_after = (1.0 - b.tokens) / max(p.rate, 1e-9)
                dump = (not b.dumped
                        and b.deny_streak >= self.dump_after_denies)
                if dump:
                    b.dumped = True
        decision = "deny" if denied else "admit"
        get_emitter().emit(
            "tenant_admit", tenant=p.tenant, decision=decision,
            quota_remaining=round(remaining, 3), rate=p.rate, burst=p.burst,
            **({"retry_after_s": round(retry_after, 4)} if denied else {}),
        )
        get_metrics().counter("tenant_admits_total", tenant=p.tenant,
                              decision=decision)
        if denied:
            if dump:
                # once per sustained throttle: name the tenant in the
                # post-mortem ring (chaos_run asserts this dump)
                dump_flight(
                    "tenant_throttled",
                    detail=f"tenant={p.tenant} deny_streak={b.deny_streak} "
                           f"rate={p.rate}/s burst={p.burst}",
                )
            raise TenantQuotaError(
                p.tenant,
                f"tenant {p.tenant!r} over quota ({p.rate:g} req/s, "
                f"burst {p.burst:g}); retry after {retry_after:.3f}s",
                retry_after_s=retry_after,
            )
        return remaining

    # -- scoped breakers ------------------------------------------------------

    def breaker(self, tenant: str | None) -> CircuitBreaker:
        p = self.policy(tenant)
        with self._lock:
            b = self._breakers.get(p.tenant)
            if b is None:
                b = CircuitBreaker(
                    threshold=self.breaker_threshold,
                    cooldown_s=self.breaker_cooldown_s,
                    clock=self.clock,
                    point=f"tenant.{p.tenant}",
                )
                self._breakers[p.tenant] = b
            return b

    # -- introspection --------------------------------------------------------

    def stats(self) -> dict:
        now = self.clock()
        with self._lock:
            tenants = {}
            for name, b in self._buckets.items():
                p = self._policies[name]
                level = min(p.burst, b.tokens + (now - b.last) * p.rate)
                tenants[name] = {
                    "admits": b.admits,
                    "denies": b.denies,
                    "tokens": round(level, 2),
                    "rate": p.rate,
                    "burst": p.burst,
                    "weight": p.weight,
                }
            breakers = {n: brk.snapshot()
                        for n, brk in self._breakers.items()}
        for name, snap in breakers.items():
            tenants.setdefault(name, {})["breaker"] = snap
        return {"tenants": tenants}
