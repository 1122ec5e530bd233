"""Tiered residency ladder: disk -> host-RAM staging -> HBM (port of
``nerf_replication_tpu/fleet/ladder.py``; on a card the staged tensors are
page-locked, the residency manager's ``pin`` hook).

The one-level :class:`~.residency.ResidencyManager` *drops* a scene on
eviction — the next request pays the full cold path again (disk read,
tree-checksum walk, retry ladder, h2d). Under fleet churn that is the
dominant tail cost, and it is unnecessary: host RAM is orders of
magnitude larger than HBM. The :class:`TieredResidencyManager` keeps a
second, host-side tier:

* **Write-through staging.** Every disk load parks its host arrays in a
  byte-budgeted staging tier *before* the device copy (hook:
  ``_stage_host``). Staging has its own LRU and budget
  (``fleet.staging_mb``), independent of HBM.
* **Eviction demotes.** When the HBM budget pushes a scene out and its
  host copy is still staged, the eviction is a **demotion** — the
  ``scene_evict`` row says ``reason: demoted`` and re-admission is a
  pure host-to-device copy (``scene_load`` row with ``source: staging``): no
  disk, no checksum walk, no re-validation. Only when the staged copy is
  already gone does the row degrade to ``reason: lru`` (a true drop).
* **TTLs.** ``sweep()`` expires staged copies older than
  ``staging_ttl_s`` and demotes HBM residents idle past
  ``resident_ttl_s`` (both 0 = off) with ``reason: ttl`` — a scene
  nobody asked about in an hour should not hold bytes at EITHER tier.
* **Typed eviction reasons.** Every ``scene_evict`` row carries
  ``reason`` (``budget`` stays the one-level manager's spelling;
  the ladder emits ``demoted | lru | ttl | manual``) and ``tier``
  (``hbm | staging``), so ``tlm_report`` can split residency churn from
  actual reload cost.

Demote -> re-promote is bitwise: the staged arrays are the SAME host
buffers the original load produced, and re-promotion copies them
unchanged (tests/test_control_plane.py pins this, and that a
re-promotion never captures or builds a route).

Sharded scenes (model-parallel serving mesh) ride the same ladder as a
UNIT: the HBM tier accounts the per-device shard bytes
(``SceneData.nbytes``), while staging accounts the TOTAL host bytes —
host RAM holds the whole unsharded scene, so a demotion parks every
shard's source buffer and a re-promotion re-places all shards from it
in one ``placer`` call (still bitwise: same host buffers, same
partition specs). There is no per-shard demote; a scene is resident
everywhere or nowhere (docs/fleet.md "Per-shard byte accounting").
"""

from __future__ import annotations

import time
from collections import OrderedDict

from .residency import ResidencyManager, SceneData


class _Staged:
    """One host-side staged copy (numpy/host arrays, never device)."""

    __slots__ = ("data", "nbytes", "staged_t")

    def __init__(self, data: SceneData, nbytes: int):
        self.data = data
        self.nbytes = int(nbytes)
        self.staged_t = time.monotonic()


class TieredResidencyManager(ResidencyManager):
    """ResidencyManager with a host-RAM staging tier under the HBM LRU."""

    def __init__(self, registry, loader, budget_bytes: int, *,
                 staging_budget_bytes: int,
                 staging_ttl_s: float = 0.0,
                 resident_ttl_s: float = 0.0,
                 **kw):
        super().__init__(registry, loader, budget_bytes, **kw)
        self.staging_budget_bytes = int(staging_budget_bytes)
        self.staging_ttl_s = float(staging_ttl_s)
        self.resident_ttl_s = float(resident_ttl_s)
        self._staging: OrderedDict[str, _Staged] = OrderedDict()
        # ladder counters (under the lock, like the base set)
        self.demotions = 0          # HBM evictions that kept a staged copy
        self.repromotions = 0       # loads served from staging (no disk)
        self.disk_loads = 0         # loads that walked the cold path
        self.staging_evictions = 0  # staged copies dropped (lru + ttl)
        self.ttl_evictions = 0      # ttl expiries at either tier
        self.manual_evictions = 0

    # -- tier hooks (called by the base manager) ------------------------------

    def _staged_host(self, scene_id: str) -> SceneData | None:
        with self._cond:
            self._sweep_staging_locked(time.monotonic())
            staged = self._staging.get(scene_id)
            if staged is not None:
                self._staging.move_to_end(scene_id)
        self._flush_rows()  # TTL sweep may have queued evict rows
        return staged.data if staged is not None else None

    def _note_load(self, source: str) -> None:
        # commit-time accounting (base hook, under the lock): lookups
        # that never commit (admission overload) must not drift the
        # loads == disk_loads + repromotions ledger
        if source == "staging":
            self.repromotions += 1
        else:
            self.disk_loads += 1

    def _stage_host(self, scene_id: str, host: SceneData, nbytes: int) -> None:
        # called under the lock (commit path)
        if nbytes > self.staging_budget_bytes:
            return  # bigger than the whole tier: not stageable
        staged = self._staging.get(scene_id)
        if staged is not None:
            staged.staged_t = time.monotonic()
            self._staging.move_to_end(scene_id)
            return
        self._staging[scene_id] = _Staged(host, nbytes)
        while self._staging_bytes() > self.staging_budget_bytes:
            self._evict_staged_locked(next(iter(self._staging)), "lru")

    def _invalidate_staged(self, scene_id: str) -> None:
        # called under the lock (publish swap): stale version, silent drop
        self._staging.pop(scene_id, None)

    def _retire(self, scene_id: str, resident) -> str:
        # called under the lock, victim already out of the resident dict
        staged = self._staging.get(scene_id)
        if staged is not None:
            staged.staged_t = time.monotonic()
            self._staging.move_to_end(scene_id)
            self.demotions += 1
            return "demoted"
        return "lru"

    def _tier_fields(self) -> dict:
        sb = self._staging_bytes()
        if self.capacity is not None:
            self.capacity.note_residency(self._resident_bytes(), sb)
        return {"staging": len(self._staging), "staging_bytes": sb}

    # -- staging internals ----------------------------------------------------

    def _staging_bytes(self) -> int:
        return sum(s.nbytes for s in self._staging.values())

    def _evict_staged_locked(self, scene_id: str, reason: str) -> None:
        staged = self._staging.pop(scene_id)
        self.staging_evictions += 1
        if reason == "ttl":
            self.ttl_evictions += 1
        elif reason == "manual":
            self.manual_evictions += 1
        self._queue_row(
            "scene_evict", scene=scene_id, bytes=staged.nbytes,
            reason=reason, tier="staging",
            resident=len(self._resident),
            resident_bytes=self._resident_bytes(),
            **self._tier_fields(),
        )

    def _sweep_staging_locked(self, now: float) -> None:
        if self.staging_ttl_s <= 0:
            return
        expired = [sid for sid, s in self._staging.items()
                   if now - s.staged_t > self.staging_ttl_s]
        for sid in expired:
            self._evict_staged_locked(sid, "ttl")

    # -- TTL / manual surface -------------------------------------------------

    def sweep(self, now: float | None = None) -> dict:
        """Expire TTL-stale entries at both tiers (tests pass a future
        ``now``; production calls it from a maintenance cadence).

        HBM residents idle past ``resident_ttl_s`` demote (their staged
        copy survives — re-promotion stays cheap); staged copies older
        than ``staging_ttl_s`` drop. Returns eviction counts."""
        now = time.monotonic() if now is None else float(now)
        out = {"hbm": 0, "staging": 0}
        with self._cond:
            if self.resident_ttl_s > 0:
                idle = [sid for sid, r in self._resident.items()
                        if r.refcount == 0
                        and now - r.last_used_t > self.resident_ttl_s]
                for sid in idle:
                    victim = self._resident.pop(sid)
                    self.evictions += 1
                    self.ttl_evictions += 1
                    self.bytes_evicted += victim.data.nbytes
                    self._queue_row(
                        "scene_evict", scene=sid, bytes=victim.data.nbytes,
                        reason="ttl", tier="hbm",
                        resident=len(self._resident),
                        resident_bytes=self._resident_bytes(),
                        **self._tier_fields(),
                    )
                    out["hbm"] += 1
            before = self.staging_evictions
            if self.staging_ttl_s > 0:
                expired = [sid for sid, s in self._staging.items()
                           if now - s.staged_t > self.staging_ttl_s]
                for sid in expired:
                    self._evict_staged_locked(sid, "ttl")
            out["staging"] = self.staging_evictions - before
            self._cond.notify_all()
        self._flush_rows()
        return out

    def evict(self, scene_id: str, *, drop_staged: bool = False) -> bool:
        """Operator eviction (``reason: manual``). Demotes the HBM entry
        (unless pinned -> False, nothing happens) and, with
        ``drop_staged``, purges the staged copy too."""
        with self._cond:
            resident = self._resident.get(scene_id)
            if resident is not None:
                if resident.refcount > 0:
                    return False
                self._resident.pop(scene_id)
                self.evictions += 1
                self.manual_evictions += 1
                self.bytes_evicted += resident.data.nbytes
                self._queue_row(
                    "scene_evict", scene=scene_id,
                    bytes=resident.data.nbytes, reason="manual", tier="hbm",
                    resident=len(self._resident),
                    resident_bytes=self._resident_bytes(),
                    **self._tier_fields(),
                )
            if drop_staged and scene_id in self._staging:
                self._evict_staged_locked(scene_id, "manual")
            self._cond.notify_all()
        self._flush_rows()
        return True

    # -- introspection --------------------------------------------------------

    def staged_ids(self) -> list[str]:
        """Staging LRU -> MRU order."""
        with self._cond:
            return list(self._staging)

    def stats(self) -> dict:
        out = super().stats()
        with self._cond:
            out.update(
                staging=list(self._staging),
                staging_bytes=self._staging_bytes(),
                staging_budget_bytes=self.staging_budget_bytes,
                demotions=self.demotions,
                repromotions=self.repromotions,
                disk_loads=self.disk_loads,
                staging_evictions=self.staging_evictions,
                ttl_evictions=self.ttl_evictions,
                manual_evictions=self.manual_evictions,
            )
        return out
