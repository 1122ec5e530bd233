"""HBM-budgeted scene residency: which scenes live on the card (port of
``nerf_replication_tpu/fleet/residency.py``).

The engine's warmed routes read slot tensors that a scene's weights, grid
and bbox are copied into before a batch (``serve/engine.py``), so ONE warmed
bucket x tier family renders every scene — the scaling bottleneck is device
memory, not capture time. The :class:`ResidencyManager` turns that
bottleneck into a managed budget:

* ``acquire(scene_id)`` returns device-resident ``SceneData`` (the
  network's state dict + grid + bbox, as tensors), loading on miss and
  **evicting LRU scenes** when the configured byte budget — the real
  tensor bytes (:func:`_tree_nbytes`, JAX's figure on the same tree), not
  an estimate — would overflow;
* acquire/release are **pin/unpin refcounts**: an in-flight batch holds
  a lease, and a pinned scene can never be evicted under it. If every
  resident scene is pinned and the budget is full, admission fails with
  :class:`ResidencyOverloadError` (503 + Retry-After at the HTTP edge);
* ``prefetch(scene_id)`` starts the host load and the host-to-device copy
  on a background thread (the engine's placer copies from pinned host
  memory on a side CUDA stream and records an event the serving stream
  waits on), so the first request for a new scene overlaps its transfer
  with the batch rendering now — an ``acquire`` that lands on an
  in-flight prefetch joins it instead of double-loading;
* each scene keeps its own :class:`~..serve.cache.PoseCache` (host-side,
  so it survives eviction cycles).

Loads run through the ``fleet.load`` fault point with bounded retry, and
checkpoint directories are gated by a tree SHA-256 (resil/checksum): a
torn scene emits a ``torn`` fault row and fails THAT scene's requests
only. Every materialization emits a ``scene_load`` row and every
eviction a ``scene_evict`` row (obs/schema.py).

The hooks the engine installs (``attach_fleet``): ``validate`` (the compat
check), ``placer`` (host tree -> device tree), ``shard_nbytes`` (the bytes
one device holds) and ``pin`` (host tensors into page-locked memory on a
card, so the staging tier and the prefetch copy read pinned buffers).
Without them the manager keeps host tensors (CPU engines and tests).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, replace

from ..obs import get_emitter
from ..obs.trace import current_ctx, get_tracer
from ..resil import fault_point, report, verify_tree_checksum, with_retry
from ..serve.cache import PoseCache
from .errors import ResidencyOverloadError, SceneLoadError

# LRU recency is a monotone counter, not a wall clock: eviction order is
# a pure function of the acquire sequence (deterministic under test)
_TOUCH = 0


@dataclass(frozen=True)
class SceneData:
    """One scene's render inputs: on the host, ``params`` the network's
    state dict (name -> tensor), the fine ``grid`` level (bool) and
    ``bbox`` ([2, 3] float32); placed by the engine
    (``scale.mesh_dispatch.place_tree``), a ``MeshParams`` and one grid
    and bbox a data index. ``nbytes`` is filled by the manager from the
    real tensor sizes — the PER-DEVICE figure; ``total_nbytes`` the whole
    scene (they coincide without a model-parallel serving mesh).
    ``ready``: the CUDA events the device copies recorded (None or empty:
    nothing to wait for)."""

    scene_id: str
    params: object
    grid: object = None
    bbox: object = None
    near: float = 2.0
    far: float = 6.0
    nbytes: int = 0
    total_nbytes: int = 0
    ready: object = None


class _Resident:
    """Book-keeping wrapper around one device-resident scene."""

    __slots__ = ("data", "refcount", "touch", "source", "ever_acquired",
                 "last_used_t")

    def __init__(self, data: SceneData, source: str):
        self.data = data
        self.refcount = 0
        self.touch = 0
        self.source = source          # "cold" | "prefetch" | "staging" | ...
        self.ever_acquired = False
        self.last_used_t = time.monotonic()   # wall recency (TTL sweeps)


class _Load:
    """One in-flight load (cold or prefetch) other threads can join."""

    __slots__ = ("event", "error", "source")

    def __init__(self, source: str):
        self.event = threading.Event()
        self.error: BaseException | None = None
        self.source = source


def _nbytes(t) -> int:
    return 0 if t is None else int(t.numel()) * int(t.element_size())


def _tree_nbytes(data: SceneData) -> int:
    """Real byte footprint: every params tensor + grid + bbox."""
    return (sum(_nbytes(t) for t in data.params.values())
            + _nbytes(data.grid) + _nbytes(data.bbox))


class ResidencyManager:
    """Byte-budgeted LRU of device-resident scenes with pinned leases."""

    def __init__(self, registry, loader, budget_bytes: int, *,
                 prefetch: bool = True, verify_checksums: bool = True,
                 cache_entries: int = 64, pose_decimals: int = 3,
                 validate=None, retry_kw: dict | None = None,
                 capacity=None):
        self.registry = registry
        self.loader = loader
        self.budget_bytes = int(budget_bytes)
        # optional obs.capacity.CapacityLedger: fed authoritative byte
        # watermarks at every row-emitting tier transition
        self.capacity = capacity
        self.prefetch_enabled = bool(prefetch)
        self.verify_checksums = bool(verify_checksums)
        self.cache_entries = int(cache_entries)
        self.pose_decimals = int(pose_decimals)
        self.validate = validate
        # placement hooks (engine.attach_fleet installs them): ``placer``
        # maps a host (params, grid, bbox) tree to ``(device tree, ready
        # event)``; ``shard_nbytes`` returns the bytes one device holds
        # (the figure the budget checks); ``pin`` page-locks a host tree.
        # None keeps host tensors and the real tensor bytes.
        self.placer = None
        self.shard_nbytes = None
        self.param_shards = 1
        self.pin = None
        self.retry_kw = dict(retry_kw or {})
        self._cond = threading.Condition()
        self._resident: OrderedDict[str, _Resident] = OrderedDict()
        self._loading: dict[str, _Load] = {}
        self._reserved = 0            # bytes admitted but not yet committed
        # scenes mid-hot-update (fleet/publish.py): new acquires park on
        # the condition until the version swap lands, so the publisher's
        # refcount drain barrier cannot be starved by fresh pins
        self._publishing: set[str] = set()
        self._pose_caches: dict[str, PoseCache] = {}
        # telemetry rows queued under the lock, emitted after release —
        # the emitter writes a file, and every waiter on the condition
        # would pay that write (graftlint R12 blocking-under-lock)
        self._pending_rows: list[tuple[str, dict]] = []
        # counters (read via stats(); mutated under the lock)
        self.loads = 0
        self.cold_loads = 0
        self.prefetch_issued = 0
        self.prefetch_hits = 0
        self.warm_hits = 0
        self.evictions = 0
        self.overloads = 0
        self.load_errors = 0
        self.bytes_loaded = 0
        self.bytes_evicted = 0

    # -- acquire / release ----------------------------------------------------

    def acquire(self, scene_id: str) -> SceneData:
        """Pin ``scene_id`` on the device and return its SceneData.

        Loads on miss (joining an in-flight prefetch when one is
        running); the caller MUST :meth:`release` — ``lease`` is the
        safe surface."""
        global _TOUCH
        # the acquire span covers the whole pin — a warm hit closes it in
        # microseconds, a prefetch join waits under it (attributed via
        # `joined`), and a cold load nests a child "scene.load" span
        with get_tracer().span("scene.acquire", stage="acquire",
                               scene=scene_id) as sp:
            while True:
                with self._cond:
                    # a publish in flight for this scene: park until the
                    # swap lands (the post-swap pin renders version N+1)
                    while scene_id in self._publishing:
                        self._cond.wait()
                    resident = self._resident.get(scene_id)
                    if resident is not None:
                        resident.refcount += 1
                        _TOUCH += 1
                        resident.touch = _TOUCH
                        resident.last_used_t = time.monotonic()
                        self._resident.move_to_end(scene_id)
                        if not resident.ever_acquired:
                            # first pin after materialization: a prefetch
                            # hit, or the tail of this thread's own cold
                            # load (already counted at load start)
                            if resident.source == "prefetch":
                                self.prefetch_hits += 1
                        else:
                            self.warm_hits += 1
                        resident.ever_acquired = True
                        return resident.data
                    load = self._loading.get(scene_id)
                    if load is None:
                        # miss with no in-flight load: this thread
                        # cold-loads
                        load = _Load("cold")
                        self._loading[scene_id] = load
                        self.cold_loads += 1
                        started_here = True
                    else:
                        started_here = False
                if not started_here:
                    # joining someone else's in-flight load (usually the
                    # prefetch thread): the wait is queue-shaped, not
                    # work-shaped — mark whose load we rode
                    sp.set(joined=load.source)
                    load.event.wait()
                    if load.error is not None:
                        raise load.error
                    continue  # committed by the loader thread; loop to pin
                try:
                    with get_tracer().span("scene.load", stage="load",
                                           scene=scene_id, source="cold"):
                        self._load_and_commit(scene_id, source="cold")
                except BaseException as err:
                    load.error = err
                    raise
                finally:
                    with self._cond:
                        self._loading.pop(scene_id, None)
                    load.event.set()

    def release(self, scene_id: str) -> None:
        with self._cond:
            resident = self._resident.get(scene_id)
            if resident is not None and resident.refcount > 0:
                resident.refcount -= 1
                self._cond.notify_all()

    @contextmanager
    def lease(self, scene_id: str):
        """``with residency.lease(sid) as data:`` — pinned for the block."""
        data = self.acquire(scene_id)
        try:
            yield data
        finally:
            self.release(scene_id)

    # -- prefetch -------------------------------------------------------------

    def prefetch(self, scene_id: str) -> bool:
        """Start a background load of ``scene_id``; True if one was
        actually started (False: disabled / resident / already loading /
        unknown scene — prefetch never raises, errors surface on the
        eventual acquire)."""
        if not self.prefetch_enabled or scene_id not in self.registry:
            return False
        with self._cond:
            if (scene_id in self._resident or scene_id in self._loading
                    or scene_id in self._publishing):
                return False
            load = _Load("prefetch")
            self._loading[scene_id] = load
            self.prefetch_issued += 1

        # capture the SUBMITTING thread's span context now: the prefetch
        # thread has no inherited context, so the load span is explicitly
        # parented to the request that kicked the prefetch — the
        # cross-thread attribution tests/test_trace.py pins down
        ctx = current_ctx()

        def _main():
            try:
                with get_tracer().span("scene.load", parent=ctx,
                                       stage="load", scene=scene_id,
                                       source="prefetch"):
                    self._load_and_commit(scene_id, source="prefetch")
            # graftlint: ok(swallow: error re-raised on the joining acquire; load_errors counted here)
            except BaseException as err:
                load.error = err
                with self._cond:
                    self.load_errors += 1
            finally:
                with self._cond:
                    self._loading.pop(scene_id, None)
                load.event.set()

        threading.Thread(
            target=_main, name=f"fleet-prefetch-{scene_id}", daemon=True
        ).start()
        return True

    def wait_loaded(self, scene_id: str, timeout: float | None = None) -> bool:
        """Block until no load is in flight for ``scene_id`` (test/bench
        barrier; True unless the wait timed out)."""
        with self._cond:
            load = self._loading.get(scene_id)
        return load.event.wait(timeout) if load is not None else True

    # -- load / evict core ----------------------------------------------------

    def _load_and_commit(self, scene_id: str, source: str) -> None:
        global _TOUCH
        record = self.registry.get(scene_id)
        t0 = time.perf_counter()
        # staging fast path (fleet/ladder.py): a demoted scene's host
        # tensors are still in RAM — re-promotion is a host-to-device
        # copy, not a disk load + checksum walk (validated at first load)
        host = self._staged_host(scene_id)
        if host is not None:
            source = "staging"
        else:
            host = self._load_host(record)
            if self.validate is not None:
                self.validate(host)   # SceneCompatError on mismatch
        total = _tree_nbytes(host)
        # per-device bytes: what one device must actually hold once the
        # scene is placed (the engine's shard_nbytes; replicated, the
        # total)
        host_tree = (host.params, host.grid, host.bbox)
        nbytes = (
            int(self.shard_nbytes(host_tree))
            if self.shard_nbytes is not None else total
        )
        if nbytes > self.budget_bytes:
            shards = int(self.param_shards)
            sharded = (
                f"{nbytes} bytes/device over {shards} param shard(s) "
                f"({total} bytes total)" if shards > 1
                else f"{nbytes} bytes"
            )
            raise ResidencyOverloadError(
                scene_id,
                f"scene {scene_id!r} needs {sharded}, over the whole "
                f"fleet budget ({self.budget_bytes} bytes/device)",
            )
        self._admit(scene_id, nbytes)
        try:
            device = (self.placer(host_tree) if self.placer is not None
                      else (host_tree, None))
        except BaseException:
            with self._cond:
                self._reserved -= nbytes
                self._cond.notify_all()
            raise
        (params, grid, bbox), ready = device
        data = replace(host, params=params, grid=grid, bbox=bbox,
                       nbytes=nbytes, total_nbytes=total, ready=ready)
        with self._cond:
            self._reserved -= nbytes
            self._cond.notify_all()
            resident = _Resident(data, source)
            _TOUCH += 1
            resident.touch = _TOUCH
            self._resident[scene_id] = resident
            self._resident.move_to_end(scene_id)
            self.loads += 1
            self._note_load(source)
            self.bytes_loaded += nbytes
            # write-through to the host-RAM staging tier (no-op in the
            # one-level manager): a later HBM eviction demotes instead of
            # dropping because the host copy is already staged. Staged at
            # TOTAL bytes — host RAM holds the whole unsharded scene.
            self._stage_host(scene_id, host, total)
            n_res, res_bytes = len(self._resident), self._resident_bytes()
            tier_fields = self._tier_fields()
        # staging write-through may have queued evict rows under the lock
        self._flush_rows()
        get_emitter().emit(
            "scene_load", scene=scene_id, bytes=nbytes, source=source,
            total_bytes=total, param_shards=int(self.param_shards),
            load_s=round(time.perf_counter() - t0, 4),
            resident=n_res, resident_bytes=res_bytes, **tier_fields,
        )

    def _load_host(self, record) -> SceneData:
        """Host-side artifact load: fault point + checksum gate + retry."""
        def _attempt():
            fault_point("fleet.load", path=record.checkpoint or None)
            if self.verify_checksums and record.checkpoint:
                ok = verify_tree_checksum(record.checkpoint)
                if ok is False:
                    report("fleet.load", "torn", path=record.checkpoint,
                           detail=f"scene {record.scene_id!r}: checkpoint "
                                  "tree checksum mismatch")
                    raise SceneLoadError(
                        record.scene_id,
                        f"scene {record.scene_id!r}: torn checkpoint "
                        f"(tree checksum mismatch at {record.checkpoint})",
                    )
            host = self.loader(record)
            return host if self.pin is None else self.pin(host)

        try:
            return with_retry(_attempt, point="fleet.load", **self.retry_kw)
        except SceneLoadError:
            with self._cond:
                self.load_errors += 1
            raise
        except OSError as err:
            with self._cond:
                self.load_errors += 1
            report("fleet.load", "io_error", path=record.checkpoint or None,
                   detail=f"{type(err).__name__}: {err}"[:200])
            raise SceneLoadError(
                record.scene_id,
                f"scene {record.scene_id!r}: load failed ({err})",
            ) from err

    def _resident_bytes(self) -> int:
        return sum(r.data.nbytes for r in self._resident.values())

    # -- deferred telemetry ----------------------------------------------------

    def _queue_row(self, kind: str, **fields) -> None:
        """Queue a telemetry row from inside a critical section; the
        emit (a file write) happens at the next ``_flush_rows()``."""
        self._pending_rows.append((kind, fields))

    def _flush_rows(self) -> None:
        """Emit everything queued. Call with the lock NOT held."""
        with self._cond:
            pending, self._pending_rows = self._pending_rows, []
        emitter = get_emitter()
        for kind, fields in pending:
            emitter.emit(kind, **fields)

    def _admit(self, scene_id: str, nbytes: int) -> None:
        """Reserve ``nbytes`` of budget, evicting cold LRU scenes first.

        Eviction happens BEFORE the h2d transfer so the budget is never
        transiently over-committed; pinned scenes are skipped, and if
        nothing evictable remains the admission fails."""
        try:
            with self._cond:
                while (self._resident_bytes() + self._reserved + nbytes
                       > self.budget_bytes):
                    victim_id = next(
                        (sid for sid, r in self._resident.items()
                         if r.refcount == 0),
                        None,
                    )
                    if victim_id is None:
                        if self._reserved > 0:
                            # a concurrent load holds the missing bytes;
                            # once it commits (or fails) its scene is
                            # evictable (or its reservation returns) —
                            # wait, don't fail
                            self._cond.wait(timeout=0.1)
                            continue
                        self.overloads += 1
                        raise ResidencyOverloadError(
                            scene_id,
                            f"cannot admit scene {scene_id!r} "
                            f"({nbytes} bytes/device): all "
                            f"{len(self._resident)} resident scenes are "
                            "pinned by in-flight batches",
                        )
                    victim = self._resident.pop(victim_id)
                    reason = self._retire(victim_id, victim)
                    self.evictions += 1
                    self.bytes_evicted += victim.data.nbytes
                    n_res = len(self._resident)
                    self._queue_row(
                        "scene_evict", scene=victim_id,
                        bytes=victim.data.nbytes, reason=reason,
                        resident=n_res,
                        resident_bytes=self._resident_bytes(),
                        **self._tier_fields(),
                    )
                self._reserved += nbytes
        finally:
            # queued evict rows land even when admission fails
            self._flush_rows()

    # -- residency-tier hooks (overridden by fleet/ladder.py) -----------------

    def _staged_host(self, scene_id: str) -> SceneData | None:
        """Host-side copy of ``scene_id`` if a staging tier holds one
        (None in the one-level manager: every miss is a disk load)."""
        return None

    def _note_load(self, source: str) -> None:
        """Per-source load accounting hook at commit (under the lock).
        Counted HERE and not at the staging lookup so a load that fails
        admission (overload, a failed device copy) never drifts the ledger:
        ``loads == disk_loads + repromotions`` must hold exactly."""

    def _stage_host(self, scene_id: str, host: SceneData, nbytes: int) -> None:
        """Write-through hook at commit (called under the lock)."""

    def _invalidate_staged(self, scene_id: str) -> None:
        """Drop a staged host copy (called under the lock) — a published
        version swap makes the old staged arrays stale."""

    def _retire(self, scene_id: str, resident: _Resident) -> str:
        """The victim just left the resident dict (under the lock);
        subclasses may keep its host arrays staged instead of dropping.
        Returns the ``scene_evict`` reason."""
        return "budget"

    def _tier_fields(self) -> dict:
        """Extra occupancy fields for scene_load/scene_evict rows.
        Called under the (non-reentrant) lock — do not re-acquire.
        Also the capacity-ledger watermark hook: every row-emitting
        transition passes through here, so the ledger sees every peak."""
        if self.capacity is not None:
            self.capacity.note_residency(self._resident_bytes(), 0)
        return {}

    # -- per-scene pose caches ------------------------------------------------

    def pose_cache(self, scene_id: str) -> PoseCache:
        """The scene's pose->image LRU (host-side: survives eviction, so
        a re-admitted scene's landmark views stay warm)."""
        with self._cond:
            cache = self._pose_caches.get(scene_id)
            if cache is None:
                cache = PoseCache(capacity=self.cache_entries,
                                  decimals=self.pose_decimals)
                self._pose_caches[scene_id] = cache
            return cache

    # -- introspection --------------------------------------------------------

    def resident_ids(self) -> list[str]:
        """LRU -> MRU order (index 0 is the next eviction candidate)."""
        with self._cond:
            return list(self._resident)

    def pinned_ids(self) -> list[str]:
        with self._cond:
            return [sid for sid, r in self._resident.items() if r.refcount]

    def stats(self) -> dict:
        with self._cond:
            loads = self.loads
            cold = self.cold_loads
            hits = self.prefetch_hits
            first_loads = hits + cold
            return {
                "known_scenes": len(self.registry),
                "resident": list(self._resident),
                "pinned": [s for s, r in self._resident.items() if r.refcount],
                "resident_bytes": self._resident_bytes(),
                "budget_bytes": self.budget_bytes,
                # 1 = replicated params; >1 = model-parallel serving,
                # where resident/budget bytes are per-device shard figures
                "param_shards": int(self.param_shards),
                "loads": loads,
                "cold_loads": cold,
                "warm_hits": self.warm_hits,
                "prefetch_issued": self.prefetch_issued,
                "prefetch_hits": hits,
                "prefetch_hit_rate": (hits / first_loads) if first_loads
                                     else 0.0,
                "evictions": self.evictions,
                "overloads": self.overloads,
                "load_errors": self.load_errors,
                "bytes_loaded": self.bytes_loaded,
                "bytes_evicted": self.bytes_evicted,
                "pose_caches": {
                    sid: c.stats() for sid, c in self._pose_caches.items()
                },
            }
