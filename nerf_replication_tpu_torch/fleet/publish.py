"""Scene hot-update: publish version N+1 under live traffic (port of
``nerf_replication_tpu/fleet/publish.py``).

Retraining a scene must not mean restarting the server or even dropping
the scene: :class:`ScenePublisher` swaps a resident scene's arrays for a
new checkpoint's **atomically**, while in-flight requests finish on the
old version. The protocol, in order:

1. **Gate.** The new checkpoint's tree checksum is verified and the new
   arrays are loaded + compat-validated *before anything changes* — a
   torn N+1 raises :class:`~.errors.SceneLoadError` with a ``torn``
   fault row, and version N keeps serving untouched (the registry still
   names N's artifacts).
2. **Admit + transfer.** N+1's bytes are admitted against the HBM budget
   (both versions are briefly charged) and copied to the device (the
   residency manager's ``placer``) — still no
   behavior change.
3. **Drain.** The scene enters the publishing set: NEW acquires park on
   the residency condition (they will render N+1), while the pinned
   leases already held — the same refcounts that block eviction
   mid-batch — drain naturally as their batches complete on N.
   ``drain_ms`` in the ``scene_publish`` row is how long that took; a
   drain past ``drain_timeout_s`` aborts the publish
   (:class:`~.errors.ScenePublishError`), refunds N+1's bytes, and N
   serves on.
4. **Swap.** With zero pins, the resident entry is replaced in one
   assignment under the lock, the registry record is updated to N+1's
   artifacts (write-through on a sharded :class:`~.store.SceneStore`),
   and any staged host copy of N is invalidated (stale bytes must not
   re-promote). Parked acquires wake into N+1.

The swap changes *argument values only* — same shapes, same dtypes, the
same warmed routes, whose slots the next batch fills from N+1 — so a
hot-update adds no capture and no route build (tests/
test_torch_control_plane.py).
"""

from __future__ import annotations

import threading
import time

from ..obs import get_emitter
from ..resil import fault_point
from .errors import ScenePublishError
from .residency import ResidencyManager, _Resident, _tree_nbytes


class ScenePublisher:
    """Versioned hot-update surface over one ResidencyManager."""

    def __init__(self, residency: ResidencyManager, *,
                 drain_timeout_s: float = 30.0):
        self.residency = residency
        self.drain_timeout_s = float(drain_timeout_s)
        self._lock = threading.Lock()
        self._versions: dict[str, int] = {}
        self.publishes = 0
        self.failed_publishes = 0

    def version(self, scene_id: str) -> int:
        with self._lock:
            return self._versions.get(scene_id, 1)

    def publish(self, record, *, to_version: int | None = None,
                drain_timeout_s: float | None = None) -> dict:
        """Swap ``record.scene_id`` to the artifacts ``record`` names.

        Returns the ``scene_publish`` row fields. Raises SceneLoadError
        (torn/unloadable N+1 — N keeps serving), SceneCompatError
        (N+1 would need its own routes), or ScenePublishError (drain
        timeout / concurrent publish — N keeps serving)."""
        res = self.residency
        sid = record.scene_id
        timeout = (self.drain_timeout_s if drain_timeout_s is None
                   else float(drain_timeout_s))
        from_version = self.version(sid)
        to_version = from_version + 1 if to_version is None else int(to_version)
        t0 = time.perf_counter()

        # chaos seam: a publish-time fault (io_error/truncate) must fail
        # THIS publish and nothing else
        fault_point("fleet.publish", path=record.checkpoint or None)

        with res._cond:
            if sid in res._publishing:
                raise ScenePublishError(
                    sid, f"scene {sid!r}: publish already in flight")

        # 1. gate: checksum + load + validate, before anything changes.
        # _load_host owns the torn-detection ladder (fault row + typed
        # raise), exactly like a cold load of N+1 would.
        try:
            host = res._load_host(record)
            if res.validate is not None:
                res.validate(host)
        except Exception as err:
            self.failed_publishes += 1
            get_emitter().emit(
                "scene_publish", scene=sid, from_version=from_version,
                to_version=to_version, drain_ms=0.0,
                status="torn" if "torn" in str(err) else "error",
            )
            raise
        nbytes = _tree_nbytes(host)

        # 2. admit + transfer: both versions charged until the swap ends
        res._admit(sid, nbytes)
        try:
            tree = (host.params, host.grid, host.bbox)
            (params, grid, bbox), ready = (
                res.placer(tree) if res.placer is not None else (tree, None))
        except BaseException:
            with res._cond:
                res._reserved -= nbytes
                res._cond.notify_all()
            raise
        from dataclasses import replace as _replace

        new_data = _replace(host, params=params, grid=grid, bbox=bbox,
                            nbytes=nbytes, ready=ready)

        # 3. drain: park new acquires, wait out the pinned leases on N
        # AND any in-flight load of N (a prefetch committing after the
        # swap would silently revert the scene to the old version)
        swapped = False
        t_drain = time.perf_counter()
        with res._cond:
            res._publishing.add(sid)
            try:
                deadline = time.monotonic() + timeout
                while True:
                    resident = res._resident.get(sid)
                    pins = 0 if resident is None else resident.refcount
                    if pins == 0 and sid not in res._loading:
                        break
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise ScenePublishError(
                            sid,
                            f"scene {sid!r}: drain for v{to_version} timed "
                            f"out after {timeout:.1f}s ({pins} leases still "
                            f"pinned); v{from_version} keeps serving",
                        )
                    res._cond.wait(timeout=min(left, 0.1))
                # 4. swap: registry record first (a failed write leaves
                # the resident set untouched), then one dict assignment;
                # the old arrays release when the entry — and any stale
                # staged copy of N — lets go
                drain_ms = (time.perf_counter() - t_drain) * 1e3
                res.registry.register(record)
                old = res._resident.pop(sid, None)
                res._reserved -= nbytes
                swapped = True
                entry = _Resident(new_data, "publish")
                entry.ever_acquired = True  # not a prefetch-hit candidate
                res._resident[sid] = entry
                res._resident.move_to_end(sid)
                res.loads += 1
                res.bytes_loaded += nbytes
                if old is not None:
                    res.bytes_evicted += old.data.nbytes
                res._invalidate_staged(sid)
                res._stage_host(sid, host, nbytes)
                n_res = len(res._resident)
                res_bytes = res._resident_bytes()
                tier_fields = res._tier_fields()
            except BaseException:
                # abort: refund N+1's reservation and unpark acquires —
                # version N is still the resident entry
                if not swapped:
                    res._reserved -= nbytes
                self.failed_publishes += 1
                raise
            finally:
                res._publishing.discard(sid)
                res._cond.notify_all()
        # the staging write-through queues its evict rows under the lock
        res._flush_rows()

        with self._lock:
            self._versions[sid] = to_version
            self.publishes += 1
        get_emitter().emit(
            "scene_load", scene=sid, bytes=nbytes, source="publish",
            load_s=round(time.perf_counter() - t0, 4),
            resident=n_res, resident_bytes=res_bytes, **tier_fields,
        )
        row = {
            "scene": sid, "from_version": from_version,
            "to_version": to_version, "drain_ms": round(drain_ms, 3),
            "bytes": nbytes, "status": "ok",
        }
        get_emitter().emit("scene_publish", **row)
        return row

    def stats(self) -> dict:
        with self._lock:
            return {
                "versions": dict(self._versions),
                "publishes": self.publishes,
                "failed_publishes": self.failed_publishes,
            }
