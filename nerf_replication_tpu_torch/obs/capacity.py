"""Per-scene / per-replica capacity-and-heat ledger (port of
``nerf_replication_tpu/obs/capacity.py``).

The placement planner (``scale/placement.py``) needs to answer "what loads where":
which scenes are hot, how much device memory and host-RAM staging each replica is
actually using at peak, and where device time goes per executable
family. Those facts all exist in the telemetry stream — this ledger
folds them into a committed, replayable accounting surface:

* **byte watermarks** — current + peak resident-HBM and staging bytes,
  fed by the residency managers (:meth:`note_residency`, wired through
  ``fleet/ladder.py``) and, as a fallback, by ``scene_load`` /
  ``scene_evict`` rows that carry ``resident_bytes``/``staging_bytes``;
* **scene heat** — request rate and rays/s per scene over a sliding
  window (``serve_request`` rows or explicit :meth:`note_request` on the
  replica submit path);
* **device-time share** — fraction of windowed device seconds per
  executable family (``span`` rows with ``stage="device"``);
* **churn** — cold loads (from disk) vs re-promotions (from staging) per
  scene, the ladder's effectiveness signal.

Read surfaces: labeled ``capacity_*`` gauges on /metrics (no local
``replica`` label — the fleet merge injects one), ``GET
/fleet/capacity`` (scale/fleet_metrics.py), and a schema-versioned
``capacity_snapshot`` telemetry row per :meth:`snapshot` — the
planner's replayable input format.

Host-side pure Python, injectable clock, thread-safe.
"""

from __future__ import annotations

import threading
import time

from .emit import add_row_tap, get_emitter, remove_row_tap
from .metrics import WindowRing, get_metrics


class _SceneHeat:
    __slots__ = ("requests", "rays", "cold_loads", "repromotions")

    def __init__(self, slot_s: float):
        self.requests = WindowRing(slot_s=slot_s)
        self.rays = WindowRing(slot_s=slot_s)
        self.cold_loads = 0
        self.repromotions = 0


class CapacityLedger:
    """Folds residency/serve/span telemetry into capacity accounting.

    ``window_s`` is the sliding window rates and shares are computed
    over; ``replica`` stamps emitted ``capacity_snapshot`` rows (NOT the
    gauges — ``merge_scrapes`` injects the replica label fleet-side).
    """

    def __init__(self, *, replica: str = "", window_s: float = 300.0,
                 clock=time.monotonic):
        self.replica = str(replica)
        self.window_s = float(window_s)
        self.clock = clock
        slot = max(0.25, min(5.0, self.window_s / 20.0))
        self._slot = slot
        self._lock = threading.Lock()
        self._scenes: dict[str, _SceneHeat] = {}
        self._device: dict[str, WindowRing] = {}  # family -> device seconds
        self.hbm_bytes = 0
        self.hbm_peak_bytes = 0
        self.staging_bytes = 0
        self.staging_peak_bytes = 0
        self.n_snapshots = 0

    # -- feeds ---------------------------------------------------------------

    def attach(self) -> "CapacityLedger":
        add_row_tap(self._on_row)
        return self

    def detach(self) -> None:
        remove_row_tap(self._on_row)

    def _scene(self, name: str) -> _SceneHeat:
        h = self._scenes.get(name)
        if h is None:
            h = self._scenes[name] = _SceneHeat(self._slot)
        return h

    def note_request(self, scene: str, n_rays: int,
                     now: float | None = None) -> None:
        """One served request against ``scene`` (replica submit path)."""
        now = self.clock() if now is None else now
        with self._lock:
            h = self._scene(str(scene) or "default")
            h.requests.add(1.0, now)
            h.rays.add(float(n_rays), now)

    def note_residency(self, resident_bytes: int, staging_bytes: int) -> None:
        """Authoritative byte watermarks from a residency manager (the
        ladder calls this at every tier transition, under its lock)."""
        with self._lock:
            self._note_residency_locked(int(resident_bytes),
                                        int(staging_bytes))

    def _note_residency_locked(self, rb: int, sb: int) -> None:
        self.hbm_bytes = rb
        self.staging_bytes = sb
        if rb > self.hbm_peak_bytes:
            self.hbm_peak_bytes = rb
        if sb > self.staging_peak_bytes:
            self.staging_peak_bytes = sb

    def _on_row(self, row: dict) -> None:
        kind = row.get("kind")
        now = self.clock()
        with self._lock:
            if kind == "serve_request":
                h = self._scene(str(row.get("scene") or "default"))
                h.requests.add(1.0, now)
                h.rays.add(float(row.get("n_rays", 0)), now)
            elif kind == "scene_load":
                h = self._scene(str(row.get("scene", "")))
                if row.get("source") == "staging":
                    h.repromotions += 1
                else:
                    h.cold_loads += 1
                self._row_residency(row)
            elif kind == "scene_evict":
                self._row_residency(row)
            elif kind == "span":
                if row.get("stage") == "device":
                    fam = str(row.get("family") or row.get("name") or "")
                    ring = self._device.get(fam)
                    if ring is None:
                        ring = self._device[fam] = WindowRing(
                            slot_s=self._slot)
                    ring.add(float(row.get("dur_s", 0.0)), now)

    def _row_residency(self, row: dict) -> None:
        # rows carry the manager's post-transition totals when present
        rb = row.get("resident_bytes")
        if rb is None:
            return
        sb = row.get("staging_bytes", self.staging_bytes)
        self._note_residency_locked(int(rb), int(sb))

    # -- read surfaces -------------------------------------------------------

    def view(self, now: float | None = None) -> dict:
        """The ledger's current accounting (the /fleet/capacity shape)."""
        now = self.clock() if now is None else now
        w = self.window_s
        with self._lock:
            scenes = {}
            total_req = 0.0
            total_rays = 0.0
            for name, h in sorted(self._scenes.items()):
                nreq = h.requests.total(w, now)
                nrays = h.rays.total(w, now)
                total_req += nreq
                total_rays += nrays
                scenes[name] = {
                    "requests_per_s": round(nreq / w, 4),
                    "rays_per_s": round(nrays / w, 1),
                    "cold_loads": h.cold_loads,
                    "repromotions": h.repromotions,
                }
            dev = {f: r.total(w, now) for f, r in self._device.items()}
            dev_total = sum(dev.values())
            share = {f: round(s / dev_total, 4)
                     for f, s in sorted(dev.items()) if dev_total > 0}
            return {
                "replica": self.replica,
                "window_s": w,
                "hbm_bytes": self.hbm_bytes,
                "hbm_peak_bytes": self.hbm_peak_bytes,
                "staging_bytes": self.staging_bytes,
                "staging_peak_bytes": self.staging_peak_bytes,
                "requests_per_s": round(total_req / w, 4),
                "rays_per_s": round(total_rays / w, 1),
                "cold_loads": sum(h.cold_loads
                                  for h in self._scenes.values()),
                "repromotions": sum(h.repromotions
                                    for h in self._scenes.values()),
                "device_share": share,
                "scenes": scenes,
            }

    def publish_gauges(self, now: float | None = None) -> None:
        """Export the ledger as ``capacity_*`` gauges on /metrics."""
        v = self.view(now)
        mx = get_metrics()
        mx.gauge("capacity_hbm_bytes", float(v["hbm_bytes"]))
        mx.gauge("capacity_hbm_peak_bytes", float(v["hbm_peak_bytes"]))
        mx.gauge("capacity_staging_bytes", float(v["staging_bytes"]))
        mx.gauge("capacity_staging_peak_bytes",
                 float(v["staging_peak_bytes"]))
        for name, s in v["scenes"].items():
            mx.gauge("capacity_scene_requests_per_s",
                     s["requests_per_s"], scene=name)
            mx.gauge("capacity_scene_rays_per_s",
                     s["rays_per_s"], scene=name)
            mx.gauge("capacity_scene_cold_loads",
                     float(s["cold_loads"]), scene=name)
            mx.gauge("capacity_scene_repromotions",
                     float(s["repromotions"]), scene=name)
        for fam, share in v["device_share"].items():
            mx.gauge("capacity_device_share", share, family=fam)

    def snapshot(self, now: float | None = None) -> dict:
        """Commit a ``capacity_snapshot`` telemetry row (+ refresh the
        gauges): the planner's replayable input format."""
        v = self.view(now)
        self.publish_gauges(now)
        get_emitter().emit(
            "capacity_snapshot",
            replica=self.replica,
            scenes=v["scenes"],
            hbm_bytes=v["hbm_bytes"],
            hbm_peak_bytes=v["hbm_peak_bytes"],
            staging_bytes=v["staging_bytes"],
            staging_peak_bytes=v["staging_peak_bytes"],
            window_s=v["window_s"],
            device_share=v["device_share"],
            requests_per_s=v["requests_per_s"],
            rays_per_s=v["rays_per_s"],
            cold_loads=v["cold_loads"],
            repromotions=v["repromotions"],
        )
        self.n_snapshots += 1
        return v

    def stats(self) -> dict:
        with self._lock:
            return {"n_scenes": len(self._scenes),
                    "n_families": len(self._device),
                    "n_snapshots": self.n_snapshots,
                    "hbm_peak_bytes": self.hbm_peak_bytes,
                    "staging_peak_bytes": self.staging_peak_bytes}
