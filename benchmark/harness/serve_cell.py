"""Serving cells: an engine (built by the cell's model family) and its
micro-batcher over the seeded network and the scene's analytic grid,
viewers in an open loop, and the replies held against the family's
reference render of the same rays.

Each request is the HTTP handler's call without the socket:
``RenderEngine.render_view(c2w, H, W, focal, tier="full",
via=MicroBatcher.submit)``, from a pool of client threads, started at its
due time. Its latency runs from the due time to the moment its image is on
the host. A request that errs, times out, or is served below tier
``full`` or from the pose cache counts as failed.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np

from . import scene
from .traffic import viewer_schedule
from .window import device_sync


def serve_cfg(config: dict, seed: int):
    from nerf_replication_tpu_torch.config import make_cfg

    from .spec import ROOT

    prog = config["program"]
    return make_cfg(os.path.join(ROOT, prog["yaml"]),
                    [*prog["serve_opts"], "seed", str(int(seed))])


class ServeRun:
    def __init__(self, torch, device, cell, seed: int, t_start: float):
        self.torch, self.device, self.cell = torch, device, cell
        self.seed = int(seed)
        self.t_start = t_start
        self.spec = cell.config["model_spec"]
        self.serve = cell.config["serve"]
        self.family = cell.family
        self.traffic = cell.traffic

    def make_inputs(self) -> None:
        self.w0 = self.family.initial_weights(self.spec, self.seed,
                                              self.device)
        self.grid = scene.analytic_occupancy(self.serve["grid_res"],
                                             device=self.device)
        self.bbox = np.asarray(self.serve["bbox"], np.float32)

    def setup(self) -> None:
        from nerf_replication_tpu_torch.serve import MicroBatcher

        self.make_inputs()
        cfg = serve_cfg(self.cell.config, self.seed)
        self.family.check_serve_cfg(cfg, self.spec, self.serve)
        self.engine = self.family.build_engine(cfg, self.w0, self.grid,
                                               self.bbox, self.spec,
                                               self.device)
        self.batcher = MicroBatcher(self.engine)
        # the client path once at each end of the size range, off the orbit
        for side in (self.traffic["side_min"], self.traffic["side_max"]):
            self._render(side, 90.0, -89.0)
        device_sync(self.torch, self.device)
        self.setup_s = time.perf_counter() - self.t_start

    def _render(self, side: int, azimuth: float, elevation: float,
                keep: dict | None = None, index: int = -1):
        c2w = scene.pose_spherical(azimuth, elevation,
                                   self.traffic["radius"])
        timeout = float(self.traffic["timeout_s"])

        def via(rays, near, far):
            out = self.batcher.submit(rays, near, far).result(timeout)
            if keep is not None:
                keep[index] = {k: out[k] for k in
                               ("rgb_map_f", "depth_map_f", "acc_map_f",
                                "tier")}
            return out

        return self.engine.render_view(c2w, side, side,
                                       scene.focal_for(side), tier="full",
                                       via=via)

    def window(self, seconds: float, tracer=None, rate=None,
               keep_indices=()) -> dict:
        """Offer the schedule, wait for every reply (up to the timeout past
        the close), and return the latencies and failures."""
        sched = viewer_schedule(self.traffic, self.seed, seconds, rate)
        keep_set = set(keep_indices)
        kept: dict = {}
        lat = [None] * len(sched)
        fails: dict = {}
        lag = []
        lock = threading.Lock()
        elevation = float(self.traffic["elevation_deg"])

        replied = [None] * len(sched)

        def one(req, t0):
            try:
                _, info = self._render(
                    req.side, req.azimuth_deg, elevation,
                    kept if req.index in keep_set else None, req.index)
                done = time.perf_counter()
                bad = ("cache_hit" if info.get("cache_hit")
                       else None if info.get("tier") == "full"
                       else f"tier_{info.get('tier')}")
            except Exception as err:  # a failed request is counted, not fatal
                done = time.perf_counter()
                bad = type(err).__name__
            with lock:
                lat[req.index] = done - (t0 + req.due_s)
                replied[req.index] = done - t0
                if bad is not None:
                    fails[bad] = fails.get(bad, 0) + 1

        before = self._counters()
        pool = ThreadPoolExecutor(max_workers=int(self.traffic["clients"]))
        futures = []
        if tracer is not None:
            # the whole window is traced: starting or stopping the profiler
            # inside it would stall the schedule
            tracer.start()
        t0 = time.perf_counter()
        for req in sched:
            now = time.perf_counter()
            delay = t0 + req.due_s - now
            if delay > 0:
                time.sleep(delay)
            lag.append(max(0.0, time.perf_counter() - (t0 + req.due_s)))
            futures.append(pool.submit(one, req, t0))
        done, pending = wait(futures,
                             timeout=seconds + float(self.traffic["timeout_s"]))
        if tracer is not None:
            device_sync(self.torch, self.device)
            tracer.stop()
        pool.shutdown(wait=not pending, cancel_futures=True)
        after = self._counters()
        for f in done:
            f.result()
        n_lost = len(pending)
        if n_lost:
            fails["no_reply"] = fails.get("no_reply", 0) + n_lost
        ok = [v for v in lat if v is not None]
        return {
            "schedule": sched, "latencies_s": lat, "completed": ok,
            "failed": sum(fails.values()), "fail_kinds": fails,
            "kept": kept, "lag_max_s": max(lag) if lag else 0.0,
            "counters": {k: after[k] - before[k] for k in after},
            "replied_s": replied,
            "elapsed_s": time.perf_counter() - t0,
        }

    def _counters(self) -> dict:
        st = self.engine.stats()
        return {"n_rays_rendered": st["n_rays_rendered"],
                "n_pad_rays": st["n_pad_rays"],
                "compiles": st["total_compiles"],
                "cache_hits": st["cache"].get("hits", 0)}

    def close(self) -> None:
        self.batcher.close(drain=True)

    def free_program(self) -> None:
        self.close()
        for name in ("batcher", "engine"):
            if hasattr(self, name):
                delattr(self, name)
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    # -- the comparison -------------------------------------------------
    def rays_of(self, req):
        """The request's rays ``[H*W, 6]`` on the device, worked out from
        its pose and size."""
        c2w = scene.pose_spherical(req.azimuth_deg,
                                   float(self.traffic["elevation_deg"]),
                                   self.traffic["radius"])
        o, d = scene.camera_rays_host(req.side, req.side,
                                      scene.focal_for(req.side), c2w)
        return self.torch.from_numpy(np.concatenate([o, d], -1)).to(
            self.device)

    def reference_maps(self, req, precision: str = "float32") -> dict:
        """The family's plain render of the request's rays."""
        from reference.precision import exact_float32

        exact_float32()
        with self.torch.no_grad():
            return self.family.reference_maps(self.w0, self.rays_of(req),
                                              self.grid, self.spec,
                                              self.serve, precision)

    def count_samples(self, reqs) -> int:
        with self.torch.no_grad():
            return sum(self.family.count_samples(self.rays_of(r), self.grid,
                                                 self.spec, self.serve)
                       for r in reqs)
