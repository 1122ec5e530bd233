"""Render-serving engine: one checkpoint, a few warm routes, any request.

Port of ``nerf_replication_tpu/serve/engine.py``. The engine loads the
checkpoint and the baked occupancy grid once and serves every request through
shape buckets: a request pads with zero rays (the march's inert padding
convention) into the smallest bucket that holds it. Per bucket a family of
routes exists — ``full`` / ``bf16`` / ``reduced_k`` / ``coarse``
(serve/policy.py's degradation ladder; ``half_res`` reuses ``coarse`` with
host-side ray striding) — and all of them are warmed before the first request.

Routes (``task_arg.march_fused``, with a grid):

* ``full`` — the whole march in the K5 CUDA kernel, one launch per bucket
  (the JAX engine maps the same body over ``march_chunk_size`` chunks; rays
  are independent, so one launch gives the same per-ray results).
* ``gather`` — the K4 CUDA traversal per chunk, then the plain
  :class:`~..models.nerf.network.Network` on the valid slots and per-ray
  compositing in PyTorch, as the JAX engine's stage (a).
* ``off`` — the staged march per chunk: the packed march
  (``renderer/packed_march.py``) when ``march_coarse_block > 0`` or
  ``march_clip_bbox``, else the per-ray march
  (``renderer/accelerated.py``).

Under ``network.nerf.fused_trunk`` the staged routes' MLP runs through the
fused kernels, as the port's eval routes do: K1 on the per-ray and
``gather`` routes, K3a on the packed route (the JAX engine keeps the plain
network there; the maps agree within K1's float32 gate).

A checkpoint trained with ``sampling.mode: proposal`` carries the proposal
branch (``has_proposal``) and adds the ``proposal`` family: on a grid, the
packed proposal march (``march_rays_proposal_packed``: the resampler admits
the stream, the grid culls it; the fine MLP through the masked kernel K3a
under ``network.nerf.fused_trunk``, the density branch plain) at half the
fine budget; without a grid, the chunked proposal render. Its degraded
grid-less families shrink ``n_proposal`` / ``n_fine`` instead of swapping
to the (untrained) coarse network. A coarse+fine checkpoint serves the
``proposal`` tier from the ``reduced_k`` family.

Without a grid (``accelerated_renderer: false``, or a grid file that is
missing or unusable) every family renders through the chunked volume
renderer (``renderer/volume.render_rays``) in ``chunk_size``-ray chunks,
on the plain Network.

CUDA graphs (``compile.aot``, the JAX engine's AOT registry): on the card
:meth:`RenderEngine.warm_up` captures one graph per (bucket, family) route
(``compile/registry.py``) and a request replays it: the padded rays are
copied into the entry's static input, and the static outputs are copied to
the host under the engine's lock before another dispatch may replay. The
``gather`` route stays eager: it compacts the valid slots with
``torch.nonzero``, a data-dependent shape.

Multi-scene serving (``fleet/``, JAX ``engine.py:566-762``): a
:class:`~..fleet.ResidencyManager` attached by :meth:`attach_fleet` (or
``engine_from_cfg`` through ``fleet_from_cfg``) keeps scenes on the card,
and ``scene=`` on ``render_flat`` / ``render_request`` / ``render_view``
renders one. JAX passes a scene's params, grid and bbox as ARGUMENTS of one
compiled executable; the port's captured routes read the engine's tensors,
so those tensors are **slots**: the network's parameters (which the bf16
clone shares), one K5 ``FusedWeights`` per family (not per bucket), the grid
and the bbox. A batch for scene S first copies S's tensors into the slots
on the card and repacks K5's buffers from them (``FusedWeights.refresh``),
under the engine's lock and only when the slots hold another scene; the
engine's own checkpoint is one more scene (``default_scene``), so a switch
back restores it. After warm-up no scene, switch or publish adds a
capture or a route build (``route_builds``, ``captures`` in :meth:`stats`).
Placement, a switch and the byte counts run through
``scale.mesh_dispatch`` with or without a mesh: without one the engine's
layout is a ``(1, 1)`` mesh over its device, one lane on the current
stream, every tensor whole, and ``param_shards`` is 1. A scene is placed
by a copy to the card from pinned host memory, on a side stream, with
events the copy into the slots waits on.

Mesh serving (``mesh=``, a ``scale.mesh_dispatch.ServeMesh`` led by the
engine's device; JAX ``engine.py:151-185``): the slots, routes, graphs and
a stream of their own make one **lane** a data index, on its device ``(d,
0)`` (``scale.mesh_dispatch.Lane``). A bucket's whole chunks split over the
lanes, every lane's replay or route is launched, then every lane's outputs
are copied back in chunk order: every family is bitwise equal to the
mesh-less engine. Under a model axis ``M > 1`` every scene (the engine's
own checkpoint included, once a fleet is attached) lives sharded at rest
by the rule table, about ``1/M`` of its bytes a device
(``scene_shard_nbytes``, what the fleet admits against; ``param_shards``
is ``M``), and a switch gathers the pieces into each lane's slots. The
lanes' full slots are the fixed working set the engine holds besides
(``stats()["mesh"]["slot_bytes"]`` a lane). ``route_builds`` and
``captures`` sum over the lanes.

Each request dispatch passes the ``serve.dispatch`` fault point and runs
under ``serve.dispatch`` (the host's part) and ``serve.device`` (the wait
at the copy back) spans (``obs/trace.py``). :meth:`RenderEngine.render_view`
runs under ``serve.view`` (the whole call), with ``serve.rays`` (pose to
rays) and ``serve.image`` (reply to image and cache put) inside it.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..fleet.errors import SceneCompatError, UnknownSceneError
from ..obs import get_emitter
from ..obs.trace import get_tracer
from ..renderer.gate import check_baked_bounds
from ..resil import fault_point
from .cache import PoseCache
from .policy import FAMILIES, TIER_IMPL


@dataclass(frozen=True)
class ServeOptions:
    """Engine/batcher configuration (cfg.serve)."""

    buckets: tuple[int, ...] = (4096, 16384)
    max_batch_rays: int = 16384
    max_delay_s: float = 0.005
    request_timeout_s: float = 30.0
    cache_entries: int = 64
    pose_decimals: int = 3
    warmup: bool = True
    shed_queue_depths: tuple[int, ...] = (4, 8, 16, 32)

    @classmethod
    def from_cfg(cls, cfg) -> "ServeOptions":
        s = cfg.get("serve", {})
        return cls(
            buckets=tuple(int(b) for b in s.get("buckets", (4096, 16384))),
            max_batch_rays=int(s.get("max_batch_rays", 16384)),
            max_delay_s=float(s.get("max_delay_ms", 5.0)) / 1e3,
            request_timeout_s=float(s.get("request_timeout_s", 30.0)),
            cache_entries=int(s.get("cache_entries", 64)),
            pose_decimals=int(s.get("pose_decimals", 3)),
            warmup=bool(s.get("warmup", True)),
            shed_queue_depths=tuple(
                int(d) for d in s.get("shed_queue_depths", (4, 8, 16, 32))
            ),
        )


def _normalize_buckets(buckets, chunk: int) -> tuple[int, ...]:
    """Ascending unique bucket sizes, each a multiple of the render chunk."""
    norm = {max(chunk, -(-int(b) // chunk) * chunk) for b in buckets}
    return tuple(sorted(norm))


class RenderEngine:
    """Checkpoint-resident render server core (the MicroBatcher's worker
    thread and direct ``render_*`` calls may share it: a lock orders the
    dispatches)."""

    def __init__(self, cfg, network, near, far, grid=None, bbox=None,
                 device="cuda", warmup_families: tuple[str, ...] | None = None,
                 mesh=None):
        from ..renderer.accelerated import MarchOptions
        from ..renderer.volume import RenderOptions, eval_packed_cap
        from ..scale.mesh_dispatch import make_serve_mesh
        from ..utils.platform import resolve_device

        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            lead = mesh.devices[0, 0]
            if lead.type != self.device.type or (
                    lead.type == "cuda"
                    and resolve_device(lead) != self.device):
                raise ValueError(f"the mesh's lead device {lead} is not the "
                                 f"engine's device {self.device}")
        # where scenes are placed and the lanes run: the mesh, else one
        # device (one lane, no split dimension)
        self.layout = (mesh if mesh is not None
                       else make_serve_mesh(1, 1, [self.device]))
        self.network = network.to(self.device).eval()
        self.has_proposal = _has_proposal_branch(self.network)
        # under fused_trunk the staged and proposal routes' MLP runs the
        # fused kernels (make_fused_apply reads the tile from this config)
        self._fused_cfg = (cfg if bool(cfg.network.nerf.get("fused_trunk",
                                                             False))
                           else None)
        self.near = float(near)
        self.far = float(far)
        self.options = ServeOptions.from_cfg(cfg)
        self.march_options = MarchOptions.eval_from_cfg(cfg)
        self.eval_options = RenderOptions.from_cfg(cfg, train=False)
        self.packed_cap = eval_packed_cap(cfg, self.march_options)
        self.use_grid = grid is not None
        self.grid = self.bbox = None
        if self.use_grid:
            self.grid = torch.as_tensor(np.asarray(grid, bool)).to(
                self.device).contiguous()
            self.bbox = torch.as_tensor(np.asarray(bbox, np.float32)).to(
                self.device)
        self.chunk = (self.march_options.chunk_size if self.use_grid
                      else self.eval_options.chunk_size)
        self.buckets = _normalize_buckets(self.options.buckets, self.chunk)
        if mesh is not None:
            from ..scale.mesh_dispatch import validate_mesh_buckets

            validate_mesh_buckets(self.buckets, self.chunk, mesh)
        self.cache = PoseCache(
            capacity=self.options.cache_entries,
            decimals=self.options.pose_decimals,
        )
        self.route_builds = 0
        # multi-scene residency: the attached manager, the default scene's
        # name and own tensors, and the scene the slots hold (None: the
        # engine's own)
        self.fleet = None
        self.default_scene = "default"
        self._own = None
        self._slot_scene = None
        self.slot_switches = 0
        self._slot_events: list = []
        self._slot_wall_ms: list = []
        self._lane_events: list = []
        # CUDA graphs of the routes (None: compile.aot off; disabled on the
        # CPU); a replay's outputs are static buffers, so one dispatch at a
        # time replays and copies them out
        from ..compile import registry_from_cfg

        self.aot = registry_from_cfg(cfg, self.device)
        self.lanes = self._make_lanes(cfg)
        self._fns = self.lanes[0].fns  # lane 0's routes
        self._lock = threading.Lock()
        self.warm_source = "compiled"
        self.warm_captures = 0  # the registry's captures at warm-up's end
        self.n_requests = 0
        self.n_rays_rendered = 0
        self.n_pad_rays = 0
        self.n_truncated = 0
        self.warmup_dispatches = 0
        self.warmup_wall_s = 0.0
        self.march_chunks = 0
        self.march_candidates = 0.0
        self.march_samples_out = 0.0
        self.march_coarse_occ_sum = 0.0
        self.march_overflow_sum = 0.0
        self.default_camera: dict | None = None
        if self.options.warmup:
            self.warm_up(warmup_families)

    def _make_lanes(self, cfg) -> list:
        """One lane a data index of the layout: lane 0 holds the engine's
        network, grid and bbox; lane ``d`` a copy on the mesh device ``(d,
        0)`` with its own registry. On a mesh on a card each lane has its
        own stream; without a mesh the one lane runs on the current
        stream."""
        import copy

        from ..compile import registry_from_cfg
        from ..scale.mesh_dispatch import Lane
        from ..utils.platform import resolve_device

        lanes = []
        for d in range(self.layout.shape["data"]):
            dev = resolve_device(self.layout.devices[d, 0])
            if d == 0:
                net, grid, bbox, aot = (self.network, self.grid, self.bbox,
                                        self.aot)
            else:
                net = copy.deepcopy(self.network).to(dev).eval()
                grid = None if self.grid is None else self.grid.to(
                    dev, copy=True)
                bbox = None if self.bbox is None else self.bbox.to(
                    dev, copy=True)
                aot = registry_from_cfg(cfg, dev)
            stream = (torch.cuda.Stream(device=dev) if dev.type == "cuda"
                      and self.mesh is not None else None)
            lanes.append(Lane(d, dev, net, grid, bbox, aot, stream))
        return lanes

    # -- route construction --------------------------------------------------

    def _families_for_params(self) -> tuple[str, ...]:
        return tuple(f for f in FAMILIES if f != "proposal" or self.has_proposal)

    def _family_march_options(self, family: str):
        base = self.march_options
        if family in ("full", "bf16"):
            return base
        return replace(base, max_samples=max(1, base.max_samples // 2))

    def _family_eval_options(self, family: str):
        base = self.eval_options
        s = base.sampling
        if s.mode == "proposal":
            # the coarse branch of a proposal checkpoint is untrained: the
            # degraded families stay on the proposal render and shed by
            # shrinking the histogram and fine budgets
            if family in ("full", "bf16"):
                return base
            if family == "proposal":
                s2 = replace(s, n_fine=max(1, s.n_fine // 2))
            elif family == "reduced_k":
                s2 = replace(s, n_proposal=max(2, s.n_proposal // 2),
                             n_fine=max(1, s.n_fine // 2))
            else:  # coarse: the deepest shed still renders fine
                s2 = replace(s, n_proposal=max(2, s.n_proposal // 2),
                             n_fine=max(1, s.n_fine // 4))
            return replace(base, sampling=s2)
        if family in ("full", "bf16"):
            return base
        if family == "reduced_k":
            return replace(base, n_importance=base.n_importance // 2)
        return replace(base, n_importance=0)  # coarse-only

    def _family_network(self, family: str, lane=None):
        network = (lane or self.lanes[0]).network
        if family != "bf16":
            return network
        return network.clone(compute_dtype=torch.bfloat16)

    def _build_fn(self, bucket: int, family: str, lane=None):
        """``fn(rays [bucket / D, 6] on the lane's device) -> dict of
        tensors`` for ``lane`` (default: lane 0); the grid routes add
        per-chunk traversal stats ([bucket // chunk / D] each)."""
        from ..ops.fused_march import (
            FusedWeights,
            compositing_tile,
            march_rays_fused_full,
        )
        from ..ops.fused_mlp import fused_spec_for
        from ..renderer.volume import (
            map_chunks,
            plain_proposal_branch,
            proposal_march_fn,
            render_rays,
            staged_march_fn,
        )

        lane = lane or self.lanes[0]
        network = self._family_network(family, lane)
        near, far, chunk = self.near, self.far, self.chunk
        model = "coarse" if family == "coarse" else "fine"

        if self.use_grid and family == "proposal":
            # the learned sampler admits the packed stream and the grid
            # culls it, whatever march_fused says
            if self._fused_cfg is not None:
                from ..ops.fused_mlp import make_fused_apply

                apply_p = plain_proposal_branch(
                    make_fused_apply(network, self._fused_cfg), network)
            else:
                def apply_p(pts, viewdirs, m):
                    return network(pts, viewdirs, model=m)
            march = proposal_march_fn(
                apply_p, near, far, lane.grid, lane.bbox,
                self._family_march_options(family),
                self._family_eval_options(family), self.packed_cap)
            return lambda rays: map_chunks(march, rays, chunk)

        if not self.use_grid:
            options = self._family_eval_options(family)

            def apply_m(pts, viewdirs, m):
                return network(pts, viewdirs, model=m)

            return lambda rays: map_chunks(
                lambda rc: render_rays(apply_m, rc, near, far, None, options),
                rays, chunk)

        options = self._family_march_options(family)
        grid, bbox = lane.grid, lane.bbox

        if options.march_fused == "full":
            weights = lane.fused.get(family)
            if weights is None:
                weights = FusedWeights(fused_spec_for(network),
                                       getattr(network, model))
                lane.fused[family] = weights
            k_tile = compositing_tile(options, chunk)
            xyz_enc, dir_enc = network.xyz_encoder, network.dir_encoder

            def fn(rays):
                return march_rays_fused_full(
                    weights, xyz_enc, dir_enc, rays, near, far, grid, bbox,
                    options, k_tile=k_tile, stats_chunk=chunk,
                )

            return fn

        if self._fused_cfg is not None:
            from ..ops.fused_mlp import make_fused_apply

            fused = make_fused_apply(network, self._fused_cfg)

            def apply_fn(pts, viewdirs, _model, valid=None):
                return fused(pts, viewdirs, model, valid=valid)

            apply_fn.supports_valid_mask = True
        else:
            def apply_fn(pts, viewdirs, _model):
                return network(pts, viewdirs, model=model)

        march = staged_march_fn(apply_fn, near, far, grid, bbox, options,
                                self.packed_cap)
        return lambda rays: map_chunks(march, rays, chunk)

    def _get_fn(self, bucket: int, family: str, lane=None):
        lane = lane or self.lanes[0]
        key = (bucket, family)
        fn = lane.fns.get(key)
        if fn is None:
            fn = self._build_fn(bucket, family, lane)
            lane.fns[key] = fn
            self.route_builds += 1
        return fn

    @property
    def model_parallel(self) -> bool:
        """Whether scenes are sharded over a model axis ``M > 1``."""
        from ..scale.mesh_dispatch import model_size

        return model_size(self.layout) > 1

    def _fn_name(self, bucket: int, family: str) -> str:
        """The registry's name of one route (the JAX engine's: a
        model-parallel mesh adds its shape)."""
        base = f"serve/{family}/b{bucket}"
        if self.model_parallel:
            d, m = self.layout.shape["data"], self.layout.shape["model"]
            return f"{base}/mesh{d}x{m}"
        return base

    def _capturable(self, family: str) -> bool:
        """Every route but ``gather`` (its ``nonzero`` compaction)."""
        return not (self.use_grid and family != "proposal"
                    and self.march_options.march_fused == "gather")

    # graftlint: hot
    def warm_up(self, families: tuple[str, ...] | None = None) -> int:
        """Build every (bucket, family) route and run it once on an
        all-zero bucket (zero rays are inert padding). Builds the kernels on
        first use and packs each family's weights; with a registry on the
        card, then captures every route but ``gather`` on every lane (JAX
        ``engine.py:462``). Returns the dispatches."""
        if families is None:
            families = self._families_for_params()
        t0 = time.perf_counter()
        for bucket in self.buckets:
            zeros = np.zeros((bucket, 6), np.float32)
            for family in families:
                self._render_bucket(zeros, bucket, family, warm=True)
                self.warmup_dispatches += 1
        if self.aot is not None and self.aot.enabled:
            # each lane captures its share of every bucket in its own
            # registry (a pool of its own: lanes replay side by side)
            for lane in self.lanes:
                names = {}
                for bucket in self.buckets:
                    for family in families:
                        if not self._capturable(family):
                            continue
                        names[(bucket, family)] = name = self._fn_name(
                            bucket, family)
                        static = torch.zeros((bucket // len(self.lanes), 6),
                                             dtype=torch.float32,
                                             device=lane.device)
                        lane.aot.register(
                            name, self._inference(bucket, family, lane),
                            (static,))
                lane.aot.compile_all()
                for key, name in names.items():
                    fn = lane.aot.take(name)
                    if fn is not None:  # a failed capture stays eager
                        lane.captured[key] = fn
            self.warm_source = self.aot.warm_source()
            self.warm_captures = self._captures()
        self.warmup_wall_s += time.perf_counter() - t0
        return self.warmup_dispatches

    def _captures(self) -> int:
        """Graphs captured on every lane."""
        return sum(lane.aot.captures for lane in self.lanes
                   if lane.aot is not None)

    def _inference(self, bucket: int, family: str, lane=None):
        fn = self._get_fn(bucket, family, lane)

        def route(rays):
            with torch.inference_mode():
                return fn(rays)

        return route

    # -- rendering -----------------------------------------------------------

    def _dispatch(self, rays_b: np.ndarray, bucket: int, family: str,
                  scene=None) -> list:
        """One route call a lane on its share of exactly ``bucket`` rays
        (already padded): the captured route's replay (its static outputs),
        else the route; the lanes' device outputs, launched, not waited
        for. ``scene`` (a pinned SceneData, None: the engine's own) is
        copied into the slots first when they hold another (caller holds
        the lock)."""
        from ..scale.mesh_dispatch import launch_lanes

        self._install_scene(scene)
        rays_h = torch.from_numpy(np.ascontiguousarray(rays_b))

        def call(lane, rays):
            captured = lane.captured.get((bucket, family))
            if captured is not None:
                return captured(rays)
            with torch.inference_mode():
                return self._get_fn(bucket, family, lane)(
                    rays.to(lane.device))

        events = []  # (start, end) of each lane that has a stream
        outs = launch_lanes(self.lanes, rays_h, call, events)
        if events:
            self._lane_events = (self._lane_events + [events])[-64:]
        return outs

    def _render_bucket(self, rays: np.ndarray, bucket: int, family: str,
                       warm: bool = False, scene=None) -> dict:
        n = rays.shape[0]
        rays_b = np.pad(rays, ((0, bucket - n), (0, 0)))
        trs = get_tracer()
        with self._lock:  # a replay's outputs live until the next replay
            # the dispatch span is the host's part (copy in, replay or
            # launch); the device's work lands in the device span, at the
            # copy back that waits for it
            # graftlint: ok(blocking-under-lock: the span times the locked dispatch; its row is written only with tracing on)
            with trs.span("serve.dispatch", stage="dispatch", family=family,
                          bucket=int(bucket)):
                if not warm:
                    # chaos hook: an injected dispatch failure drives the
                    # batcher's breaker without touching the routes
                    # graftlint: ok(blocking-under-lock: a chaos hook, inert unless a fault plan is armed)
                    fault_point("serve.dispatch")
                outs = self._dispatch(rays_b, bucket, family, scene)
            # graftlint: ok(blocking-under-lock: the span times the locked copy back; its row is written only with tracing on)
            with trs.span("serve.device", stage="device", bucket=int(bucket)):
                from ..scale.mesh_dispatch import lanes_to_host

                out = lanes_to_host(self.lanes, outs)
                # per-chunk traversal stats (the packed and fused routes)
                stats = {k: out.pop(k) for k in (
                    "march_candidates", "march_samples_out",
                    "march_coarse_occ", "overflow_frac") if k in out}
                out = {k: v[:n] for k, v in out.items()}
        trunc = out.pop("truncated", None)
        if not warm:
            if stats:
                self.march_chunks += stats["march_candidates"].size
                self.march_candidates += float(
                    stats["march_candidates"].sum())
                self.march_samples_out += float(
                    stats["march_samples_out"].sum())
                self.march_coarse_occ_sum += float(
                    stats["march_coarse_occ"].sum())
                self.march_overflow_sum += float(stats["overflow_frac"].sum())
            if trunc is not None:
                self.n_truncated += int(np.sum(trunc))
        return out

    def bucket_for(self, n_rays: int) -> int:
        """Smallest bucket holding ``n_rays`` (largest for oversize tails)."""
        for b in self.buckets:
            if n_rays <= b:
                return b
        return self.buckets[-1]

    def render_flat(self, rays, family: str = "full",
                    scene=None) -> tuple[dict, dict]:
        """Render a flat [N, 6] ray array through the bucketed routes;
        returns ``(outputs, info)`` with host numpy [N, ...] outputs.
        ``scene``: a pinned SceneData (:meth:`scene_lease`), rendered
        through the same routes; None: the engine's own checkpoint."""
        if family == "proposal" and not self.has_proposal:
            family = "reduced_k"
        # graftlint: ok(host-sync: the request's rays arrive on the host)
        rays = np.asarray(rays, np.float32)
        if rays.ndim != 2:
            raise ValueError(f"rays must be [N, C], got shape {rays.shape}")
        n = rays.shape[0]
        largest = self.buckets[-1]
        pieces, used = [], []
        i = 0
        while n - i > largest:
            pieces.append(self._render_bucket(rays[i:i + largest], largest,
                                              family, scene=scene))
            used.append(largest)
            i += largest
        bucket = self.bucket_for(n - i)
        pieces.append(self._render_bucket(rays[i:], bucket, family,
                                          scene=scene))
        used.append(bucket)
        out = pieces[0] if len(pieces) == 1 else {
            k: np.concatenate([p[k] for p in pieces], axis=0)
            for k in pieces[0]
        }
        bucket_rays = int(sum(used))
        self.n_rays_rendered += n
        self.n_pad_rays += bucket_rays - n
        info = {
            "n_rays": n,
            "bucket_rays": bucket_rays,
            "buckets": used,
            "occupancy": n / bucket_rays if bucket_rays else 0.0,
        }
        return out, info

    # graftlint: hot
    def render_request(self, rays, near, far, tier: str = "full",
                       emit: bool = True, scene=None) -> dict:
        """Render one request at ``tier``; bounds must match the baked ones.
        ``half_res`` renders every 2nd ray and repeats it back to [N, ...].
        ``scene`` names a registry scene (None: the engine's own), pinned
        for the render. With ``emit`` the request writes its
        ``serve_request`` row (JAX's fields); a caller that writes the
        row itself passes ``emit=False``, so a request counts once."""
        check_baked_bounds(self.near, self.far, near, far,
                           surface="serve engine")
        family, stride = TIER_IMPL[tier]
        # graftlint: ok(host-sync: the request's rays arrive on the host)
        rays = np.asarray(rays, np.float32)
        n = rays.shape[0]
        t0 = time.perf_counter()
        with self.scene_lease(scene) as data:
            out, info = self.render_flat(rays[::stride], family, data)
        if stride > 1:
            out = {k: np.repeat(v, stride, axis=0)[:n] for k, v in out.items()}
        latency = time.perf_counter() - t0
        self.n_requests += 1
        if emit:
            fields = ({} if self._is_default_scene(scene)
                      else {"scene": str(scene)})
            # graftlint: ok(emit-hot: per-request completion record, post-sync)
            get_emitter().emit(
                "serve_request", latency_s=latency, n_rays=n, tier=tier,
                status="ok", n_buckets=len(info["buckets"]),
                bucket_rays=info["bucket_rays"], **fields)
        out["tier"] = tier
        return out

    # graftlint: hot
    def render_view(self, c2w, H: int, W: int, focal: float,
                    tier: str = "full", via=None,
                    scene=None) -> tuple[np.ndarray, dict]:
        """Pose -> uint8 [H, W, 3] image through the pose LRU cache.
        ``via(rays, near, far) -> out dict`` overrides the render path (the
        HTTP entry passes the micro-batcher's submit, whose batch writes
        the request's ``serve_request`` row); a direct render and a cache
        hit write their own. ``scene`` selects the scene's own pose cache
        and render target."""
        from ..datasets.rays import get_rays_np

        trs = get_tracer()
        # the view's span: the root of its trace, or a child of the HTTP
        # handler's serve.request; the batcher's spans join it via submit
        with trs.span("serve.view", n_rays=int(H) * int(W)):
            if self._is_default_scene(scene):
                cache, scene = self.cache, None
            else:
                self.require_scene(scene)
                cache = self.fleet.pose_cache(scene)
            key = cache.key(c2w, H, W, focal)
            t0 = time.perf_counter()
            cached = cache.get(key)
            if cached is not None:
                image, served_tier = cached
                # a hit does no device work, but it is a served request:
                # the alert engine and the capacity ledger count it
                fields = {} if scene is None else {"scene": str(scene)}
                # graftlint: ok(emit-hot: cache-hit record, no device work at all)
                get_emitter().emit(
                    "serve_request", latency_s=time.perf_counter() - t0,
                    n_rays=H * W, tier=served_tier, status="ok",
                    cache_hit=True, **fields)
                return image, {"tier": served_tier, "cache_hit": True}
            with trs.span("serve.rays", stage="rays"):
                # graftlint: ok(host-sync: the pose arrives on the host)
                pose = np.asarray(c2w)
                rays_o, rays_d = get_rays_np(H, W, float(focal), pose)
                rays = np.concatenate([rays_o, rays_d], -1).reshape(-1, 6)
            if via is not None:
                out = via(rays, self.near, self.far)
            else:
                out = self.render_request(rays, self.near, self.far,
                                          tier=tier, emit=True, scene=scene)
            with trs.span("serve.image", stage="image"):
                served_tier = out.get("tier", tier)
                # the grid-less coarse tier renders coarse only
                rgb_key = "rgb_map_f" if "rgb_map_f" in out else "rgb_map_c"
                # graftlint: ok(host-sync: render_flat returned host arrays)
                rgb = np.clip(np.asarray(out[rgb_key]).reshape(H, W, 3),
                              0.0, 1.0)
                image = (rgb * 255).astype(np.uint8)
                cache.put(key, (image, served_tier))
        return image, {"tier": served_tier, "cache_hit": False}

    # -- multi-scene residency (fleet/) ---------------------------------------

    def place_scene_tree(self, tree):
        """A scene's host ``(params, grid, bbox)`` on the layout
        (``scale.mesh_dispatch.place_tree``): ``(device tree, ready
        events)``, one grid and bbox a data index, the params sharded by the
        rule table over a model axis. On a card the copies run on side
        streams from the (pinned) host tensors and record the events the
        slot copies wait on."""
        from ..scale.mesh_dispatch import place_tree

        return place_tree(self.layout, tree)

    def pin_scene_tree(self, data):
        """``data`` with its host tensors page-locked (a card's async
        copies and the staging tier read them)."""
        def pin(t):
            return None if t is None else t.pin_memory()

        return replace(data, params={k: pin(v) for k, v in
                                     data.params.items()},
                       grid=pin(data.grid), bbox=pin(data.bbox))

    def scene_shard_nbytes(self, tree) -> int:
        """Bytes the largest device holds once :meth:`place_scene_tree`
        placed ``tree``, the figure fleet admission checks."""
        from ..scale.mesh_dispatch import scene_nbytes

        return scene_nbytes(self.layout, tree)

    @property
    def param_shards(self) -> int:
        """How many ways scene params split across devices (1: replicated,
        or no serving mesh): the mesh's model size."""
        from ..scale.mesh_dispatch import model_size

        return model_size(self.layout)

    def attach_fleet(self, residency, default_scene: str = "default") -> None:
        """Install a :class:`~..fleet.ResidencyManager`: its compat check,
        placement and byte hooks. The engine's own tensors are kept as the
        default scene's, so a switch back restores them."""
        residency.validate = self._check_scene_compat
        residency.placer = self.place_scene_tree
        residency.shard_nbytes = self.scene_shard_nbytes
        residency.param_shards = self.param_shards
        if self.device.type == "cuda":
            residency.pin = self.pin_scene_tree
        # the engine's own weights copied to the host before the lock is
        # taken (the copy waits for the card); _own is set once
        host = None
        if self._own is None:
            host = ({k: v.detach().cpu() for k, v in
                     self.network.state_dict().items()},
                    None if self.grid is None else self.grid.cpu(),
                    None if self.bbox is None else self.bbox.cpu())
        with self._lock:
            if self._own is None:
                from ..fleet.residency import SceneData

                placed, ready = self.place_scene_tree(host)
                self._own = SceneData(
                    scene_id=str(default_scene), params=placed[0],
                    grid=placed[1], bbox=placed[2], near=self.near,
                    far=self.far, ready=ready)
                self._slot_scene = self._own  # the slots hold it already
        self.fleet = residency
        self.default_scene = str(default_scene)

    def _is_default_scene(self, scene_id) -> bool:
        return scene_id is None or scene_id == self.default_scene

    def resident_scenes(self) -> list[str]:
        """Scene ids served without a disk load now: the resident set plus
        the staging tier's."""
        if self.fleet is None:
            return []
        ids = list(self.fleet.resident_ids())
        staged = getattr(self.fleet, "staged_ids", None)
        if staged is not None:
            ids.extend(s for s in staged() if s not in ids)
        return ids

    def require_scene(self, scene_id) -> None:
        """Synchronous existence check (404 before a bad scene id occupies
        the queue)."""
        if self._is_default_scene(scene_id):
            return
        if self.fleet is None:
            raise UnknownSceneError(
                scene_id, f"scene {scene_id!r} requested but multi-scene "
                          "serving is not configured (fleet.manifest / "
                          "fleet.scan_dir)")
        self.fleet.registry.get(scene_id)

    def prefetch_scene(self, scene_id) -> bool:
        """Start a background load of ``scene_id`` (no-op when resident,
        loading, default or fleet-less)."""
        if self.fleet is None or self._is_default_scene(scene_id):
            return False
        return self.fleet.prefetch(scene_id)

    @contextmanager
    def scene_lease(self, scene_id):
        """Pin ``scene_id`` for a render block, yielding its SceneData (None:
        the engine's own checkpoint); the manager cannot evict it
        meanwhile."""
        if self._is_default_scene(scene_id):
            yield None
            return
        self.require_scene(scene_id)
        with self.fleet.lease(scene_id) as data:
            yield data

    def _check_scene_compat(self, data) -> None:
        """Reject scenes the warmed routes cannot serve as they are."""
        sid = data.scene_id
        if (data.grid is not None) != self.use_grid:
            raise SceneCompatError(
                sid, f"scene {sid!r}: grid presence ({data.grid is not None})"
                     f" does not match the engine's path (use_grid="
                     f"{self.use_grid})")
        if abs(data.near - self.near) > 1e-6 or abs(data.far - self.far) > 1e-6:
            raise SceneCompatError(
                sid, f"scene {sid!r}: bounds ({data.near}, {data.far}) differ "
                     f"from the baked ({self.near}, {self.far})")
        ours = self.network.state_dict()
        if set(data.params) != set(ours):
            raise SceneCompatError(
                sid, f"scene {sid!r}: state dict names differ from the "
                     "engine's network")
        for k, v in ours.items():
            t = data.params[k]
            if tuple(t.shape) != tuple(v.shape) or t.dtype != v.dtype:
                raise SceneCompatError(
                    sid, f"scene {sid!r}: {k} {tuple(t.shape)}/{t.dtype} vs "
                         f"engine {tuple(v.shape)}/{v.dtype}")
        if self.use_grid and (tuple(data.grid.shape) != tuple(self.grid.shape)
                              or data.grid.dtype != self.grid.dtype):
            raise SceneCompatError(
                sid, f"scene {sid!r}: grid {tuple(data.grid.shape)}/"
                     f"{data.grid.dtype} vs engine {tuple(self.grid.shape)}/"
                     f"{self.grid.dtype}")

    @torch.inference_mode()
    def _install_scene(self, scene) -> None:
        """Copy ``scene`` (None: the default scene) into the slots unless
        they hold it (caller holds the lock): lane ``d`` fills its
        parameters from data index ``d``'s pieces (``gather_into``: under a
        model axis, the all-gather), its grid and bbox, and repacks its K5
        weights, on its stream after the scene's placement events.
        Inference mode: the packed buffers were made by a warm-up inside
        it. The timing events span every lane's copies."""
        from ..scale.mesh_dispatch import gather_into

        if self._own is None:
            return  # no fleet: the slots hold the engine's own weights
        data = self._own if scene is None else scene
        if data is self._slot_scene:
            return
        t0 = time.perf_counter()
        cuda = self.device.type == "cuda"
        if cuda:
            # the timing starts once the placement is done; a lane on
            # another card waits for it on its own stream below
            main = torch.cuda.current_stream(self.device)
            for ev in data.ready or ():
                main.wait_event(ev)
            start = torch.cuda.Event(enable_timing=True)
            start.record(main)
        for lane in self.lanes:
            with lane.on_stream():
                stream = None
                if cuda:
                    # the allocator must not hand a source's memory out
                    # again before this stream's copy has read it
                    stream = torch.cuda.current_stream(lane.device)
                    for ev in data.ready or ():
                        stream.wait_event(ev)
                gather_into(lane.network.state_dict(), data.params,
                            lane.index, stream)
                if lane.grid is not None:
                    for dst, src in ((lane.grid, data.grid[lane.index]),
                                     (lane.bbox, data.bbox[lane.index])):
                        dst.copy_(src)
                        if stream is not None and src.device.type == "cuda":
                            src.record_stream(stream)
                for family, weights in lane.fused.items():
                    model = "coarse" if family == "coarse" else "fine"
                    weights.refresh(getattr(
                        self._family_network(family, lane), model))
        if cuda:
            for lane in self.lanes:
                if lane.stream is not None:
                    main.wait_stream(lane.stream)
            end = torch.cuda.Event(enable_timing=True)
            end.record(main)
            self._slot_events = (self._slot_events + [(start, end)])[-256:]
        self._slot_wall_ms = (self._slot_wall_ms + [
            (time.perf_counter() - t0) * 1e3])[-256:]
        self._slot_scene = data
        self.slot_switches += 1

    def lane_overlap_ms(self) -> dict | None:
        """The last mesh dispatch's lanes on the card: ``{lanes_ms,
        span_ms, overlap_ms}`` (``scale.mesh_dispatch.overlap_ms``); None
        without one."""
        if not self._lane_events:
            return None
        from ..scale.mesh_dispatch import overlap_ms

        return overlap_ms(self._lane_events[-1])

    def slot_copy_ms(self) -> list[float]:
        """Device ms of the recent slot switches (CUDA events; the host's
        enqueue ms on the CPU)."""
        if not self._slot_events:
            return list(self._slot_wall_ms)
        self._slot_events[-1][1].synchronize()
        return [s.elapsed_time(e) for s, e in self._slot_events]

    # -- introspection -------------------------------------------------------

    def total_compiles(self) -> int:
        """The port's counterpart of the JAX engine's compile count: the
        kernel libraries this process built with ``nvcc``
        (``ops.kernels.builds``) plus the CUDA-graph captures after
        warm-up. 0 for a process that warmed from the kernel-library
        store (``compile/artifacts.py``) and captured nothing since."""
        from ..ops import kernels

        return int(kernels.builds) + self._captures() - self.warm_captures

    def stats(self) -> dict:
        from ..ops.fused_march import LAUNCHES

        march = None
        if self.march_chunks:
            march = {
                "chunks": self.march_chunks,
                "candidates_per_chunk": self.march_candidates / self.march_chunks,
                "samples_out_per_chunk": self.march_samples_out / self.march_chunks,
                "sweep_efficiency": (
                    self.march_samples_out / max(self.march_candidates, 1.0)
                ),
                "coarse_occ_mean": self.march_coarse_occ_sum / self.march_chunks,
                "overflow_mean": self.march_overflow_sum / self.march_chunks,
            }
        return {
            "march": march,
            # fine-MLP evaluations a ray costs at each family's budget
            "sampling": {
                "mode": self.eval_options.sampling.mode,
                "has_proposal": self.has_proposal,
                "fine_evals_per_ray": {
                    f: self._family_eval_options(f).fine_evals_per_ray
                    for f in self._families_for_params()
                },
            },
            "route": self.march_options.march_fused,
            "device": str(self.device),
            "kernel_launches": dict(LAUNCHES),
            "buckets": list(self.buckets),
            "chunk": self.chunk,
            "use_grid": self.use_grid,
            "near": self.near,
            "far": self.far,
            "n_requests": self.n_requests,
            "n_rays_rendered": self.n_rays_rendered,
            "n_pad_rays": self.n_pad_rays,
            "n_truncated": self.n_truncated,
            "warmup_dispatches": self.warmup_dispatches,
            "warmup_wall_s": round(self.warmup_wall_s, 3),
            # where the kernels came from ("disk": this process ran no
            # nvcc), the graphs captured (constant after warm-up) and the
            # registry's summary (None: compile.aot off)
            "warm_source": self.warm_source,
            "captures": self._captures(),
            "total_compiles": self.total_compiles(),
            "compile": self._compile_summary(),
            "captured_routes": sorted(
                self._fn_name(b, f) for b, f in self.lanes[0].captured),
            "route_builds": self.route_builds,
            "cache": self.cache.stats(),
            # multi-scene residency (None: single-scene serving) and the
            # slot switches its batches took
            "fleet": None if self.fleet is None else self.fleet.stats(),
            "slots": {"switches": self.slot_switches,
                      "param_shards": self.param_shards},
            # mesh-sharded dispatch (None: no mesh); slot_bytes is one
            # lane's full slots, held once a data index besides the scenes
            "mesh": None if self.mesh is None else {
                "devices": int(self.mesh.size),
                "axes": dict(self.mesh.shape),
                "model_parallel": self.model_parallel,
                "param_shards": self.param_shards,
                "slot_bytes": self.lanes[0].slot_nbytes(),
            },
        }

    def _compile_summary(self) -> dict | None:
        """The registry's summary summed over the lanes (None: compile.aot
        off)."""
        if self.aot is None:
            return None
        if len(self.lanes) == 1:
            return self.aot.summary()
        out = {"entries": 0, "sources": {}, "wall_s": 0.0, "errors": []}
        for lane in self.lanes:
            s = lane.aot.summary()
            out["entries"] += s["entries"]
            out["wall_s"] = round(out["wall_s"] + s["wall_s"], 3)
            out["errors"] += [f"{e}@lane{lane.index}" for e in s["errors"]]
            for k, v in s["sources"].items():
                out["sources"][k] = out["sources"].get(k, 0) + v
        return out


def _has_proposal_branch(network) -> bool:
    """Whether a network carries the learned sampler's proposal branch."""
    return getattr(network, "proposal", None) is not None


def engine_from_cfg(cfg, cfg_file: str | None = None,
                    device="cuda") -> RenderEngine:
    """Boot a serving engine from an experiment's config.

    With ``task_arg.accelerated_renderer`` the grid comes from
    ``default_grid_path(cfg_file)`` (relative to the working directory, as
    in the JAX package); a missing or unusable grid file, or no
    ``accelerated_renderer``, serves through the chunked volume route, with
    the JAX engine's message. The weights come from the port's checkpoint
    in ``cfg.trained_model_dir`` (else the seeded init, as ``load_network``
    leaves it), the camera from the test split's ``transforms_test.json``.
    A ``scale:`` block that asks for a mesh serves on it
    (``scale.mesh_dispatch.mesh_from_scale_cfg`` over the visible cards
    from ``device`` on, or the one CPU device with ``device="cpu"``); an
    invalid one raises before anything loads, in the JAX package's
    words."""
    import os

    from ..datasets import make_camera
    from ..renderer.occupancy import default_grid_path, load_occupancy_pyramid
    from ..scale.mesh_dispatch import default_devices, mesh_from_scale_cfg
    from ..utils.setup import load_trained_network
    from ..utils.platform import resolve_device

    dev = resolve_device(device)
    mesh = mesh_from_scale_cfg(
        cfg, default_devices(dev) if dev.type == "cuda" else [dev])
    if mesh is not None:
        print(f"serving mesh: {dict(mesh.shape)} over {mesh.size} "
              "device(s)")
    grid = bbox = None
    if bool(cfg.task_arg.get("accelerated_renderer", False)):
        path = default_grid_path(cfg_file or "config")
        if os.path.exists(path):
            try:
                levels, bbox = load_occupancy_pyramid(path)
                grid = levels[0]
            except OSError as exc:
                print(f"occupancy grid unusable ({exc}); "
                      "serving through the chunked volume path")
        else:
            print(f"occupancy grid not found at {path}; "
                  "serving through the chunked volume path")
    test_ds = make_camera(cfg, "test")
    network, _ = load_trained_network(cfg, dev)
    engine = RenderEngine(cfg, network, near=test_ds.near, far=test_ds.far,
                          grid=grid, bbox=bbox, device=dev, mesh=mesh)
    engine.default_camera = {
        "H": int(test_ds.H), "W": int(test_ds.W), "focal": float(test_ds.focal),
    }
    # multi-scene residency: only when the fleet block names a manifest,
    # a scan_dir or a store_dir (JAX engine.py:1099)
    from ..fleet import fleet_from_cfg

    residency = fleet_from_cfg(cfg, engine)
    if residency is not None:
        print(f"fleet: {len(residency.registry)} scenes registered, "
              f"budget {residency.budget_bytes / (1 << 20):.0f} MB")
    return engine
