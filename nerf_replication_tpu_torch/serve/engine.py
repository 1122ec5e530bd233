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
Without a mesh a scene is placed by a plain copy to the card (from pinned
host memory, on a side stream, with an event the copy into the slots
waits on) and ``param_shards`` is 1; mesh serving comes with ROADMAP
item 9c, and until then ``engine_from_cfg`` refuses a ``scale:`` block
that asks for a mesh (``scale.options.check_mesh_serving``).

Each request dispatch passes the ``serve.dispatch`` fault point and runs
under ``serve.dispatch`` (the host's part) and ``serve.device`` (the wait
at the copy back) spans (``obs/trace.py``).
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
                 device="cuda", warmup_families: tuple[str, ...] | None = None):
        from ..renderer.accelerated import MarchOptions
        from ..renderer.volume import RenderOptions, eval_packed_cap
        from ..utils.platform import resolve_device

        self.device = resolve_device(device)
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
        self.cache = PoseCache(
            capacity=self.options.cache_entries,
            decimals=self.options.pose_decimals,
        )
        self._fns: dict[tuple[int, str], object] = {}
        self.route_builds = 0
        # K5's packed weights, one per family (the slots a scene switch
        # repacks)
        self._fused: dict[str, object] = {}
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
        # CUDA graphs of the routes (None: compile.aot off; disabled on the
        # CPU); a replay's outputs are static buffers, so one dispatch at a
        # time replays and copies them out
        from ..compile import registry_from_cfg

        self.aot = registry_from_cfg(cfg, self.device)
        self._captured: dict[tuple[int, str], object] = {}
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

    def _family_network(self, family: str):
        if family != "bf16":
            return self.network
        return self.network.clone(compute_dtype=torch.bfloat16)

    def _build_fn(self, bucket: int, family: str):
        """``fn(rays [bucket, 6] on device) -> dict of tensors``; the grid
        routes add per-chunk traversal stats ([bucket // chunk] each)."""
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

        network = self._family_network(family)
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
                apply_p, near, far, self.grid, self.bbox,
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
        grid, bbox = self.grid, self.bbox

        if options.march_fused == "full":
            weights = self._fused.get(family)
            if weights is None:
                weights = FusedWeights(fused_spec_for(network),
                                       getattr(network, model))
                self._fused[family] = weights
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

    def _get_fn(self, bucket: int, family: str):
        key = (bucket, family)
        fn = self._fns.get(key)
        if fn is None:
            fn = self._build_fn(bucket, family)
            self._fns[key] = fn
            self.route_builds += 1
        return fn

    def _fn_name(self, bucket: int, family: str) -> str:
        """The registry's name of one route (the JAX engine's)."""
        return f"serve/{family}/b{bucket}"

    def _capturable(self, family: str) -> bool:
        """Every route but ``gather`` (its ``nonzero`` compaction)."""
        return not (self.use_grid and family != "proposal"
                    and self.march_options.march_fused == "gather")

    def warm_up(self, families: tuple[str, ...] | None = None) -> int:
        """Build every (bucket, family) route and run it once on an
        all-zero bucket (zero rays are inert padding). Builds the kernels on
        first use and packs each family's weights; with a registry on the
        card, then captures every route but ``gather`` (JAX
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
            names = {}
            for bucket in self.buckets:
                for family in families:
                    if not self._capturable(family):
                        continue
                    names[(bucket, family)] = name = self._fn_name(bucket,
                                                                   family)
                    static = torch.zeros((bucket, 6), dtype=torch.float32,
                                         device=self.device)
                    self.aot.register(name, self._inference(bucket, family),
                                      (static,))
            self.aot.compile_all()
            for key, name in names.items():
                fn = self.aot.take(name)
                if fn is not None:  # a failed capture stays eager
                    self._captured[key] = fn
            self.warm_source = self.aot.warm_source()
            self.warm_captures = self.aot.captures
        self.warmup_wall_s += time.perf_counter() - t0
        return self.warmup_dispatches

    def _inference(self, bucket: int, family: str):
        fn = self._get_fn(bucket, family)

        def route(rays):
            with torch.inference_mode():
                return fn(rays)

        return route

    # -- rendering -----------------------------------------------------------

    def _dispatch(self, rays_b: np.ndarray, bucket: int, family: str,
                  scene=None) -> dict:
        """One route call on exactly ``bucket`` rays (already padded): the
        captured route's replay (its static outputs), else the route.
        ``scene`` (a pinned SceneData, None: the engine's own) is copied
        into the slots first when they hold another (caller holds the
        lock)."""
        self._install_scene(scene)
        rays_h = torch.from_numpy(np.ascontiguousarray(rays_b))
        captured = self._captured.get((bucket, family))
        if captured is not None:
            return captured(rays_h)
        with torch.inference_mode():
            return self._get_fn(bucket, family)(rays_h.to(self.device))

    def _render_bucket(self, rays: np.ndarray, bucket: int, family: str,
                       warm: bool = False, scene=None) -> dict:
        n = rays.shape[0]
        rays_b = np.pad(rays, ((0, bucket - n), (0, 0)))
        trs = get_tracer()
        with self._lock:  # a replay's outputs live until the next replay
            # the dispatch span is the host's part (copy in, replay or
            # launch); the device's work lands in the device span, at the
            # copy back that waits for it
            with trs.span("serve.dispatch", stage="dispatch", family=family,
                          bucket=int(bucket)):
                if not warm:
                    # chaos hook: an injected dispatch failure drives the
                    # batcher's breaker without touching the routes
                    fault_point("serve.dispatch")
                out = dict(self._dispatch(rays_b, bucket, family, scene))
            with trs.span("serve.device", stage="device", bucket=int(bucket)):
                # per-chunk traversal stats (the packed and fused routes)
                stats = {k: out.pop(k).cpu().numpy() for k in (
                    "march_candidates", "march_samples_out",
                    "march_coarse_occ", "overflow_frac") if k in out}
                out = {k: v.cpu().numpy()[:n] for k, v in out.items()}
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
            get_emitter().emit(
                "serve_request", latency_s=latency, n_rays=n, tier=tier,
                status="ok", n_buckets=len(info["buckets"]),
                bucket_rays=info["bucket_rays"], **fields)
        out["tier"] = tier
        return out

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
            # a hit does no device work, but it is a served request: the
            # alert engine and the capacity ledger count it
            fields = {} if scene is None else {"scene": str(scene)}
            get_emitter().emit(
                "serve_request", latency_s=time.perf_counter() - t0,
                n_rays=H * W, tier=served_tier, status="ok",
                cache_hit=True, **fields)
            return image, {"tier": served_tier, "cache_hit": True}
        rays_o, rays_d = get_rays_np(H, W, float(focal), np.asarray(c2w))
        rays = np.concatenate([rays_o, rays_d], -1).reshape(-1, 6)
        if via is not None:
            out = via(rays, self.near, self.far)
        else:
            out = self.render_request(rays, self.near, self.far, tier=tier,
                                      emit=True, scene=scene)
        served_tier = out.get("tier", tier)
        # the grid-less coarse tier renders coarse only
        rgb_key = "rgb_map_f" if "rgb_map_f" in out else "rgb_map_c"
        rgb = np.clip(np.asarray(out[rgb_key]).reshape(H, W, 3), 0.0, 1.0)
        image = (rgb * 255).astype(np.uint8)
        cache.put(key, (image, served_tier))
        return image, {"tier": served_tier, "cache_hit": False}

    # -- multi-scene residency (fleet/) ---------------------------------------

    def place_scene_tree(self, tree):
        """A scene's host ``(params, grid, bbox)`` on the engine's device:
        ``(device tree, ready event)``. On a card the copy runs on a side
        stream from the (pinned) host tensors and records the event the
        slot copy waits on; on the CPU the host tensors are the scene."""
        params, grid, bbox = tree
        if self.device.type != "cuda":
            return (params, grid, bbox), None
        stream = torch.cuda.Stream(device=self.device)
        with torch.cuda.stream(stream):
            def put(t):
                return None if t is None else t.to(self.device,
                                                   non_blocking=True)

            out = ({k: put(v) for k, v in params.items()}, put(grid),
                   put(bbox))
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, ready

    def pin_scene_tree(self, data):
        """``data`` with its host tensors page-locked (a card's async
        copies and the staging tier read them)."""
        def pin(t):
            return None if t is None else t.pin_memory()

        return replace(data, params={k: pin(v) for k, v in
                                     data.params.items()},
                       grid=pin(data.grid), bbox=pin(data.bbox))

    def scene_shard_nbytes(self, tree) -> int:
        """Bytes one device holds once :meth:`place_scene_tree` placed
        ``tree`` (no mesh: every tensor whole)."""
        params, grid, bbox = tree
        return sum(int(t.numel()) * int(t.element_size())
                   for t in (*params.values(), grid, bbox) if t is not None)

    @property
    def param_shards(self) -> int:
        """How many ways scene params split across devices (1: no serving
        mesh)."""
        return 1

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
        with self._lock:
            if self._own is None:
                from ..fleet.residency import SceneData

                self._own = SceneData(
                    scene_id=str(default_scene),
                    params={k: v.detach().clone() for k, v in
                            self.network.state_dict().items()},
                    grid=None if self.grid is None else self.grid.clone(),
                    bbox=None if self.bbox is None else self.bbox.clone(),
                    near=self.near, far=self.far)
                self._slot_scene = self._own
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
        they hold it: parameters, K5's packed weights, grid, bbox — on the
        serving stream, after the scene's placement event (caller holds
        the lock). Inference mode: the packed buffers were made by a warm-up
        inside it."""
        if self._own is None:
            return  # no fleet: the slots hold the engine's own weights
        data = self._own if scene is None else scene
        if data is self._slot_scene:
            return
        t0 = time.perf_counter()
        cuda = self.device.type == "cuda"
        if cuda:
            stream = torch.cuda.current_stream(self.device)
            if data.ready is not None:
                stream.wait_event(data.ready)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        pairs = [(v, data.params[k]) for k, v in
                 self.network.state_dict().items()]
        if self.use_grid:
            pairs += [(self.grid, data.grid), (self.bbox, data.bbox)]
        for dst, src in pairs:
            dst.copy_(src)
            if cuda and src.device.type == "cuda":
                # the allocator must not hand this memory out again before
                # the serving stream's copy has read it
                src.record_stream(stream)
        for family, weights in self._fused.items():
            model = "coarse" if family == "coarse" else "fine"
            weights.refresh(getattr(self._family_network(family), model))
        if cuda:
            end.record(stream)
            self._slot_events = (self._slot_events + [(start, end)])[-256:]
        self._slot_wall_ms = (self._slot_wall_ms + [
            (time.perf_counter() - t0) * 1e3])[-256:]
        self._slot_scene = data
        self.slot_switches += 1

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

        captures = 0 if self.aot is None else self.aot.captures
        return int(kernels.builds) + captures - self.warm_captures

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
            "captures": 0 if self.aot is None else self.aot.captures,
            "total_compiles": self.total_compiles(),
            "compile": None if self.aot is None else self.aot.summary(),
            "captured_routes": sorted(
                self._fn_name(b, f) for b, f in self._captured),
            "route_builds": self.route_builds,
            "cache": self.cache.stats(),
            # multi-scene residency (None: single-scene serving) and the
            # slot switches its batches took
            "fleet": None if self.fleet is None else self.fleet.stats(),
            "slots": {"switches": self.slot_switches,
                      "param_shards": self.param_shards},
        }


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
    A ``scale:`` block that asks for a mesh, or an invalid one, raises
    before anything loads (``scale.options.check_mesh_serving``, devices
    counted as ``torch.cuda.device_count()`` on the card, 1 on the CPU)."""
    import os

    from ..datasets import make_camera
    from ..renderer.occupancy import default_grid_path, load_occupancy_pyramid
    from ..scale.options import ScaleOptions, check_mesh_serving
    from ..utils.setup import load_trained_network
    from ..utils.platform import resolve_device

    dev = resolve_device(device)
    check_mesh_serving(ScaleOptions.from_cfg(cfg),
                       torch.cuda.device_count() if dev.type == "cuda" else 1)
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
                          grid=grid, bbox=bbox, device=dev)
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
