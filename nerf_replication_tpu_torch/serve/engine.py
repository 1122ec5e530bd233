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
renderer (``renderer/volume.render_rays``) in ``chunk_size``-ray chunks.
The staged and grid-less routes run the plain Network, as the JAX engine's
do (its fused MLP is the one-shot surfaces' option, not the engine's).

CUDA graphs (``compile.aot``, the JAX engine's AOT registry): on the card
:meth:`RenderEngine.warm_up` captures one graph per (bucket, family) route
(``compile/registry.py``) and a request replays it: the padded rays are
copied into the entry's static input, and the static outputs are copied to
the host under the engine's lock before another dispatch may replay. The
``gather`` route stays eager: it compacts the valid slots with
``torch.nonzero``, a data-dependent shape. Mesh, fleet and tracing are not
ported.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..renderer.gate import check_baked_bounds
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
        # the proposal family's fine MLP runs the masked kernel K3a under
        # fused_trunk (make_fused_apply reads the tile from this config)
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
        # CUDA graphs of the routes (None: compile.aot off; disabled on the
        # CPU); a replay's outputs are static buffers, so one dispatch at a
        # time replays and copies them out
        from ..compile import registry_from_cfg

        self.aot = registry_from_cfg(cfg, self.device)
        self._captured: dict[tuple[int, str], object] = {}
        self._lock = threading.Lock()
        self.warm_source = "compiled"
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
            spec = fused_spec_for(network)
            weights = FusedWeights(spec, getattr(network, model))
            k_tile = compositing_tile(options, chunk)
            xyz_enc, dir_enc = network.xyz_encoder, network.dir_encoder

            def fn(rays):
                return march_rays_fused_full(
                    weights, xyz_enc, dir_enc, rays, near, far, grid, bbox,
                    options, k_tile=k_tile, stats_chunk=chunk,
                )

            return fn

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
        self.warmup_wall_s += time.perf_counter() - t0
        return self.warmup_dispatches

    def _inference(self, bucket: int, family: str):
        fn = self._get_fn(bucket, family)

        def route(rays):
            with torch.inference_mode():
                return fn(rays)

        return route

    # -- rendering -----------------------------------------------------------

    def _dispatch(self, rays_b: np.ndarray, bucket: int, family: str) -> dict:
        """One route call on exactly ``bucket`` rays (already padded): the
        captured route's replay (its static outputs), else the route."""
        rays_h = torch.from_numpy(np.ascontiguousarray(rays_b))
        captured = self._captured.get((bucket, family))
        if captured is not None:
            return captured(rays_h)
        with torch.inference_mode():
            return self._get_fn(bucket, family)(rays_h.to(self.device))

    def _render_bucket(self, rays: np.ndarray, bucket: int, family: str,
                       warm: bool = False) -> dict:
        n = rays.shape[0]
        rays_b = np.pad(rays, ((0, bucket - n), (0, 0)))
        with self._lock:  # a replay's outputs live until the next replay
            out = dict(self._dispatch(rays_b, bucket, family))
            # per-chunk traversal stats (the packed and fused routes only)
            stats = {k: out.pop(k).cpu().numpy() for k in (
                "march_candidates", "march_samples_out", "march_coarse_occ",
                "overflow_frac") if k in out}
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

    def render_flat(self, rays, family: str = "full") -> tuple[dict, dict]:
        """Render a flat [N, 6] ray array through the bucketed routes;
        returns ``(outputs, info)`` with host numpy [N, ...] outputs."""
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
                                              family))
            used.append(largest)
            i += largest
        bucket = self.bucket_for(n - i)
        pieces.append(self._render_bucket(rays[i:], bucket, family))
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

    def render_request(self, rays, near, far, tier: str = "full") -> dict:
        """Render one request at ``tier``; bounds must match the baked ones.
        ``half_res`` renders every 2nd ray and repeats it back to [N, ...]."""
        check_baked_bounds(self.near, self.far, near, far,
                           surface="serve engine")
        family, stride = TIER_IMPL[tier]
        rays = np.asarray(rays, np.float32)
        n = rays.shape[0]
        out, _ = self.render_flat(rays[::stride], family)
        if stride > 1:
            out = {k: np.repeat(v, stride, axis=0)[:n] for k, v in out.items()}
        self.n_requests += 1
        out["tier"] = tier
        return out

    def render_view(self, c2w, H: int, W: int, focal: float,
                    tier: str = "full", via=None) -> tuple[np.ndarray, dict]:
        """Pose -> uint8 [H, W, 3] image through the pose LRU cache.
        ``via(rays, near, far) -> out dict`` overrides the render path (the
        HTTP entry passes the micro-batcher's submit)."""
        from ..datasets.rays import get_rays_np

        cache = self.cache
        key = cache.key(c2w, H, W, focal)
        cached = cache.get(key)
        if cached is not None:
            image, served_tier = cached
            return image, {"tier": served_tier, "cache_hit": True}
        rays_o, rays_d = get_rays_np(H, W, float(focal), np.asarray(c2w))
        rays = np.concatenate([rays_o, rays_d], -1).reshape(-1, 6)
        if via is not None:
            out = via(rays, self.near, self.far)
        else:
            out = self.render_request(rays, self.near, self.far, tier=tier)
        served_tier = out.get("tier", tier)
        # the grid-less coarse tier renders coarse only
        rgb_key = "rgb_map_f" if "rgb_map_f" in out else "rgb_map_c"
        rgb = np.clip(np.asarray(out[rgb_key]).reshape(H, W, 3), 0.0, 1.0)
        image = (rgb * 255).astype(np.uint8)
        cache.put(key, (image, served_tier))
        return image, {"tier": served_tier, "cache_hit": False}

    # -- introspection -------------------------------------------------------

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
            "compile": None if self.aot is None else self.aot.summary(),
            "captured_routes": sorted(
                self._fn_name(b, f) for b, f in self._captured),
            "cache": self.cache.stats(),
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
    leaves it), the camera from the test split's ``transforms_test.json``."""
    import os

    from ..datasets import make_camera
    from ..renderer.occupancy import default_grid_path, load_occupancy_pyramid
    from ..train.checkpoint import load_trained_network
    from ..utils.platform import resolve_device

    dev = resolve_device(device)
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
    return engine
