"""Volume renderer: stratified + hierarchical sampling and compositing.

Port of ``nerf_replication_tpu/renderer/volume.py`` (the coarse+fine path):
``stratified_z_vals`` with per-bin jitter, ``raw2outputs`` (distances scaled
by ‖rays_d‖ with the 1e10 tail interval, sigmoid rgb, relu sigma, transmittance
by a cumulative product with the 1e-10 guard, white background),
``sample_pdf`` (inverse CDF with the broadcast-compare bisection and the 1e-5
guards; ``det`` draws a linspace), and ``render_rays``, which detaches the
importance samples as the JAX package stops their gradient.

Randomness comes from one ``torch.Generator`` per call (``gen``), drawn in a
fixed order — stratified jitter, then sigma noise, then the importance
draws — where the JAX package splits a key four ways; the deterministic
paths (``perturb 0``, ``raw_noise_std 0``) use none.

:class:`Renderer` binds the network and options: ``_apply_fn`` routes the MLP
through the fused kernels K1/K2 when ``network.nerf.fused_trunk`` is on
(``ops/fused_mlp.make_fused_apply``) and through the plain ``Network``
otherwise; ``render`` renders a training batch and ``render_chunked`` a whole
image in ``chunk_size``-ray chunks. ``task_arg.remat`` is accepted and has
no effect: the fused MLP's backward already recomputes its activations, and
the plain path keeps autograd's. ``sampling.mode: proposal`` routes
``render_rays`` to the proposal resampler (``renderer/sampling.py``); its
density branch always runs the plain ``Network`` (it is not the NeRF trunk
that K1/K2/K3a compute), its fine pass the fused kernels under
``fused_trunk``.

The occupancy-accelerated eval (``render_accelerated``, after
``load_occupancy_grid``) renders a whole image in ``march_chunk_size``-ray
chunks through the route ``_build_march_fn`` picks, as the JAX renderer
does: ``march_fused full`` (K5) or ``gather`` (K4); else, for a proposal
checkpoint, the packed proposal march (the resampler as the stream's
admission, its fine MLP through K3a under ``fused_trunk``); else the packed
march when ``march_coarse_block > 0`` or ``march_clip_bbox`` (its MLP
through K3a under ``fused_trunk``); else the per-ray march (through K1 under
``fused_trunk``). Without a grid it is the chunked render, with the JAX
package's message. The built route is cached per (bounds, options), as the
JAX renderer caches its jitted function. The ``full`` route packs the fine
branch's weights for K5 when it is built, as the serving engine packs them
at load: a Renderer assumes that its network's weights stay as they were
(eval, serving); a caller that loads other weights builds a new Renderer.

CUDA graphs (the JAX renderer's ``aot_register_eval`` / ``aot_install``):
a caller registers the whole-image eval renders of one ray count and bounds
with a ``compile.AOTRegistry``, captures them and installs them; a render
whose chunks and bounds match an installed entry then copies its padded
rays into the entry and replays it, any other runs eagerly. A graph closes
over the bounds, the grid and the bbox, so loading another grid drops the
installed marches. A replay returns the graph's static tensors: the caller
reads them before the next replay of its registry. The ``gather`` route is
not captured (its ``nonzero`` compaction has a data-dependent shape).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..utils.numerics import cumprod, norm3_rn
from ..utils.platform import device_scalar
from .sampling import SamplingOptions, proposal_render_rays

# the per-chunk traversal stats of the marches ([n_chunks] after map_chunks;
# every other output is per ray)
MARCH_STATS = ("march_candidates", "march_samples_out", "march_coarse_occ",
               "overflow_frac")


@dataclass(frozen=True)
class RenderOptions:
    """Rendering configuration (the JAX package's fields)."""

    n_samples: int = 64
    n_importance: int = 128
    perturb: float = 1.0
    raw_noise_std: float = 0.0
    white_bkgd: bool = True
    lindisp: bool = False
    use_viewdirs: bool = True
    chunk_size: int = 8192
    remat: bool = False  # accepted; no effect in the port (see above)
    # cfg.sampling: mode "proposal" replaces the coarse pass
    sampling: SamplingOptions = field(default_factory=SamplingOptions)

    @classmethod
    def from_cfg(cls, cfg, train: bool = True) -> "RenderOptions":
        ta = cfg.task_arg
        perturb = float(ta.get("perturb", 1.0))
        if not train:
            # eval is deterministic unless test_perturb says otherwise
            perturb = float(ta.get("test_perturb", 0.0))
        return cls(
            n_samples=int(ta.N_samples),
            n_importance=int(ta.get("N_importance", 0)),
            perturb=perturb,
            raw_noise_std=float(ta.get("raw_noise_std", 0.0)),
            white_bkgd=bool(ta.get("white_bkgd", True)),
            lindisp=bool(ta.get("lindisp", False)),
            use_viewdirs=bool(ta.get("use_viewdirs", True)),
            chunk_size=int(ta.get("chunk_size", 8192)),
            remat=bool(ta.get("remat", False)) and train,
            sampling=SamplingOptions.from_cfg(cfg, train=train),
        )

    @property
    def fine_evals_per_ray(self) -> int:
        """Fine-MLP evaluations a ray costs: the merged S_c + S_f set in
        coarse+fine mode, the S_f resampled points in proposal mode, 0 when
        coarse-only."""
        if self.sampling.mode == "proposal":
            return self.sampling.n_fine
        if self.n_importance > 0:
            return self.n_samples + self.n_importance
        return 0


def stratified_z_vals(gen: torch.Generator | None, near, far, n_rays: int,
                      n_samples: int, perturb: float, lindisp: bool = False,
                      device="cpu") -> torch.Tensor:
    """[n_rays, n_samples] depths: linspace in depth (or disparity) with
    per-bin uniform jitter when perturb > 0 and a generator is given."""
    f32 = torch.float32
    t = torch.linspace(0.0, 1.0, n_samples, dtype=f32, device=device)
    near = device_scalar(near, f32, device)
    far = device_scalar(far, f32, device)
    if lindisp:
        z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    else:
        z = near * (1.0 - t) + far * t
    z_vals = z.expand(n_rays, n_samples)
    if perturb > 0.0 and gen is not None:
        # perturb is a gate, not a scale: any positive value jitters across
        # the full bin
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], -1)
        lower = torch.cat([z_vals[..., :1], mids], -1)
        t_rand = torch.rand(z_vals.shape, generator=gen, dtype=f32,
                            device=device)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


def raw2outputs(raw: torch.Tensor, z_vals: torch.Tensor,
                rays_d: torch.Tensor, gen: torch.Generator | None = None,
                raw_noise_std: float = 0.0, white_bkgd: bool = False):
    """Alpha compositing: raw [..., S, 4], z_vals [..., S], rays_d [..., 3]
    → (rgb_map [..., 3], depth_map [...], acc_map [...], weights [..., S])."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    dists = dists * norm3_rn(rays_d)[..., None]

    rgb = torch.sigmoid(raw[..., :3])
    sigma_raw = raw[..., 3]
    if raw_noise_std > 0.0 and gen is not None:
        sigma_raw = sigma_raw + torch.randn(
            sigma_raw.shape, generator=gen, dtype=torch.float32,
            device=sigma_raw.device) * raw_noise_std
    sigma = torch.relu(sigma_raw)

    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1),
    )[..., :-1]
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, -2)
    depth_map = torch.sum(weights * z_vals, -1)
    acc_map = torch.sum(weights, -1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, depth_map, acc_map, weights


def sample_pdf(gen: torch.Generator | None, bins: torch.Tensor,
               weights: torch.Tensor, n_samples: int,
               det: bool = False) -> torch.Tensor:
    """Inverse-CDF importance sampling: bins [..., B], weights [..., B-1]
    → samples [..., n_samples]."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)

    shape = cdf.shape[:-1] + (n_samples,)
    if det or gen is None:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32,
                           device=cdf.device).expand(shape)
    else:
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=cdf.device)

    # right bisection by a broadcast compare: count the cdf entries <= u
    inds = torch.sum((cdf[..., None, :] <= u[..., :, None]).to(torch.int64),
                     -1)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, cdf.shape[-1] - 1)

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    nb = bins.shape[-1] - 1
    bins_below = torch.gather(bins, -1, torch.clamp_max(below, nb))
    bins_above = torch.gather(bins, -1, torch.clamp_max(above, nb))

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def render_rays(apply_fn, rays: torch.Tensor, near, far,
                gen: torch.Generator | None,
                options: RenderOptions, step=None) -> dict:
    """Render a [N, 6] (or [N, 7] time-conditioned) ray batch through the
    coarse (+ fine) network. ``apply_fn(pts, viewdirs, model)`` returns raw
    ``[..., S, 4]``. Keys: ``rgb_map_c/f``, ``depth_map_c/f``,
    ``acc_map_c/f``. ``sampling.mode: proposal`` routes the proposal
    resampler instead, whose anneal ``step`` drives (None: fully sharp)."""
    if options.sampling.mode == "proposal":
        return proposal_render_rays(apply_fn, rays, near, far, gen, options,
                                    step=step)
    rays_o, rays_d = rays[..., 0:3], rays[..., 3:6]
    t_col = rays[..., 6:7] if rays.shape[-1] > 6 else None
    n_rays = rays.shape[0]

    def _with_t(pts):
        if t_col is None:
            return pts
        t = t_col[..., None, :].expand(*pts.shape[:-1], 1)
        return torch.cat([pts, t], -1)

    z_vals = stratified_z_vals(gen, near, far, n_rays, options.n_samples,
                               options.perturb, options.lindisp, rays.device)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    viewdirs = rays_d / norm3_rn(rays_d, keepdim=True)

    raw_c = apply_fn(_with_t(pts), viewdirs, "coarse")
    rgb_c, depth_c, acc_c, weights_c = raw2outputs(
        raw_c, z_vals, rays_d, gen, options.raw_noise_std, options.white_bkgd)
    out = {"rgb_map_c": rgb_c, "depth_map_c": depth_c, "acc_map_c": acc_c}

    if options.n_importance > 0:
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = sample_pdf(gen, z_mid, weights_c[..., 1:-1],
                               options.n_importance,
                               det=(options.perturb == 0.0))
        z_samples = z_samples.detach()  # no gradient through the positions
        z_vals_f, _ = torch.sort(torch.cat([z_vals, z_samples], -1), -1)
        pts_f = (rays_o[..., None, :]
                 + rays_d[..., None, :] * z_vals_f[..., :, None])
        raw_f = apply_fn(_with_t(pts_f), viewdirs, "fine")
        rgb_f, depth_f, acc_f, _ = raw2outputs(
            raw_f, z_vals_f, rays_d, gen, options.raw_noise_std,
            options.white_bkgd)
        out.update({"rgb_map_f": rgb_f, "depth_map_f": depth_f,
                    "acc_map_f": acc_f})
    return out


class Renderer:
    """Config-bound renderer over one ``Network`` (its parameters are the
    module's own, so the methods take no params argument)."""

    def __init__(self, cfg, network):
        self.network = network
        self.train_options = RenderOptions.from_cfg(cfg, train=True)
        self.eval_options = RenderOptions.from_cfg(cfg, train=False)
        self._fused_apply = None
        if bool(cfg.network.nerf.get("fused_trunk", False)):
            from ..ops.fused_mlp import make_fused_apply

            self._fused_apply = make_fused_apply(network, cfg)
        # occupancy-accelerated eval state (the eval march budget)
        from .accelerated import MarchOptions

        self.march_options = MarchOptions.eval_from_cfg(cfg)
        self.packed_cap = eval_packed_cap(cfg, self.march_options)
        self.occupancy_grid = None
        self.grid_bbox = None
        # rays that exhausted the march budget while still transparent,
        # summed on the device; report_truncation reads it once
        self._n_truncated = None
        # the last marched render's traversal stats ([n_chunks] tensors on
        # the device) with a monotone sweep stamp; a chunked render clears
        # them
        self.last_march_stats: dict = {}
        self._march_sweep = 0
        # built march routes per (near, far, march options), and the
        # installed CUDA graphs keyed as the JAX renderer keys its
        # executables, plus the bounds a graph closes over
        self._march_routes: dict = {}
        self._chunked_fns: dict = {}  # (n_chunks, chunk, near, far)
        self._march_fns: dict = {}  # (n_chunks, chunk, near, far, options)
        self._aot_names: dict = {}

    def _apply_fn(self):
        if self._fused_apply is not None:
            return plain_proposal_branch(self._fused_apply, self.network)
        network = self.network
        return lambda pts, viewdirs, model: network(pts, viewdirs, model=model)

    def render(self, batch: dict, gen: torch.Generator | None = None,
               train: bool = True) -> dict:
        """Render a batch ``{rays [N, 6], near, far}``; an optional
        ``batch["step"]`` (the train step) drives the proposal anneal."""
        options = self.train_options if train else self.eval_options
        return render_rays(self._apply_fn(), batch["rays"], batch["near"],
                           batch["far"], gen, options,
                           step=batch.get("step"))

    def sampling_stats(self) -> dict:
        """The sampling mode and the fine-MLP evaluations a ray costs in
        training and in eval."""
        s = self.eval_options.sampling
        return {
            "mode": s.mode,
            "fine_evals_per_ray_train": self.train_options.fine_evals_per_ray,
            "fine_evals_per_ray_eval": self.eval_options.fine_evals_per_ray,
            "n_proposal": s.n_proposal if s.mode == "proposal" else 0,
            "n_fine": s.n_fine if s.mode == "proposal" else 0,
        }

    def render_chunked(self, batch: dict) -> dict:
        """Whole-image eval in chunks of ``chunk_size`` rays (the last chunk
        zero-padded to the same shape, as the JAX package's ``lax.map``
        does), outputs concatenated and cut back to the N rays. Drawn
        without a generator, as the JAX package's validation renders with
        no key: eval is deterministic. Replays an installed entry of the
        batch's chunks and bounds."""
        self.last_march_stats = {}
        rays = batch["rays"]
        if self._chunked_fns:
            chunk, n_chunks = chunk_layout(rays.shape[0],
                                           self.eval_options.chunk_size)
            fn = self._chunked_fns.get((n_chunks, chunk, float(batch["near"]),
                                        float(batch["far"])))
            if fn is not None:
                return replay_padded(fn, rays, n_chunks * chunk)
        return map_chunks(self._chunked_route(batch["near"], batch["far"]),
                          rays, self.eval_options.chunk_size)

    def _chunked_route(self, near, far):
        """``fn(rays_chunk) -> out``: one chunk of the chunked render."""
        apply_fn = self._apply_fn()
        options = self.eval_options
        return lambda rc: render_rays(apply_fn, rc, near, far, None, options)

    # -- occupancy-accelerated path (ESS + ERT) ------------------------------

    def _device(self) -> torch.device:
        return next(self.network.parameters()).device

    def load_occupancy_grid(self, grid_path: str) -> bool:
        """Load a baked grid onto the network's device; a missing or
        unusable file prints the JAX package's message and returns False
        (``render_accelerated`` then renders chunked, the reference's slow
        mode). Only the fine level is held: the coarse level is derived
        from it where a route needs it."""
        import os

        import numpy as np

        from .occupancy import load_occupancy_pyramid

        if not os.path.exists(grid_path):
            print(f"Occupancy grid file not found: {grid_path}, run in slow "
                  "mode.")
            return False
        try:
            levels, bbox = load_occupancy_pyramid(grid_path)
        except OSError as exc:
            print(f"Occupancy grid unusable ({exc}), run in slow mode.")
            return False
        dev = self._device()
        self.occupancy_grid = torch.from_numpy(
            np.ascontiguousarray(levels[0])).to(dev)
        self.grid_bbox = torch.from_numpy(np.asarray(bbox, np.float32)).to(dev)
        # routes and graphs close over the grid they were built on
        self._march_routes.clear()
        self._march_fns.clear()
        self._aot_names = {k: v for k, v in self._aot_names.items()
                           if v[0] != "march"}
        return True

    def _march_route(self, near: float, far: float):
        """:meth:`_build_march_fn` cached per (near, far, march options)."""
        key = (near, far, self.march_options)
        if key not in self._march_routes:
            self._march_routes[key] = self._build_march_fn(near, far)
        return self._march_routes[key]

    def _build_march_fn(self, near: float, far: float):
        """``fn(rays_chunk [chunk, 6]) -> out`` for one route, chosen as the
        JAX renderer (and the serving engine) choose it: ``march_fused``
        wins; then a proposal checkpoint's packed proposal march; otherwise
        ``coarse_block > 0`` or ``clip_bbox`` take the packed march; the
        per-ray march runs last."""
        options = self.march_options
        grid, bbox = self.occupancy_grid, self.grid_bbox

        if options.march_fused == "full":
            from ..ops.fused_march import FusedWeights, march_rays_fused_full
            from ..ops.fused_mlp import fused_spec_for

            network = self.network
            weights = FusedWeights(fused_spec_for(network), network.fine)
            return lambda rc: march_rays_fused_full(
                weights, network.xyz_encoder, network.dir_encoder, rc, near,
                far, grid, bbox, options)

        return staged_march_fn(self._apply_fn(), near, far, grid, bbox,
                               options, self.packed_cap,
                               eval_options=self.eval_options)

    def render_accelerated(self, batch: dict) -> dict:
        """Whole-image ESS + ERT render in ``march_chunk_size``-ray chunks
        (the last one zero-padded); the chunked render when no grid is
        loaded. The per-chunk traversal stats move to
        ``last_march_stats`` and the truncation flags into the device
        counter that :meth:`report_truncation` reads. Replays an installed
        entry of the batch's chunks, bounds and march options."""
        if self.occupancy_grid is None:
            return self.render_chunked(batch)
        near, far = float(batch["near"]), float(batch["far"])
        rays = batch["rays"]
        chunk, n_chunks = chunk_layout(rays.shape[0],
                                       self.march_options.chunk_size)
        fn = self._march_fns.get((n_chunks, chunk, near, far,
                                  self.march_options))
        if fn is not None:
            out = replay_padded(fn, rays, n_chunks * chunk)
        else:
            out = map_chunks(self._march_route(near, far), rays,
                             self.march_options.chunk_size)
        # copies: a replay's stats are its static tensors
        stats = {k: out.pop(k).clone() for k in MARCH_STATS if k in out}
        self._march_sweep += 1
        stats["sweep"] = self._march_sweep
        self.last_march_stats = stats
        self.accumulate_truncated(out.pop("truncated"))
        return out

    # -- CUDA graphs ---------------------------------------------------------

    def aot_register_eval(self, registry, n_rays: int, near: float,
                          far: float, chunked: bool = True) -> list[str]:
        """Register the whole-image eval renders of ``n_rays`` rays at these
        bounds with ``registry`` (JAX ``Renderer.aot_register_eval``): the
        chunked render ``eval_chunked_{n_chunks}x{chunk}`` (unless
        ``chunked`` is False: a caller that renders through the grid only)
        and, with a grid loaded, the march ``eval_march_{n_chunks}x{chunk}``
        — not for the ``gather`` route. Each entry renders the padded image
        from one static ``[n_chunks·chunk, 6]`` ray tensor. Call
        :meth:`aot_install` after ``registry.compile_all()``. Returns the
        registered names."""
        near, far = float(near), float(far)
        dev = self._device()
        names = []

        def register(name, kind, route, chunk_size, key):
            chunk, n_chunks = chunk_layout(int(n_rays), chunk_size)
            name = f"{name}_{n_chunks}x{chunk}"
            rays = torch.zeros((n_chunks * chunk, 6), dtype=torch.float32,
                               device=dev)
            registry.register(name, eval_entry(lambda: route, chunk), (rays,))
            self._aot_names[name] = (kind, (n_chunks, chunk, near, far, *key))
            names.append(name)

        if chunked:
            register("eval_chunked", "chunked", self._chunked_route(near, far),
                     self.eval_options.chunk_size, ())
        if (self.occupancy_grid is not None
                and self.march_options.march_fused != "gather"):
            register("eval_march", "march", self._march_route(near, far),
                     self.march_options.chunk_size, (self.march_options,))
        return names

    def aot_install(self, registry) -> int:
        """Adopt every captured eval entry (a failed capture keeps the eager
        path). Returns the number installed."""
        installed = 0
        for name, (kind, key) in self._aot_names.items():
            fn = registry.take(name)
            if fn is None:
                continue
            (self._chunked_fns if kind == "chunked" else
             self._march_fns)[key] = fn
            installed += 1
        return installed

    def accumulate_truncated(self, flags_or_count) -> None:
        """Fold per-ray truncation flags (or a count) into the on-device
        counter read by :meth:`report_truncation`."""
        n = torch.sum(torch.as_tensor(flags_or_count)).to(torch.int64)
        self._n_truncated = n if self._n_truncated is None else \
            self._n_truncated + n.to(self._n_truncated.device)

    def report_truncation(self, log=print) -> int:
        """One host sync: rays (since the last call) that exhausted the
        ``max_march_samples`` budget while still transparent."""
        n_truncated = 0 if self._n_truncated is None else \
            int(self._n_truncated)
        self._n_truncated = None
        if n_truncated:
            log(f"render_accelerated: {n_truncated} rays exceeded the "
                f"max_march_samples={self.march_options.max_samples} budget "
                f"while still transparent (far contributions truncated)")
        return n_truncated


def eval_packed_cap(cfg, options) -> int:
    """Stream cap per ray of the eval packed (hierarchical / clip_bbox)
    march: ``task_arg.packed_cap_avg_eval``, else the per-ray budget."""
    return int(cfg.task_arg.get("packed_cap_avg_eval", options.max_samples))


def plain_proposal_branch(fused_apply, network):
    """The fused apply for the NeRF trunk, the plain ``Network`` for
    ``model="proposal"``: the density-only sampler branch is not the trunk
    that the fused kernels compute, so K1/K2/K3a never see it."""

    def apply_fn(pts, viewdirs, model, valid=None):
        if model == "proposal":
            return network(pts, viewdirs, model=model)
        return fused_apply(pts, viewdirs, model, valid=valid)

    apply_fn.supports_valid_mask = getattr(fused_apply, "supports_valid_mask",
                                           False)
    return apply_fn


def proposal_march_fn(apply_fn, near: float, far: float, grid: torch.Tensor,
                      bbox: torch.Tensor, options, eval_options,
                      packed_cap: int):
    """``fn(rays_chunk) -> out`` of the packed proposal march: the
    deterministic resampler of ``eval_options.sampling`` admits the stream,
    the grid culls it, ``packed_cap`` rows a ray."""
    from .packed_march import march_rays_proposal_packed

    sampling, lindisp = eval_options.sampling, bool(eval_options.lindisp)
    return lambda rc: march_rays_proposal_packed(
        apply_fn, rc, near, far, grid, bbox, options, sampling,
        cap_avg=packed_cap, lindisp=lindisp)


def staged_march_fn(apply_fn, near: float, far: float, grid: torch.Tensor,
                    bbox: torch.Tensor, options, packed_cap: int,
                    eval_options: RenderOptions | None = None):
    """``fn(rays_chunk) -> out`` of the march routes that call ``apply_fn``
    (the renderer's and the serving engine's): ``march_fused gather`` (K4);
    else, when ``eval_options`` is in proposal mode, the packed proposal
    march; else the packed march when ``coarse_block > 0`` or ``clip_bbox``,
    with a stream of ``packed_cap`` rows per ray; else the per-ray march."""
    if options.march_fused == "gather":
        from ..ops.fused_march import march_rays_fused

        return lambda rc: march_rays_fused(apply_fn, rc, near, far, grid,
                                           bbox, options)
    if eval_options is not None and eval_options.sampling.mode == "proposal":
        return proposal_march_fn(apply_fn, near, far, grid, bbox, options,
                                 eval_options, packed_cap)
    if options.coarse_block > 0 or options.clip_bbox:
        from .packed_march import march_rays_packed

        return lambda rc: march_rays_packed(apply_fn, rc, near, far, grid,
                                            bbox, options, cap_avg=packed_cap)
    from .accelerated import march_rays_accelerated

    return lambda rc: march_rays_accelerated(apply_fn, rc, near, far, grid,
                                             bbox, options)


def map_chunks(fn, rays: torch.Tensor, chunk_size: int) -> dict:
    """``fn`` over ``chunk_size``-ray chunks of ``rays`` (the last chunk
    zero-padded to the same shape, as the JAX package's ``lax.map`` over
    padded chunks): per-ray outputs concatenated and cut back to the N
    rays, per-chunk scalars stacked into ``[n_chunks]``."""
    n = rays.shape[0]
    chunk, n_chunks = chunk_layout(n, chunk_size)
    pad = n_chunks * chunk - n
    if pad:
        rays = torch.cat([rays, rays.new_zeros((pad, rays.shape[-1]))], 0)
    outs = [fn(rays[i * chunk:(i + 1) * chunk]) for i in range(n_chunks)]
    return {k: (torch.cat([o[k] for o in outs], 0)[:n] if outs[0][k].dim()
                else torch.stack([o[k] for o in outs]))
            for k in outs[0]}


def chunk_layout(n_rays: int, chunk_size: int) -> tuple[int, int]:
    """``(chunk, n_chunks)`` of :func:`map_chunks` over ``n_rays`` rays."""
    chunk = min(int(chunk_size), int(n_rays))
    return chunk, -(-int(n_rays) // chunk)


def eval_entry(make_route, chunk: int):
    """``fn(rays_padded, *static) -> out``: the per-chunk route
    ``make_route(*static)`` over the chunks of a padded image, without
    autograd — the function a whole-image graph captures."""

    def render(rays, *static):
        with torch.no_grad():
            return map_chunks(make_route(*static), rays, chunk)

    return render


def replay_padded(fn, rays: torch.Tensor, n_pad: int, *static) -> dict:
    """Replay the whole-image entry ``fn`` on ``rays`` zero-padded to
    ``n_pad``: per-ray outputs cut back to the N rays (views of the entry's
    static outputs), the per-chunk stats whole."""
    n = rays.shape[0]
    if n < n_pad:
        rays = torch.cat([rays, rays.new_zeros((n_pad - n, rays.shape[-1]))])
    out = fn(rays, *static)
    return {k: v if k in MARCH_STATS else v[:n] for k, v in out.items()}


def make_renderer(cfg, network) -> Renderer:
    return Renderer(cfg, network)
