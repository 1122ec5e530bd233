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
the plain path keeps autograd's. ``sampling.mode: proposal`` raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


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

    @classmethod
    def from_cfg(cls, cfg, train: bool = True) -> "RenderOptions":
        ta = cfg.task_arg
        mode = str(cfg.get("sampling", {}).get("mode", "coarse_fine"))
        if mode == "proposal":
            raise NotImplementedError(
                "sampling.mode: proposal (the learned sampler) comes with "
                "port slice 5"
            )
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
        )


def stratified_z_vals(gen: torch.Generator | None, near, far, n_rays: int,
                      n_samples: int, perturb: float, lindisp: bool = False,
                      device="cpu") -> torch.Tensor:
    """[n_rays, n_samples] depths: linspace in depth (or disparity) with
    per-bin uniform jitter when perturb > 0 and a generator is given."""
    f32 = torch.float32
    t = torch.linspace(0.0, 1.0, n_samples, dtype=f32, device=device)
    near = torch.as_tensor(near, dtype=f32, device=device)
    far = torch.as_tensor(far, dtype=f32, device=device)
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
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)

    rgb = torch.sigmoid(raw[..., :3])
    sigma_raw = raw[..., 3]
    if raw_noise_std > 0.0 and gen is not None:
        sigma_raw = sigma_raw + torch.randn(
            sigma_raw.shape, generator=gen, dtype=torch.float32,
            device=sigma_raw.device) * raw_noise_std
    sigma = torch.relu(sigma_raw)

    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1),
        -1,
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
                options: RenderOptions) -> dict:
    """Render a [N, 6] (or [N, 7] time-conditioned) ray batch through the
    coarse (+ fine) network. ``apply_fn(pts, viewdirs, model)`` returns raw
    ``[..., S, 4]``. Keys: ``rgb_map_c/f``, ``depth_map_c/f``,
    ``acc_map_c/f``."""
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
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)

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

    def _apply_fn(self):
        if self._fused_apply is not None:
            return self._fused_apply
        network = self.network
        return lambda pts, viewdirs, model: network(pts, viewdirs, model=model)

    def render(self, batch: dict, gen: torch.Generator | None = None,
               train: bool = True) -> dict:
        """Render a batch ``{rays [N, 6], near, far}``."""
        options = self.train_options if train else self.eval_options
        return render_rays(self._apply_fn(), batch["rays"], batch["near"],
                           batch["far"], gen, options)

    def render_chunked(self, batch: dict) -> dict:
        """Whole-image eval in chunks of ``chunk_size`` rays (the last chunk
        zero-padded to the same shape, as the JAX package's ``lax.map``
        does), outputs concatenated and cut back to the N rays. Drawn
        without a generator, as the JAX package's validation renders with
        no key: eval is deterministic."""
        rays = batch["rays"]
        n = rays.shape[0]
        chunk = min(self.eval_options.chunk_size, n)
        n_chunks = -(-n // chunk)
        pad = n_chunks * chunk - n
        if pad:
            rays = torch.cat([rays, rays.new_zeros((pad, rays.shape[-1]))], 0)
        outs = [render_rays(self._apply_fn(), rays[i * chunk:(i + 1) * chunk],
                            batch["near"], batch["far"], None,
                            self.eval_options)
                for i in range(n_chunks)]
        return {k: torch.cat([o[k] for o in outs], 0)[:n] for k in outs[0]}


def make_renderer(cfg, network) -> Renderer:
    return Renderer(cfg, network)
