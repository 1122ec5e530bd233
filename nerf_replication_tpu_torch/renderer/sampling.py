"""Learned sampling: the proposal-network resampler that replaces the coarse
pass (port of ``nerf_replication_tpu/renderer/sampling.py``).

* :func:`resample_pdf` — inverse-CDF draw from a piecewise-constant weight
  PDF, with the annealed train mode (``a·pdf + (1−a)/B``: the PDF blends from
  uniform toward the proposal histogram over ``anneal_iters`` steps) and the
  deterministic stratified eval mode (u at bin centres ``(i + 0.5)/n``).
* :func:`proposal_render_rays` — S_p stratified proposal-MLP evaluations →
  weight histogram → S_f resampled fine-network points. The sample positions
  are detached, so the photometric loss never reaches the proposal branch,
  which trains on :func:`interlevel_loss` alone.
* :func:`interlevel_loss` — the mip-NeRF-360 weight-bound loss: the proposal
  histogram must upper-bound the (detached) fine weights on every fine
  interval.

Randomness comes from one ``torch.Generator`` (``gen``), drawn in a fixed
order — stratified jitter, then the resampler's u, then sigma noise — where
the JAX package splits a key three ways; the deterministic paths (``perturb
0``, ``raw_noise_std 0``) draw nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.numerics import norm3_rn


@dataclass(frozen=True)
class SamplingOptions:
    """``cfg.sampling``: ``mode`` "coarse_fine" keeps the hierarchical pass,
    "proposal" routes the resampler; ``aux`` (train only) returns the two
    weight histograms the interlevel loss reads."""

    mode: str = "coarse_fine"
    n_proposal: int = 64       # S_p: stratified proposal-MLP samples
    n_fine: int = 32           # S_f: resampled fine-network samples
    anneal_iters: int = 1000   # steps to sharpen the PDF from uniform
    loss_mult: float = 1.0     # interlevel loss weight
    det: bool = False          # deterministic (eval) resampling
    aux: bool = False          # return histograms for the interlevel loss

    @classmethod
    def from_cfg(cls, cfg, train: bool = True) -> "SamplingOptions":
        s = cfg.get("sampling", {})
        return cls(
            mode=str(s.get("mode", "coarse_fine")),
            n_proposal=int(s.get("n_proposal", 64)),
            n_fine=int(s.get("n_fine", 32)),
            anneal_iters=int(s.get("anneal_iters", 1000)),
            loss_mult=float(s.get("loss_mult", 1.0)),
            det=not train,
            aux=bool(train),
        )


def anneal_factor(step, anneal_iters: int):
    """``clip(step / anneal_iters, 0, 1)`` in float32 (the JAX package's
    rounding) as a 0-dim tensor on the host, which a kernel on the card
    takes as an argument; None (fully sharp) without a step or with
    ``anneal_iters <= 0``."""
    if step is None or anneal_iters <= 0:
        return None
    f32 = torch.float32
    s = torch.as_tensor(step).to(f32)
    return torch.clamp(s / torch.tensor(float(anneal_iters), dtype=f32),
                       0.0, 1.0)


def resample_pdf(gen: torch.Generator | None, bins: torch.Tensor,
                 weights: torch.Tensor, n_samples: int, det: bool = False,
                 anneal=None) -> torch.Tensor:
    """Inverse-CDF draw: bins [..., B] (sorted), weights [..., B-1] →
    samples [..., n_samples]. ``anneal`` in [0, 1] mixes the PDF with the
    uniform one; ``det`` (or no generator) draws u at the bin centres."""
    f32 = torch.float32
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    if anneal is not None:
        a = torch.as_tensor(anneal).to(f32)
        pdf = a * pdf + (1.0 - a) / pdf.shape[-1]
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)

    shape = cdf.shape[:-1] + (n_samples,)
    if det or gen is None:
        u = (torch.arange(n_samples, dtype=f32, device=cdf.device) + 0.5) \
            / n_samples
        u = u.expand(shape)
    else:
        u = torch.rand(shape, generator=gen, dtype=f32, device=cdf.device)

    # right bisection by a broadcast compare: count the cdf entries <= u
    inds = torch.sum((cdf[..., None, :] <= u[..., :, None]).to(torch.int64),
                     -1)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, cdf.shape[-1] - 1)

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    nb = bins.shape[-1] - 1
    bins = bins.expand(*cdf.shape[:-1], bins.shape[-1])
    bins_below = torch.gather(bins, -1, torch.clamp_max(below, nb))
    bins_above = torch.gather(bins, -1, torch.clamp_max(above, nb))

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def weights_from_sigma(sigma: torch.Tensor, z_vals: torch.Tensor,
                       rays_d: torch.Tensor) -> torch.Tensor:
    """Compositing weights from raw density alone: ``raw2outputs``'s alpha
    and transmittance (relu σ, the 1e10 tail interval, ‖d‖-scaled
    distances, the 1e-10-guarded cumulative product) without the rgb."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    dists = dists * norm3_rn(rays_d)[..., None]
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1),
        -1,
    )[..., :-1]
    return alpha * trans


def edges_from_samples(z: torch.Tensor) -> torch.Tensor:
    """Sample positions [..., S] → interval edges [..., S+1] (midpoints,
    the ends clamped to the first and last sample)."""
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    return torch.cat([z[..., :1], mids, z[..., -1:]], -1)


def _outer_measure(t: torch.Tensor, t_env: torch.Tensor,
                   w_env: torch.Tensor) -> torch.Tensor:
    """Envelope mass over each query interval: ``t`` [..., S+1] query edges,
    ``(t_env [..., P+1], w_env [..., P])`` the envelope histogram → [..., S],
    the total envelope weight of every bin overlapping ``[t_i, t_{i+1})``."""
    cw = torch.cat([torch.zeros_like(w_env[..., :1]),
                    torch.cumsum(w_env, -1)], -1)
    p = t_env.shape[-1] - 1
    i64 = torch.int64
    # idx_lo: the last envelope edge <= t; idx_hi: the first edge >= t
    idx_lo = torch.clamp_min(
        torch.sum((t_env[..., None, :] <= t[..., :, None]).to(i64), -1) - 1,
        0)
    idx_hi = torch.clamp_max(
        torch.sum((t_env[..., None, :] < t[..., :, None]).to(i64), -1), p)
    cw_lo = torch.gather(cw, -1, idx_lo)
    cw_hi = torch.gather(cw, -1, idx_hi)
    return cw_hi[..., 1:] - cw_lo[..., :-1]


def interlevel_loss(t_fine: torch.Tensor, w_fine: torch.Tensor,
                    t_prop: torch.Tensor, w_prop: torch.Tensor,
                    eps: float = 1e-7) -> torch.Tensor:
    """``mean(Σ max(0, w_f − bound)² / (w_f + eps))`` with ``bound`` the
    proposal's outer measure over each fine interval. The fine inputs are
    detached: the loss trains the proposal to cover the fine weights, never
    the reverse. Zero exactly where the proposal bounds them everywhere."""
    t_f = t_fine.detach()
    w_f = w_fine.detach()
    bound = _outer_measure(t_f, t_prop, w_prop)
    excess = torch.clamp_min(w_f - bound, 0.0)
    return torch.mean(torch.sum(excess ** 2 / (w_f + eps), -1))


def proposal_render_rays(apply_fn, rays: torch.Tensor, near, far,
                         gen: torch.Generator | None, options,
                         step=None) -> dict:
    """The ``sampling.mode: proposal`` route of ``volume.render_rays``:
    S_p stratified points → proposal density → weight histogram → S_f
    inverse-CDF resampled fine-network points. ``step`` (the train step;
    None at eval) drives the PDF anneal. Returns the fine maps under the
    ``*_map_f`` keys; with ``options.sampling.aux`` also the two (edges,
    weights) histograms of the interlevel loss (``prop_t``/``prop_w`` keep
    their gradients, ``fine_t``/``fine_w`` are detached)."""
    from .volume import raw2outputs, stratified_z_vals

    s = options.sampling
    rays_o, rays_d = rays[..., 0:3], rays[..., 3:6]
    t_col = rays[..., 6:7] if rays.shape[-1] > 6 else None
    n_rays = rays.shape[0]

    def _with_t(pts):
        if t_col is None:
            return pts
        t = t_col[..., None, :].expand(*pts.shape[:-1], 1)
        return torch.cat([pts, t], -1)

    z_p = stratified_z_vals(gen, near, far, n_rays, s.n_proposal,
                            options.perturb, options.lindisp, rays.device)
    pts_p = rays_o[..., None, :] + rays_d[..., None, :] * z_p[..., :, None]
    viewdirs = rays_d / norm3_rn(rays_d, keepdim=True)

    raw_p = apply_fn(_with_t(pts_p), viewdirs, "proposal")
    w_p = weights_from_sigma(raw_p[..., 0], z_p, rays_d)

    # 0 at step 0 (pure uniform: an untrained proposal cannot starve the
    # fine network of coverage), 1 from anneal_iters on (the histogram)
    anneal = anneal_factor(step, s.anneal_iters)
    z_mid = 0.5 * (z_p[..., 1:] + z_p[..., :-1])
    z_f = resample_pdf(gen, z_mid, w_p[..., 1:-1], s.n_fine,
                       det=s.det or options.perturb == 0.0, anneal=anneal)
    # sample positions are not a gradient path
    z_f = torch.sort(z_f, -1)[0].detach()

    pts_f = rays_o[..., None, :] + rays_d[..., None, :] * z_f[..., :, None]
    raw_f = apply_fn(_with_t(pts_f), viewdirs, "fine")
    rgb_f, depth_f, acc_f, w_f = raw2outputs(
        raw_f, z_f, rays_d, gen, options.raw_noise_std, options.white_bkgd)
    out = {"rgb_map_f": rgb_f, "depth_map_f": depth_f, "acc_map_f": acc_f}
    if s.aux:
        out["prop_t"] = edges_from_samples(z_p)
        out["prop_w"] = w_p
        out["fine_t"] = edges_from_samples(z_f).detach()
        out["fine_w"] = w_f.detach()
    return out
