"""Globally packed occupancy march (port of
``nerf_replication_tpu/renderer/packed_march.py``): samples compacted across
the rays of a chunk into one stream of M = N × cap_avg rows.

1. **Admission**: the flat occupancy sweep (``accelerated.occupancy_sweep``)
   or, with ``march_coarse_block > 0``, the hierarchical coarse-DDA sweep
   (:func:`_hierarchical_sweep`); ``march_clip_bbox`` switches either to
   per-ray quadrature over the ray's bbox span (:func:`_ray_bbox_spans`).
2. **Global compaction** (:func:`_composite_stream`): a stable partition of
   the flattened candidates, occupied first, both halves in (ray, t) order —
   the order of the JAX ``lax.sort_key_val`` on ``where(occ, idx, total +
   idx)`` (unique keys), computed here from two prefix sums and one
   scatter, with no sort. The first M rows are the stream.
3. **One MLP pass over the stream** — through the masked fused kernel K3a
   when the apply advertises ``supports_valid_mask`` (the occupancy bit
   streams into the kernel, which skips all-invalid tiles), else the apply
   as it is — then log-space compositing: ``T = exp(−(e − e0))`` from one
   exclusive cumsum of ``τ = σ·δ·valid`` and each ray's value at its segment
   start.

Per-ray sums: the JAX package's ``segment_sum`` scatters the stream rows in
order in float32; the port takes each ray's run of rows as the difference
of one float64 prefix sum over the stream, rounded once — a few float32
ulps from the sequential sum, reproducible on the card (a scan in a fixed
order, ``utils.numerics.prefix_sum``; no atomics) and free of the serial
per-segment loop of
``torch.segment_reduce``, which on the card summed the ~95% padding tail of
a sparse stream in one thread. The transmittance's prefix ``e − e0`` is
float64 too (see :func:`_composite_stream`).

Truncation is global: a ray loses samples only when the stream overflows M
before its segment ends, and it is flagged only while still transparent.
:func:`march_rays_proposal_packed` admits the stream by the learned
sampler instead: the deterministic proposal resampler places each ray's
candidates and the grid culls them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .accelerated import (
    MarchOptions,
    _check_static,
    flat_voxel_ids,
    march_points,
    march_positions,
    n_march_steps,
    occupancy_sweep,
    real_rays,
)
from ..utils.numerics import norm3_rn, prefix_sum
from .occupancy import PYRAMID_FACTORS, coarse_from_grid, world_to_voxel


def _ray_bbox_spans(rays_o, rays_d, bbox, near, far):
    """Per-ray ``(t0, t1)`` of the bbox intersection clipped to [near, far]
    (slab method); rays missing the bbox come back with t1 == t0."""
    tiny = torch.full((), 1e-12, dtype=torch.float32, device=rays_d.device)
    inv = 1.0 / torch.where(rays_d.abs() < tiny, tiny, rays_d)
    t_lo = (bbox[0] - rays_o) * inv
    t_hi = (bbox[1] - rays_o) * inv
    tmin = torch.minimum(t_lo, t_hi).amax(-1)
    tmax = torch.maximum(t_lo, t_hi).amin(-1)
    t0 = torch.clamp(tmin, near, far)
    t1 = torch.clamp(tmax, near, far)
    return t0, torch.maximum(t1, t0)


def hierarchical_caps(n_steps: int, options) -> tuple[int, int]:
    """Static (S_c coarse blocks per ray, K_c kept-interval budget).

    K_c defaults to ceil(S_c / 4); rays crossing more than K_c occupied
    coarse blocks are clipped and report ``truncated``."""
    r = options.coarse_block
    s_c = -(-n_steps // r)
    k_c = options.coarse_cap if options.coarse_cap > 0 else max(1, -(-s_c // 4))
    return s_c, min(k_c, s_c)


def _first_k_in_order(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first ``k`` entries per row after a stable partition
    (True first, each half in order): ``argsort(~mask, stable=True)[:, :k]``."""
    return torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)[:, :k]


def _hierarchical_sweep(rays, near, far, grid, bbox, options, spans):
    """Coarse-DDA phase 1: a fixed-step march of the coarse pyramid level
    (the parent cell ``fine_vox // factor`` of each position) admits blocks
    of ``coarse_block`` consecutive fine positions; only the first K_c
    admitted blocks per ray get the fine-grid lookup.

    Returns ``(flat_cand [N, C], occ_cand [N, C] bool, s_f [N, C] fine step
    ids, n_steps, n_blk [N], block_frac, k_c)`` with C = K_c · coarse_block.
    """
    _check_static(rays)
    rays_o, rays_d = rays[..., 0:3], rays[..., 3:6]
    n_rays = rays.shape[0]
    dev = rays.device
    resolution = grid.shape[0]
    factor = PYRAMID_FACTORS[-1]
    r = options.coarse_block
    n_steps = n_march_steps(near, far, options.step_size)
    s_c, k_c = hierarchical_caps(n_steps, options)
    s_pad = s_c * r

    s_idx = torch.arange(s_pad, dtype=torch.float32, device=dev)
    ts = march_positions(s_idx, near, options.step_size, spans)
    vox = world_to_voxel(march_points(rays_o, rays_d, ts), bbox, resolution)

    # the coarse test in index space (parent = fine // factor), so the
    # coarse level is a strict superset of the fine grid along the march
    coarse = coarse_from_grid(grid, factor)
    rc = coarse.shape[0]
    cflat = flat_voxel_ids(vox // factor, rc)
    coarse_occ = coarse.reshape(-1)[cflat]  # [N, S_pad] bool
    in_range = torch.arange(s_pad, device=dev) < n_steps
    coarse_occ = coarse_occ & real_rays(rays_d)[:, None] & in_range[None, :]
    if spans is not None:
        coarse_occ = coarse_occ & (spans[1] > 0)[:, None]

    block_occ = coarse_occ.reshape(n_rays, s_c, r).any(-1)  # [N, S_c]
    n_blk = torch.sum(block_occ, -1)
    block_frac = torch.mean(block_occ.to(torch.float32))

    border = _first_k_in_order(block_occ, k_c)  # [N, K_c]
    bvalid = torch.gather(block_occ, 1, border)

    s_f = border[..., None] * r + torch.arange(r, device=dev)
    s_f = s_f.reshape(n_rays, k_c * r)
    cand_mask = bvalid[..., None].expand(n_rays, k_c, r).reshape(
        n_rays, k_c * r) & (s_f < n_steps)

    flat_all = flat_voxel_ids(vox, resolution)
    flat_cand = torch.gather(flat_all, 1, s_f)
    occ_cand = grid.reshape(-1)[flat_cand] & cand_mask
    return flat_cand, occ_cand, s_f, n_steps, n_blk, block_frac, k_c


def _stream_order(occ_flat: torch.Tensor) -> torch.Tensor:
    """The stable partition of ``occ_flat`` [T] (occupied first, both halves
    in index order) as a permutation of ``arange(T)`` — the JAX
    ``sort_key_val(where(occ, idx, T + idx), idx)`` order, exactly."""
    occ_i = occ_flat.to(torch.int64)
    n_occ = occ_i.sum()
    pos = torch.where(occ_flat, torch.cumsum(occ_i, 0) - 1,
                      n_occ + torch.cumsum(1 - occ_i, 0) - 1)
    order = torch.empty_like(pos)
    order[pos] = torch.arange(occ_flat.shape[0], device=occ_flat.device)
    return order


def _composite_stream(apply_fn, rays_o, rays_d, occupied, t_cand, dist_cand,
                      options: MarchOptions, m_cap: int, extra_lost=None,
                      model: str = "fine", tau_clip: float | None = None):
    """Phase 2 shared by every packed admission structure: global
    compaction → one MLP pass over the stream → log-space segmented
    compositing. Inputs are per-candidate arrays in per-ray march order:
    ``occupied [N, C]``, ``t_cand [N, C]``, ``dist_cand [N, C]``
    (‖d‖-scaled). Returns ``(out, aux)`` with the stream internals
    ``{order, valid, sigma}``."""
    f32 = torch.float32
    n_rays, n_cand = occupied.shape
    m_cap = min(int(m_cap), n_rays * n_cand)
    total = n_rays * n_cand
    occ_flat = occupied.reshape(-1)
    order = _stream_order(occ_flat)[:m_cap]
    valid = occ_flat[order]  # [M] bool (False: stream tail)

    ray_id = order // n_cand  # nondecreasing over the valid prefix
    t_m = t_cand.reshape(-1)[order]
    dists = dist_cand.reshape(-1)[order]
    pts_m = march_points(rays_o[ray_id], rays_d[ray_id], t_m[:, None])[:, 0]
    viewdirs = rays_d / norm3_rn(rays_d, keepdim=True)

    # the stream is "M rays of one sample each"; a masked apply takes the
    # occupancy bit into the kernel (K3a)
    if getattr(apply_fn, "supports_valid_mask", False):
        raw = apply_fn(pts_m[:, None, :], viewdirs[ray_id], model,
                       valid=valid.to(f32))[:, 0, :]
    else:
        raw = apply_fn(pts_m[:, None, :], viewdirs[ray_id], model)[:, 0, :]

    rgb = torch.sigmoid(raw[..., :3])
    sigma = torch.relu(raw[..., 3])
    # 1 − α = exp(−σδ): transmittance in log space is exact
    tau = sigma * dists * valid.to(f32)
    if tau_clip is not None:
        tau = torch.clamp_max(tau, tau_clip)
    # the stream prefix sum and each ray's in-segment difference e − e0 in
    # float64, rounded once: the prefix over a whole chunk grows to ~1e5 on
    # a trained scene, where a float32 e − e0 (the JAX package's) keeps only
    # ~1e-2 of absolute precision, so two applies that differ by an ulp
    # would composite maps ~1e-3 apart
    tau64 = tau.double()
    c = prefix_sum(tau64)
    e = c - tau64  # exclusive prefix

    # per-ray segment starts: samples are (ray, t)-sorted
    n_occ = torch.sum(occupied, -1)  # [N]
    cum_occ = torch.cumsum(n_occ, 0)
    seg_start = torch.clamp_max(cum_occ - n_occ, m_cap - 1)
    e0 = e[seg_start]
    trans = torch.exp(-(e - e0[ray_id]).to(f32))  # T BEFORE each sample
    alpha = 1.0 - torch.exp(-tau)
    weights = trans * alpha * (trans >= options.transmittance_threshold)

    kept_start = torch.clamp_max(cum_occ - n_occ, m_cap)
    kept_end = torch.clamp_max(cum_occ, m_cap)
    kept_n = kept_end - kept_start
    contrib = torch.cat([weights[:, None] * rgb, weights[:, None],
                         (weights * t_m)[:, None]], -1)  # [M, 5]
    # each ray's kept rows are one run [kept_start, kept_end) of the valid
    # prefix: its sum is a difference of one float64 prefix sum over the
    # stream, rounded once (a scan: no atomics, no per-ray serial loop),
    # the five columns scanned as five series along their inner axis
    pre = F.pad(prefix_sum(contrib.double().t()), (1, 0))  # [5, M + 1]
    sums = (pre[:, kept_end] - pre[:, kept_start]).t().to(f32)
    rgb_map, acc_map, depth_map = sums[:, 0:3], sums[:, 3], sums[:, 4]
    if options.white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])

    # some of r's samples fell off the stream (a ray with no occupied
    # sample renders background correctly and is not flagged)
    lost = (cum_occ > kept_end) & (n_occ > 0)
    # transmittance after the last KEPT sample; a ray that kept none is
    # trivially still transparent
    c_end = c[torch.clamp_min(kept_end - 1, 0)]
    t_after = torch.where(kept_n > 0, torch.exp(-(c_end - e0).to(f32)),
                          torch.ones((), dtype=f32, device=c_end.device))
    still_alive = t_after >= options.transmittance_threshold
    if extra_lost is not None:
        lost = lost | extra_lost
    n_total_occ = cum_occ[-1]
    out = {
        "rgb_map_f": rgb_map,
        "depth_map_f": depth_map,
        "acc_map_f": acc_map,
        "truncated": lost & still_alive,
        "overflow_frac": (
            torch.clamp_min(n_total_occ - m_cap, 0).to(f32)
            / torch.clamp_min(n_total_occ, 1).to(f32)
        ),
        # traversal telemetry: rows entering the compaction and occupied
        # rows surviving admission
        "march_candidates": torch.full((), float(total), dtype=f32,
                                       device=occupied.device),
        "march_samples_out": n_total_occ.to(f32),
    }
    aux = {"order": order, "valid": valid, "sigma": sigma}
    return out, aux


def march_rays_packed(apply_fn, rays: torch.Tensor, near: float, far: float,
                      grid: torch.Tensor, bbox: torch.Tensor,
                      options: MarchOptions, cap_avg: int = 32,
                      return_samples: bool = False) -> dict:
    """Render a [N, 6] ray chunk with globally packed ESS + ERT.

    Output contract of ``march_rays_accelerated`` (rgb/depth/acc maps,
    per-ray ``truncated``) plus ``overflow_frac`` (the share of occupied
    samples dropped by the M = N × cap_avg cap) and the traversal scalars
    ``march_candidates``, ``march_samples_out``, ``march_coarse_occ``."""
    f32 = torch.float32
    rays = rays.to(f32)
    rays_o, rays_d = rays[..., 0:3], rays[..., 3:6]
    n_rays = rays.shape[0]
    step = options.step_size

    if options.clip_bbox:
        n_est = n_march_steps(near, far, step)
        t0, t1 = _ray_bbox_spans(rays_o, rays_d, bbox, near, far)
        # XLA evaluates (t1 - t0) / S as a product with the float32
        # reciprocal of S; so does the port
        inv_s = 1.0 / torch.full((), float(n_est), dtype=f32,
                                 device=rays.device)
        step_r = (t1 - t0) * inv_s
        spans = (t0, step_r)
    else:
        t0 = step_r = spans = None
    extra_lost = None
    if options.coarse_block > 0:
        flat_vox, occupied, s_f, _, n_blk_c, block_frac, k_c = (
            _hierarchical_sweep(rays, near, far, grid, bbox, options, spans))
        t_cand = march_positions(s_f.to(f32), near, step, spans)
        # rays crossing more than K_c occupied blocks lost whole intervals
        # before the stream saw them
        extra_lost = n_blk_c > k_c
    else:
        ts, flat_vox, occupied, _ = occupancy_sweep(
            rays, near, far, grid, bbox, step, spans=spans)
        t_cand = ts.expand(occupied.shape)
        block_frac = torch.full((), 1.0, dtype=f32, device=rays.device)
    d_norm = norm3_rn(rays_d)
    dist_ray = (step_r if options.clip_bbox else step) * d_norm  # [N]
    dist_cand = dist_ray[:, None].expand(occupied.shape)
    m_cap = min(int(n_rays * cap_avg), n_rays * occupied.shape[-1])

    out, aux = _composite_stream(apply_fn, rays_o, rays_d, occupied, t_cand,
                                 dist_cand, options, m_cap,
                                 extra_lost=extra_lost)
    out["march_coarse_occ"] = block_frac
    if return_samples:
        out["sample_flat"] = occ_to_flat(flat_vox, aux["order"])
        out["sample_sigma"] = aux["sigma"].detach()
        out["sample_valid"] = aux["valid"].to(f32)
    return out


def march_rays_proposal_packed(apply_fn, rays: torch.Tensor, near: float,
                               far: float, grid: torch.Tensor,
                               bbox: torch.Tensor, options: MarchOptions,
                               sampling, cap_avg: int = 32,
                               lindisp: bool = False) -> dict:
    """The proposal resampler as the packed stream's admission (eval only).

    The deterministic quadrature of ``proposal_render_rays`` (stratified
    proposal depths → proposal σ → weight histogram → det inverse-CDF
    resample, sorted) gives each ray ``n_fine`` candidate depths; the
    occupancy grid culls the ones in carved-empty space; the shared
    compaction, the fine MLP over the stream (K3a under ``fused_trunk``)
    and the log-space composite run on the survivors. The candidates'
    widths are ``raw2outputs``' (the 1e10 tail interval, ‖d‖-scaled), τ is
    clamped at 80, so on an all-admitting grid the maps are the chunked
    proposal render's to float tolerance. Output contract of
    :func:`march_rays_packed`; ``march_coarse_occ`` is the share of
    resampled points the grid admitted."""
    from .sampling import resample_pdf, weights_from_sigma
    from .volume import stratified_z_vals

    _check_static(rays)
    f32 = torch.float32
    rays = rays.to(f32)
    rays_o, rays_d = rays[..., 0:3], rays[..., 3:6]
    n_rays = rays.shape[0]

    z_p = stratified_z_vals(None, near, far, n_rays, sampling.n_proposal,
                            0.0, lindisp, rays.device)
    pts_p = march_points(rays_o, rays_d, z_p)
    viewdirs = rays_d / norm3_rn(rays_d, keepdim=True)
    raw_p = apply_fn(pts_p, viewdirs, "proposal")
    w_p = weights_from_sigma(raw_p[..., 0], z_p, rays_d)
    z_mid = 0.5 * (z_p[..., 1:] + z_p[..., :-1])
    z_f = resample_pdf(None, z_mid, w_p[..., 1:-1], sampling.n_fine,
                       det=True)
    z_f = torch.sort(z_f, -1)[0].detach()  # [N, S_f]

    # admission: the grid culls resampled points in carved space
    resolution = grid.shape[0]
    vox = world_to_voxel(march_points(rays_o, rays_d, z_f), bbox, resolution)
    flat = flat_voxel_ids(vox, resolution)
    occupied = grid.reshape(-1)[flat] & real_rays(rays_d)[:, None]

    dz = torch.cat([z_f[..., 1:] - z_f[..., :-1],
                    torch.full_like(z_f[..., :1], 1e10)], -1)
    dist_cand = dz * norm3_rn(rays_d)[:, None]

    m_cap = min(int(n_rays * cap_avg), n_rays * sampling.n_fine)
    out, _ = _composite_stream(apply_fn, rays_o, rays_d, occupied, z_f,
                               dist_cand, options, m_cap, tau_clip=80.0)
    out["march_coarse_occ"] = torch.mean(occupied.to(f32))
    return out


def occ_to_flat(flat_vox: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """The [N, C] flat voxel ids at the packed stream's positions (int32)."""
    return flat_vox.reshape(-1)[order].to(torch.int32)
