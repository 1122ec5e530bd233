"""Occupancy-accelerated ray marching, per-ray route (port of
``nerf_replication_tpu/renderer/accelerated.py``).

:func:`occupancy_sweep` classifies every march position of a ray chunk
against the baked occupancy grid in one gather (no MLP); the packed march
(``packed_march.py``) shares it. :func:`march_rays_accelerated` is the
per-ray two-phase march that lego.yaml's eval takes by default
(``march_fused off``, ``march_coarse_block 0``, no ``march_clip_bbox``): the
first K occupied positions of each ray are compacted to the front with a
stable argsort, the MLP runs once over the ``[N, K]`` points (every slot,
no mask), and compositing zeroes the weights of invalid slots and of slots
past early ray termination.

Float chain: positions ``near + s·Δ`` and points ``o + d·t`` are fused
multiply-adds, the way XLA evaluates the JAX expressions inside the jitted
march on the CPU (:func:`march_positions`, :func:`march_points`), and voxel
ids come from ``occupancy.world_to_voxel``, so the port picks the same
voxels on faces as the JAX march run under ``jax.jit``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from ..utils.numerics import cumprod, norm3_rn
from .occupancy import world_to_voxel


@dataclass(frozen=True)
class MarchOptions:
    """Accelerated-march configuration (same fields and defaults as the JAX
    package; ``fused_block`` is read for the compositing tile size only —
    the CUDA kernels choose their own rays per block)."""

    step_size: float = 0.005
    transmittance_threshold: float = 1e-4
    max_samples: int = 192
    white_bkgd: bool = True
    chunk_size: int = 4096
    clip_bbox: bool = False
    coarse_block: int = 0
    coarse_cap: int = 0
    march_fused: str = "off"
    fused_block: int = 256

    @classmethod
    def from_cfg(cls, cfg) -> "MarchOptions":
        ta = cfg.task_arg
        raw_fused = ta.get("march_fused", False)
        if isinstance(raw_fused, str):
            if raw_fused not in ("off", "gather", "full"):
                raise ValueError(
                    "task_arg.march_fused must be one of off/gather/full "
                    f"(or a bool; true = gather), got {raw_fused!r}"
                )
            fused = raw_fused
        else:
            fused = "gather" if raw_fused else "off"
        return cls(
            step_size=float(ta.get("render_step_size", 0.005)),
            transmittance_threshold=float(
                ta.get("transmittance_threshold", 1e-4)
            ),
            max_samples=int(ta.get("max_march_samples", 192)),
            white_bkgd=bool(ta.get("white_bkgd", True)),
            chunk_size=int(ta.get("march_chunk_size", 4096)),
            clip_bbox=bool(ta.get("march_clip_bbox", False)),
            coarse_block=int(ta.get("march_coarse_block", 0)),
            coarse_cap=int(ta.get("march_coarse_cap", 0)),
            march_fused=fused,
            fused_block=int(ta.get("march_fused_block", 256)),
        )

    @classmethod
    def eval_from_cfg(cls, cfg) -> "MarchOptions":
        """Eval/serve march options: ``task_arg.eval_render_step_size`` and
        ``task_arg.eval_max_march_samples`` override the shared keys."""
        base = cls.from_cfg(cfg)
        ta = cfg.task_arg
        return replace(
            base,
            step_size=float(ta.get("eval_render_step_size", base.step_size)),
            max_samples=int(
                ta.get("eval_max_march_samples", base.max_samples)
            ),
        )


def n_march_steps(near: float, far: float, step_size: float) -> int:
    """S = ceil((far − near)/Δ) positions, far excluded (the epsilon keeps
    an exactly divisible range from gaining one)."""
    return max(math.ceil((far - near) / step_size - 1e-9), 1)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a·b + c`` rounded once (a fused multiply-add): the float32
    product of two float32 values is exact in float64, so the one rounding
    is the final cast."""
    return (a.double() * b.double() + c.double()).float()


def march_positions(s_idx: torch.Tensor, near: float, step: float,
                    spans=None) -> torch.Tensor:
    """March positions ``near + s·Δ`` or, with per-ray ``spans = (t0 [N],
    step_r [N])``, ``t0 + s·step_r`` ([N, S]), for step ids ``s_idx`` ([S]
    or [N, S], float32), each as one fused multiply-add: XLA contracts both
    JAX expressions inside the jitted march on the CPU (measured on rays
    that graze voxel faces)."""
    if spans is None:
        return _fma(s_idx, torch.tensor(step, dtype=torch.float32),
                    torch.tensor(near, dtype=torch.float32))
    t0, step_r = spans
    s = s_idx if s_idx.dim() == 2 else s_idx[None, :]
    return _fma(s, step_r[:, None], t0[:, None])


def march_points(rays_o: torch.Tensor, rays_d: torch.Tensor,
                 ts: torch.Tensor) -> torch.Tensor:
    """Sample points ``o + d·t`` [N, S, 3] for positions ``ts`` ([S] shared
    or [N, S] per ray), as one fused multiply-add (XLA contracts the JAX
    expression inside the jitted march)."""
    if ts.dim() == 1:
        ts = ts[None, :]
    return _fma(rays_d[:, None, :], ts[..., None], rays_o[:, None, :])


def real_rays(rays_d: torch.Tensor) -> torch.Tensor:
    """[N] bool: rays with a non-zero direction (zero rays are padding)."""
    return torch.sum(rays_d * rays_d, dim=-1) > 0.0


def _check_static(rays: torch.Tensor) -> None:
    if rays.shape[-1] > 6:
        # an occupancy grid is a static geometry bake: time-conditioned
        # rays would skip space that is empty in one frame only
        raise ValueError(
            "the occupancy-accelerated march only supports static [N, 6] "
            f"rays, got {rays.shape[-1]} columns — time-conditioned scenes "
            "must use the chunked volume renderer (accelerated_renderer: "
            "false)"
        )


def flat_voxel_ids(vox: torch.Tensor, resolution: int) -> torch.Tensor:
    return (vox[..., 0] * resolution + vox[..., 1]) * resolution + vox[..., 2]


def occupancy_sweep(rays, near, far, grid, bbox, step_size, spans=None):
    """Phase 1 shared by the per-ray and packed marches: ``(ts, flat_vox
    [N, S] voxel ids, occupied [N, S] bool, n_steps)``.

    ``grid`` is a bool ``[R, R, R]`` tensor, ``bbox`` ``[2, 3]`` float32,
    both on the rays' device. Zero-direction rays (padding) are forced
    unoccupied. ``spans=(t0 [N], step_r [N])`` switches to per-ray
    quadrature (the packed march's clip_bbox mode): degenerate spans
    (step_r ≤ 0) are masked unoccupied and ``ts`` is ``[N, S]``."""
    _check_static(rays)
    rays_o, rays_d = rays[..., 0:3], rays[..., 3:6]
    resolution = grid.shape[0]
    n_steps = n_march_steps(near, far, step_size)
    s_idx = torch.arange(n_steps, dtype=torch.float32, device=rays.device)
    ts = march_positions(s_idx, near, step_size, spans)
    vox = world_to_voxel(march_points(rays_o, rays_d, ts), bbox, resolution)
    flat = flat_voxel_ids(vox, resolution)
    occupied = grid.reshape(-1)[flat] & real_rays(rays_d)[:, None]
    if spans is not None:
        occupied = occupied & (spans[1] > 0)[:, None]
    return ts, flat, occupied, n_steps


def march_rays_accelerated(apply_fn, rays: torch.Tensor, near: float,
                           far: float, grid: torch.Tensor, bbox: torch.Tensor,
                           options: MarchOptions,
                           return_samples: bool = False) -> dict:
    """Render a [N, 6] ray chunk with ESS + ERT through the per-ray [N, K]
    march. ``apply_fn(pts [N, K, 3], viewdirs [N, 3], model) -> raw [N, K,
    4]``.

    ``return_samples`` adds ``sample_flat`` [N, K] int32 voxel ids,
    ``sample_sigma`` [N, K] and ``sample_valid`` [N, K] bool, detached."""
    if options.clip_bbox:
        raise ValueError(
            "march_clip_bbox is implemented only by the packed march — "
            "set task_arg.ngp_packed_march true (the per-ray [N, K] "
            "march would silently run UNCLIPPED at the coarse step, "
            "invalidating any A/B labeled with the clip knob)"
        )
    if options.coarse_block > 0:
        raise ValueError(
            "march_coarse_block (hierarchical coarse-DDA traversal) is "
            "implemented only by the packed march — set "
            "task_arg.ngp_packed_march true (the per-ray [N, K] march "
            "would silently run the FLAT sweep, invalidating any A/B "
            "labeled with the hierarchical knob)"
        )
    if options.march_fused != "off":
        raise ValueError(
            "march_fused is implemented only by the fused march kernels "
            "(ops/fused_march.py) — callers must route through "
            "march_rays_fused / march_rays_fused_full, not the per-ray "
            "[N, K] march (which would silently run staged, invalidating "
            "any A/B labeled with the fused knob)"
        )
    f32 = torch.float32
    rays = rays.to(f32)
    rays_o, rays_d = rays[..., 0:3], rays[..., 3:6]
    n_rays = rays.shape[0]
    step = options.step_size
    k = options.max_samples

    ts, flat, occupied, _ = occupancy_sweep(rays, near, far, grid, bbox, step)

    # phase 2: the first K occupied positions per ray, in march order
    order = torch.argsort((~occupied).to(torch.uint8), dim=-1,
                          stable=True)[:, :k]
    valid = torch.gather(occupied, 1, order)  # [N, K]
    t_sel = ts[order]

    pts_sel = march_points(rays_o, rays_d, t_sel)
    # a padding ray (zero direction) views along 0, not 0/0: a NaN row
    # spills into its neighbour in the CPU's bfloat16 matrix product (rows
    # >= 96), which turned a real ray's bf16 map NaN
    viewdirs = torch.where(real_rays(rays_d)[:, None],
                           rays_d / norm3_rn(rays_d, keepdim=True), 0.0)
    raw = apply_fn(pts_sel, viewdirs, "fine")  # [N, K, 4]

    rgb = torch.sigmoid(raw[..., :3])
    sigma = torch.relu(raw[..., 3])
    dists = step * norm3_rn(rays_d, keepdim=True)
    alpha = (1.0 - torch.exp(-sigma * dists)) * valid

    # transmittance BEFORE each sample; zero weight once it has fallen
    # below the threshold (early ray termination)
    trans = cumprod(
        torch.cat([torch.ones((n_rays, 1), dtype=f32, device=rays.device),
                   1.0 - alpha], -1))[..., :-1]
    weights = trans * alpha * (trans >= options.transmittance_threshold)

    rgb_map = torch.sum(weights[..., None] * rgb, -2)
    depth_map = torch.sum(weights * t_sel, -1)
    acc_map = torch.sum(weights, -1)
    if options.white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    # rays whose occupied positions exceeded K while still transparent lose
    # far contributions: reported per ray, so padding rows can be sliced off
    n_occ = torch.sum(occupied, -1)
    still_alive = trans[:, -1] >= options.transmittance_threshold
    out = {
        "rgb_map_f": rgb_map,
        "depth_map_f": depth_map,
        "acc_map_f": acc_map,
        "truncated": (n_occ > k) & still_alive,
    }
    if return_samples:
        out["sample_flat"] = torch.gather(flat, 1, order).to(
            torch.int32).detach()
        out["sample_sigma"] = sigma.detach()
        out["sample_valid"] = valid
    return out
