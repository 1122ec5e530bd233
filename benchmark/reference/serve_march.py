"""A served view rendered plainly: the occupancy march over a baked grid,
the field at the samples it keeps, and front-to-back compositing with
early termination over a white background.

Positions ``near + s * step`` for ``s = 0 .. S-1`` (``S = ceil((far -
near) / step)``) along each ray; the cell of ``o + t d`` (clipped into the
bbox) decides a position. The point is rounded after its product and after
its sum, as the route forms it: at a cell's face the rounding decides the
cell. Positions go in blocks of ``coarse_block``; a block is admitted
where any of its positions lies in an occupied cell of the coarse grid
(each coarse cell the union of ``coarse_factor^3`` fine cells); only the
first ``ceil(S_blocks / 4)`` admitted blocks of a ray are looked at, and of
their positions in occupied fine cells the first ``min(max_samples, kept
blocks x coarse_block)`` are its samples. Each ray composites its samples
with ``alpha = 1 - exp(-sigma * step * |d|)``, weights zeroed once the
transmittance before a sample falls under the termination threshold.
"""

from __future__ import annotations

import math

import torch

RAY_BLOCK = 4096


def n_positions(near: float, far: float, step: float) -> int:
    return max(math.ceil((far - near) / step - 1e-9), 1)


def voxel_ids(pts: torch.Tensor, bbox, res: int) -> torch.Tensor:
    """Flat (x, y, z) cell ids of points, clipped into the bbox."""
    lo = torch.tensor(bbox[0], dtype=torch.float32, device=pts.device)
    hi = torch.tensor(bbox[1], dtype=torch.float32, device=pts.device)
    u = (torch.minimum(torch.maximum(pts, lo), hi) - lo) / (hi - lo)
    v = torch.clamp(torch.floor(u * float(res)).to(torch.int64), 0, res - 1)
    return (v[..., 0] * res + v[..., 1]) * res + v[..., 2]


def occupied_positions(rays: torch.Tensor, grid: torch.Tensor, spec: dict,
                       step: float):
    """``(ts [S], occ [N, S] bool)``: the march positions (``near + s *
    step`` in float32, rounded once) and which of them lie in occupied
    cells. Rays with a zero direction (padding rows) have none."""
    f64 = torch.float64
    near = float(torch.tensor(spec["near"], dtype=torch.float32))
    step32 = float(torch.tensor(step, dtype=torch.float32))
    s = n_positions(spec["near"], spec["far"], step)
    ts = (near + torch.arange(s, dtype=f64, device=rays.device)
          * step32).to(torch.float32)
    pts = rays[:, None, :3] + rays[:, None, 3:6] * ts[None, :, None]
    v = voxel_ids(pts, spec["bbox"], grid.shape[0])
    real = (torch.sum(rays[:, 3:6] ** 2, -1) > 0)[:, None]
    return ts, grid.reshape(-1)[v] & real


def coarse_grid(grid: torch.Tensor, factor: int) -> torch.Tensor:
    r = grid.shape[0] // factor
    return grid.reshape(r, factor, r, factor, r, factor).any(5).any(3).any(1)


def kept_positions(rays: torch.Tensor, grid: torch.Tensor, spec: dict,
                   serve: dict):
    """``(ts [S], keep [B, S] bool)``: the positions each ray samples."""
    ts, occ = occupied_positions(rays, grid, spec, serve["step"])
    s = ts.numel()
    r, factor = serve["coarse_block"], serve["coarse_factor"]
    s_blocks = -(-s // r)
    k_c = max(1, -(-s_blocks // 4))
    cap = min(serve["max_samples"], k_c * r)
    _, cocc = occupied_positions(rays, coarse_grid(grid, factor), spec,
                                 serve["step"])
    cocc = torch.nn.functional.pad(cocc, (0, s_blocks * r - s))
    blocks = cocc.reshape(rays.shape[0], s_blocks, r).any(-1)
    admitted = blocks & (torch.cumsum(blocks.to(torch.int32), -1) <= k_c)
    samp = admitted.repeat_interleave(r, dim=1)[:, :s] & occ
    keep = samp & (torch.cumsum(samp.to(torch.int32), -1) <= cap)
    return ts, keep


def composite(raw: torch.Tensor, ray: torch.Tensor, t_rows: torch.Tensor,
              rays: torch.Tensor, step: float, threshold: float):
    """Per ray ``(rgb over white [N, 3], depth [N], acc [N])`` of the
    sample rows ``raw [m, 4]`` (rays ``ray [m]``, sorted, at depths
    ``t_rows [m]``)."""
    n_rays = rays.shape[0]
    dnorm = torch.linalg.vector_norm(rays[:, 3:6], dim=-1)
    tau = torch.relu(raw[:, 3]) * (step * dnorm[ray])
    incl = torch.cumsum(tau.double(), 0)
    excl = incl - tau.double()
    first = torch.searchsorted(ray, torch.arange(n_rays, device=ray.device))
    first = torch.clamp_max(first, max(ray.numel() - 1, 0))
    trans = torch.exp(-(excl - excl[first[ray]]).to(torch.float32))
    alpha = 1.0 - torch.exp(-tau)
    w = trans * alpha * (trans >= threshold)
    rgb = torch.sigmoid(raw[:, :3])
    zeros = torch.zeros(n_rays, dtype=raw.dtype, device=raw.device)
    rgb_map = torch.zeros((n_rays, 3), dtype=raw.dtype,
                          device=raw.device).index_add(0, ray, w[:, None] * rgb)
    acc = zeros.index_add(0, ray, w)
    depth = zeros.index_add(0, ray, w * t_rows)
    return rgb_map + (1.0 - acc[:, None]), depth, acc


def render(field, rays: torch.Tensor, grid: torch.Tensor, spec: dict,
           serve: dict) -> dict:
    """``{"rgb" [N, 3], "depth" [N], "acc" [N], "samples"}`` of rays
    ``[N, 6]``; ``field(pts [m, 3], viewdirs [m, 3]) -> raw [m, 4]``."""
    outs = {"rgb": [], "depth": [], "acc": []}
    samples = 0
    for i in range(0, rays.shape[0], RAY_BLOCK):
        r = rays[i:i + RAY_BLOCK]
        ts, keep = kept_positions(r, grid, spec, serve)
        flat = torch.nonzero(keep.reshape(-1), as_tuple=True)[0]
        ray = flat // ts.numel()
        t_rows = ts[flat % ts.numel()]
        d = r[:, 3:6]
        norm = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        viewdirs = torch.where(norm > 0, d / torch.clamp_min(norm, 1e-30),
                               torch.zeros_like(d))
        pts = r[ray, :3] + r[ray, 3:6] * t_rows[:, None]
        rgb, depth, acc = composite(field(pts, viewdirs[ray]), ray, t_rows,
                                    r, serve["step"], serve["termination"])
        outs["rgb"].append(rgb)
        outs["depth"].append(depth)
        outs["acc"].append(acc)
        samples += int(flat.numel())
    out = {k: torch.cat(v) for k, v in outs.items()}
    out["samples"] = samples
    return out


def count_samples(rays: torch.Tensor, grid: torch.Tensor, spec: dict,
                  serve: dict) -> int:
    """The samples the march keeps for ``rays`` (no field evaluated)."""
    total = 0
    for i in range(0, rays.shape[0], RAY_BLOCK):
        _, keep = kept_positions(rays[i:i + RAY_BLOCK], grid, spec, serve)
        total += int(keep.sum())
    return total
