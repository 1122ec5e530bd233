"""Fused ray march on Hopper: DDA + sampling (+ MLP + compositing).

Port of ``nerf_replication_tpu/ops/fused_march.py``. Two TPU kernels become
two hand-written CUDA kernels (``csrc/``), each beside a plain PyTorch
version of the same function:

* **K4**, :func:`dda_block` (replaces ``_dda_kernel``, fused_march.py:241):
  per ray, the coarse DDA on the parent pyramid cell, the first-K_c interval
  compaction in march order, the fine occupancy gather at the K_c·r
  candidates and the second compaction to K slots. It is the traversal of
  the ``march_fused: gather`` route (:func:`march_rays_fused`), whose MLP is
  the plain :class:`~..models.nerf.network.Network`, as in the JAX engine.
* **K5**, :func:`march_full_block` (replaces ``_full_kernel``,
  fused_march.py:514): the K4 body, then frequency encoding of the surviving
  samples, the Hopper MLP chain (``csrc/mlp_chain_sm90.cuh``, the rounding
  points of ``ops/fused_mlp.py``) and
  log-space compositing with early ray termination, in one kernel. It is the
  ``march_fused: full`` route (:func:`march_rays_fused_full`).

A wrapper runs the plain version for a tensor on the CPU and the kernel for a
tensor on a card; there is no fallback from one to the other. Each launch adds
one to :data:`LAUNCHES`.

Semantics kept from the JAX package (the tests hold both sides to them):
zero-direction padding rays admit nothing; candidates past the last march
step are masked; compaction keeps the first K_c occupied blocks and the first
K occupied candidates in march order; voxel ids come from the same float32
operations in the same order (``renderer/occupancy.world_to_voxel``; the
march positions ``t0 + s·step_r`` as one fused multiply-add, which is how
XLA evaluates the JAX expression; with ``clip_bbox`` the span divided by S
as a product with the float32 reciprocal of S, which is XLA's rewrite);
compositing is ``T = exp(-(c_prev + cumsum τ − τ))``, ``w = T·α·(T ≥ thr)``
over tiles of ``k_tile`` slots, white background after the march.

Deliberate difference: the JAX package maps its body over blocks of
``fused_block`` rays inside ``march_chunk_size`` chunks. The port launches one
kernel over all the rays it is given (rays are independent) and reads
``fused_block`` only to size the compositing tile (``k_tile``) the way the
JAX package does, so the two sum in the same order.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from ..renderer.occupancy import (
    PYRAMID_FACTORS,
    coarse_from_grid,
    world_to_voxel,
)
from ..utils.numerics import norm3_rn, sq_norm3, sqrt_rn
from .fused_mlp import FusedSpec, _pad_cols, _rup, forward_tile, pack_for_chain
from .kernels import MlpDescC, _ptr, _raise_on, _stream

# kernel launches per wrapper since the last reset (chip_smoke.py resets it
# right before it drives the serving path and reads it right after)
LAUNCHES: dict[str, int] = {"fused_dda_gather": 0, "fused_march_full": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclass(frozen=True)
class FusedStatics:
    """Constants of one fused-march configuration."""

    resolution: int   # fine grid R
    rc: int           # coarse grid R_c
    factor: int       # fine→coarse index divisor (PYRAMID_FACTORS[-1])
    r: int            # fine steps per coarse block
    s_c: int          # coarse blocks per ray
    k_c: int          # kept-interval budget per ray
    n_steps: int      # fine march steps (S)
    k_sel: int        # per-ray sample-slot budget K = min(max_samples, C)
    compact: bool     # K < C: the second per-ray compaction runs
    step: float
    near: float
    far: float
    clip: bool
    threshold: float
    white_bkgd: bool

    @property
    def c_total(self) -> int:
        return self.k_c * self.r


def _statics_for(grid_res: int, rc: int, near: float, far: float,
                 options) -> FusedStatics:
    from ..renderer.packed_march import hierarchical_caps

    if options.coarse_block <= 0:
        raise ValueError(
            "march_fused requires march_coarse_block > 0 — the fused "
            "kernel's traversal IS the hierarchical coarse DDA"
        )
    r = options.coarse_block
    n_steps = max(math.ceil((far - near) / options.step_size - 1e-9), 1)
    s_c, k_c = hierarchical_caps(n_steps, options)
    c_total = k_c * r
    k_sel = min(options.max_samples, c_total)
    return FusedStatics(
        resolution=int(grid_res), rc=int(rc),
        factor=PYRAMID_FACTORS[-1], r=r, s_c=s_c, k_c=k_c,
        n_steps=n_steps, k_sel=k_sel, compact=k_sel < c_total,
        step=float(options.step_size), near=float(near), far=float(far),
        clip=bool(options.clip_bbox),
        threshold=float(options.transmittance_threshold),
        white_bkgd=bool(options.white_bkgd),
    )


def compositing_tile(options, n_rays: int) -> int:
    """Slots per compositing tile: the JAX package's ``k_tile`` for a
    chunk of ``n_rays`` rays (512 rows per MLP tile over ``fused_block``
    rays)."""
    blk = min(int(options.fused_block), max(int(n_rays), 1))
    return max(1, 512 // blk)


# -- plain PyTorch versions ----------------------------------------------------


def _rank_compact(occ: torch.Tensor, n_slots: int, *payloads):
    """First ``n_slots`` occupied entries per row, in order:
    ``(valid [B, n_slots], payloads gathered into their slots)``; unfilled
    slots hold 0."""
    b = occ.shape[0]
    occ_i = occ.to(torch.int64)
    rank = torch.cumsum(occ_i, -1) - occ_i
    keep = occ & (rank < n_slots)
    slot = torch.where(keep, rank, torch.full_like(rank, n_slots))
    valid = torch.zeros((b, n_slots + 1), dtype=torch.bool, device=occ.device)
    valid.scatter_(1, slot, keep)
    outs = []
    for p in payloads:
        o = torch.zeros((b, n_slots + 1), dtype=p.dtype, device=p.device)
        o.scatter_(1, slot, torch.where(keep, p, torch.zeros_like(p)))
        outs.append(o[:, :n_slots])
    return (valid[:, :n_slots], *outs)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a·b + c`` rounded once, like ``__fmaf_rn``. Used for the
    march positions ``t = fma(s, step_r, t0)``: with s an integer below
    2^24 the product and the sum are exact in float64, so the one rounding
    to float32 is the fused multiply-add's."""
    return (a.double() * b.double() + c.double()).float()


def _march_t(s: torch.Tensor, step_r: torch.Tensor,
             t0: torch.Tensor) -> torch.Tensor:
    """March positions ``t0 + s·step_r`` as one fused multiply-add: XLA
    contracts the JAX expression into an FMA on the CPU, and the kernels
    use ``__fmaf_rn``; ``s [B, S]`` (float32 integers), ``step_r``/``t0``
    [B]."""
    return _fma(s, step_r[:, None], t0[:, None])


def _march_pts(st, o: torch.Tensor, d: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
    """Sample points ``o + d·t`` ([B, S, 3]) for march positions ``t [B,
    S]``: with ``clip`` one fused multiply-add (XLA contracts the JAX
    expression when t is a per-ray value), else multiply, then add."""
    if st.clip:
        return _fma(d[:, None, :], t[..., None], o[:, None, :])
    return o[:, None, :] + d[:, None, :] * t[..., None]


def dda_block_plain(st: FusedStatics, rays: torch.Tensor,
                    grid_flat: torch.Tensor, coarse_flat: torch.Tensor,
                    bbox: torch.Tensor):
    """K4's function in PyTorch: ``(t_sel [B, K] f32, valid [B, K] bool,
    flat_sel [B, K] i32, n_occ [B] i32, n_blk [B] i32, dist [B] f32)``."""
    f32 = torch.float32
    dev = rays.device
    o, d = rays[:, 0:3], rays[:, 3:6]
    b = rays.shape[0]
    near = torch.full((), st.near, dtype=f32, device=dev)
    far = torch.full((), st.far, dtype=f32, device=dev)

    if st.clip:
        tiny = torch.full((), 1e-12, dtype=f32, device=dev)
        inv = 1.0 / torch.where(d.abs() < tiny, tiny, d)
        t_lo = (bbox[0] - o) * inv
        t_hi = (bbox[1] - o) * inv
        tmin = torch.minimum(t_lo, t_hi).amax(-1)
        tmax = torch.maximum(t_lo, t_hi).amin(-1)
        t0 = torch.minimum(torch.maximum(tmin, near), far)
        t1 = torch.maximum(torch.minimum(torch.maximum(tmax, near), far), t0)
        # XLA evaluates (t1 - t0) / S as a product with the float32
        # reciprocal of S; so do the port and its kernels
        inv_s = 1.0 / torch.full((), float(st.n_steps), dtype=f32,
                                 device=dev)
        step_r = (t1 - t0) * inv_s
    else:
        t0 = near.expand(b)
        step_r = torch.full((), st.step, dtype=f32, device=dev).expand(b)

    s_pad = st.s_c * st.r
    s_idx = torch.arange(s_pad, dtype=f32, device=dev)
    ts = _march_t(s_idx.expand(b, s_pad), step_r, t0)  # [B, S_pad]
    pts = _march_pts(st, o, d, ts)
    vox = world_to_voxel(pts, bbox, st.resolution)
    cvox = vox // st.factor
    cflat = (cvox[..., 0] * st.rc + cvox[..., 1]) * st.rc + cvox[..., 2]
    coarse_occ = coarse_flat[cflat] > 0
    dd = sq_norm3(d)
    real = dd > 0.0
    in_range = torch.arange(s_pad, device=dev) < st.n_steps
    coarse_occ = coarse_occ & real[:, None] & in_range[None, :]
    if st.clip:
        coarse_occ = coarse_occ & (step_r > 0)[:, None]

    block_occ = coarse_occ.reshape(b, st.s_c, st.r).any(-1)
    n_blk = block_occ.sum(-1).to(torch.int32)
    s_blocks = torch.arange(st.s_c, device=dev).expand(b, st.s_c)
    bvalid, border = _rank_compact(block_occ, st.k_c, s_blocks)

    s_f = border[..., None] * st.r + torch.arange(st.r, device=dev)
    s_f = s_f.reshape(b, st.c_total)
    cand = bvalid[..., None].expand(b, st.k_c, st.r).reshape(
        b, st.c_total
    ) & (s_f < st.n_steps)
    t_cand = _march_t(s_f.to(f32), step_r, t0)
    pts_c = _march_pts(st, o, d, t_cand)
    vox_c = world_to_voxel(pts_c, bbox, st.resolution)
    flat_c = (
        vox_c[..., 0] * st.resolution + vox_c[..., 1]
    ) * st.resolution + vox_c[..., 2]
    occ_c = (grid_flat[flat_c] > 0) & cand
    n_occ = occ_c.sum(-1).to(torch.int32)

    if st.compact:
        valid, t_sel, flat_sel = _rank_compact(occ_c, st.k_sel, t_cand, flat_c)
    else:
        valid, t_sel, flat_sel = occ_c, t_cand, flat_c
    dist = step_r * sqrt_rn(dd)
    return t_sel, valid, flat_sel.to(torch.int32), n_occ, n_blk, dist


def _viewdirs(d: torch.Tensor) -> torch.Tensor:
    """``d / max(‖d‖, 1e-12)``: zero padding rays stay finite."""
    norm = norm3_rn(d, keepdim=True)
    return d / torch.clamp_min(norm, 1e-12)


def march_full_plain(st: FusedStatics, spec: FusedSpec, xyz_encoder,
                     dir_encoder, k_tile: int, rays: torch.Tensor,
                     grid_flat: torch.Tensor, coarse_flat: torch.Tensor,
                     bbox: torch.Tensor, flat_ws: list[torch.Tensor],
                     return_needed: bool = False):
    """K5's function in PyTorch: ``(rgb [B, 3], depth [B], acc [B],
    still_alive [B] bool, n_occ [B] i32, n_blk [B] i32)``.

    The MLP runs on the valid slots only: an invalid slot has τ = 0 and so
    weight exactly 0, whatever the network says there. Compositing keeps
    the JAX tile structure (within-tile cumsum, sequential tile carry), so
    the sums happen in the same order. With ``return_needed`` it also
    returns the number of samples whose MLP result the composite needs
    (valid, with transmittance still at or above the threshold)."""
    f32 = torch.float32
    t_sel, valid, _flat, n_occ, n_blk, dist = dda_block_plain(
        st, rays, grid_flat, coarse_flat, bbox
    )
    b, k = t_sel.shape
    o, d = rays[:, 0:3], rays[:, 3:6]
    k_pad = _rup(k, k_tile)
    if k_pad != k:
        t_sel = _pad_cols(t_sel, k_pad)
        valid = _pad_cols(valid, k_pad)

    d_enc = _pad_cols(dir_encoder(_viewdirs(d)).to(f32), spec.c_views_pad)
    rows_b, rows_k = torch.nonzero(valid, as_tuple=True)
    pts = o[rows_b] + d[rows_b] * t_sel[rows_b, rows_k][:, None]
    x = _pad_cols(xyz_encoder(pts).to(f32), spec.c_in_pad)
    raw = forward_tile(spec, x, d_enc[rows_b], flat_ws)
    sigma = torch.zeros((b, k_pad), dtype=f32, device=rays.device)
    rgb = torch.zeros((b, k_pad, 3), dtype=f32, device=rays.device)
    sigma[rows_b, rows_k] = torch.relu(raw[:, 3])
    rgb[rows_b, rows_k] = torch.sigmoid(raw[:, :3])

    n_tiles = k_pad // k_tile
    tau = (sigma * dist[:, None]).reshape(b, n_tiles, k_tile)
    cj = torch.cumsum(tau, -1)
    incl = torch.cumsum(cj[..., -1], -1)  # sequential carry over tiles
    c_prev = torch.cat([incl.new_zeros((b, 1)), incl[:, :-1]], -1)
    trans = torch.exp(-(c_prev[..., None] + (cj - tau)))
    alpha = 1.0 - torch.exp(-tau)
    w = trans * alpha * (trans >= st.threshold).to(f32)
    rgb_t = rgb.reshape(b, n_tiles, k_tile, 3)
    t_t = t_sel.reshape(b, n_tiles, k_tile)
    rgb_acc = torch.cumsum((w[..., None] * rgb_t).sum(-2), 1)[:, -1]
    depth_acc = torch.cumsum((w * t_t).sum(-1), 1)[:, -1]
    acc_acc = torch.cumsum(w.sum(-1), 1)[:, -1]
    if st.white_bkgd:
        rgb_acc = rgb_acc + (1.0 - acc_acc[..., None])
    still_alive = torch.exp(-incl[:, -1]) >= st.threshold
    out = (rgb_acc, depth_acc, acc_acc, still_alive, n_occ, n_blk)
    if return_needed:
        needed = valid.reshape(b, n_tiles, k_tile) & (trans >= st.threshold)
        return out + (int(needed.sum()),)
    return out


# -- kernels -------------------------------------------------------------------


class MarchStaticsC(ctypes.Structure):
    """``struct MarchStatics`` of ``csrc/dda.cuh`` (passed by pointer)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "resolution", "rc", "factor", "r", "s_c", "k_c", "n_steps", "k_sel",
        "compact", "clip")] + [(name, ctypes.c_float) for name in (
            "step", "t_near", "t_far", "threshold")] + [
        ("white_bkgd", ctypes.c_int), ("k_tile", ctypes.c_int)]


def _statics_c(st: FusedStatics, k_tile: int = 1) -> MarchStaticsC:
    return MarchStaticsC(
        st.resolution, st.rc, st.factor, st.r, st.s_c, st.k_c, st.n_steps,
        st.k_sel, int(st.compact), int(st.clip), st.step, st.near, st.far,
        st.threshold, int(st.white_bkgd), int(k_tile),
    )


def _check_inputs(st: FusedStatics, rays, grid_flat, coarse_flat, bbox):
    dev = rays.device
    for name, t, dtype, shape in (
        ("rays", rays, torch.float32, (rays.shape[0], 6)),
        ("grid", grid_flat, torch.int8, (st.resolution ** 3,)),
        ("coarse grid", coarse_flat, torch.int8, (st.rc ** 3,)),
        ("bbox", bbox, torch.float32, (2, 3)),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, rays on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def dda_block(st: FusedStatics, rays: torch.Tensor, grid_flat: torch.Tensor,
              coarse_flat: torch.Tensor, bbox: torch.Tensor):
    """K4: the plain version for CPU tensors, the CUDA kernel
    (``csrc/fused_dda.cu``) for CUDA tensors. Same outputs as
    :func:`dda_block_plain`."""
    _check_inputs(st, rays, grid_flat, coarse_flat, bbox)
    if rays.device.type == "cpu":
        return dda_block_plain(st, rays, grid_flat, coarse_flat, bbox)
    if rays.device.type != "cuda":
        raise ValueError(f"unsupported device {rays.device}")
    from .kernels import load

    lib = load("fused_dda")
    n, k, dev = rays.shape[0], st.k_sel, rays.device
    t_sel = torch.empty((n, k), dtype=torch.float32, device=dev)
    valid = torch.empty((n, k), dtype=torch.bool, device=dev)
    flat_sel = torch.empty((n, k), dtype=torch.int32, device=dev)
    n_occ = torch.empty((n,), dtype=torch.int32, device=dev)
    n_blk = torch.empty((n,), dtype=torch.int32, device=dev)
    dist = torch.empty((n,), dtype=torch.float32, device=dev)
    stc = _statics_c(st)
    err = lib.nrt_fused_dda(
        _ptr(rays), n, _ptr(grid_flat), _ptr(coarse_flat), _ptr(bbox),
        ctypes.byref(stc), _ptr(t_sel), _ptr(valid), _ptr(flat_sel),
        _ptr(n_occ), _ptr(n_blk), _ptr(dist), _stream(dev),
    )
    _raise_on(lib, err, "fused_dda_gather (K4)")
    LAUNCHES["fused_dda_gather"] += 1
    return t_sel, valid, flat_sel, n_occ, n_blk, dist


class FusedWeights:
    """One branch's weights in the fused kernels' form: the canonical flat
    list (plain version) and the chain's three packed buffers (CUDA kernel;
    :func:`~.fused_mlp.pack_for_chain`), packed once per engine load."""

    def __init__(self, spec: FusedSpec, branch):
        self.spec = spec
        with torch.no_grad():  # serving weights: no autograd history
            self.flat = spec.flatten_params(branch)
            self.wmat, self.bias, self.heads = pack_for_chain(spec, self.flat)

    @torch.no_grad()
    def refresh(self, branch) -> None:
        """Repack ``branch``'s current weights into these buffers in place,
        on their device (a captured route that reads them sees the new
        weights: the serving engine's scene switch)."""
        for dst, src in zip(self.flat, self.spec.flatten_params(branch)):
            dst.copy_(src)
        for dst, src in zip((self.wmat, self.bias, self.heads),
                            pack_for_chain(self.spec, self.flat)):
            dst.copy_(src)


def _encoder_bands(enc, width: int) -> int:
    """Band count of a frequency encoder the kernel can reproduce
    (include_input, bands 2^0..2^(L-1), padded width ≤ ``width``)."""
    n = int(enc.n_freqs)
    bands = [float(b) for b in enc.freq_bands]
    if not enc.include_input or bands != [2.0 ** i for i in range(n)]:
        raise ValueError("the fused kernel encodes log-sampled frequency "
                         "bands 2^0..2^(L-1) with the input included")
    if enc.out_dim > width:
        raise ValueError(f"encoder width {enc.out_dim} > padded {width}")
    return n


def march_full_block(st: FusedStatics, weights: FusedWeights, xyz_encoder,
                     dir_encoder, k_tile: int, rays: torch.Tensor,
                     grid_flat: torch.Tensor, coarse_flat: torch.Tensor,
                     bbox: torch.Tensor):
    """K5: the plain version for CPU tensors, the CUDA kernel
    (``csrc/fused_march_full.cu``) for CUDA tensors. Same outputs as
    :func:`march_full_plain`."""
    _check_inputs(st, rays, grid_flat, coarse_flat, bbox)
    spec = weights.spec
    if rays.device.type == "cpu":
        return march_full_plain(st, spec, xyz_encoder, dir_encoder, k_tile,
                                rays, grid_flat, coarse_flat, bbox,
                                weights.flat)
    if rays.device.type != "cuda":
        raise ValueError(f"unsupported device {rays.device}")
    if spec.W % 64 or spec.W > 256 or spec.c_in_pad > 64 or \
            spec.c_views_pad > 32 or not 1 <= spec.D <= 24:
        raise ValueError(
            f"the fused march kernel takes W a multiple of 64 up to 256, "
            f"padded encodings ≤ 64/32 wide and 1 ≤ D ≤ 24, got W={spec.W}, "
            f"c_in_pad={spec.c_in_pad}, c_views_pad={spec.c_views_pad}, "
            f"D={spec.D}"
        )
    bf16 = spec.compute_dtype == torch.bfloat16
    if not bf16 and spec.compute_dtype != torch.float32:
        raise TypeError(f"compute dtype {spec.compute_dtype} (f32 or bf16)")
    for name, t in (("weights", weights.wmat), ("biases", weights.bias),
                    ("heads", weights.heads)):
        if t.device != rays.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {rays.device}")
    if weights.wmat.dtype != spec.compute_dtype or \
            weights.bias.dtype != torch.float32 or \
            weights.heads.dtype != torch.float32:
        raise TypeError("packed weight buffers have the wrong dtype")
    from .kernels import load

    lib = load("fused_march_full")
    desc = MlpDescC(spec.D, spec.W, -1 if spec.skip is None else spec.skip,
                    spec.c_in_pad, spec.c_views_pad,
                    _encoder_bands(xyz_encoder, spec.c_in_pad),
                    _encoder_bands(dir_encoder, spec.c_views_pad))
    n, dev = rays.shape[0], rays.device
    rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((n,), dtype=torch.float32, device=dev)
    acc = torch.empty((n,), dtype=torch.float32, device=dev)
    alive = torch.empty((n,), dtype=torch.bool, device=dev)
    n_occ = torch.empty((n,), dtype=torch.int32, device=dev)
    n_blk = torch.empty((n,), dtype=torch.int32, device=dev)
    stc = _statics_c(st, k_tile)
    err = lib.nrt_fused_march_full(
        _ptr(rays), n, _ptr(grid_flat), _ptr(coarse_flat), _ptr(bbox),
        ctypes.byref(stc), ctypes.byref(desc), _ptr(weights.wmat),
        _ptr(weights.bias), int(bf16), _ptr(weights.heads), _ptr(rgb),
        _ptr(depth), _ptr(acc),
        _ptr(alive), _ptr(n_occ), _ptr(n_blk), _stream(dev),
    )
    _raise_on(lib, err, "fused_march_full (K5)")
    LAUNCHES["fused_march_full"] += 1
    return rgb, depth, acc, alive, n_occ, n_blk


# -- renderers -----------------------------------------------------------------


def _prepare(rays, near, far, grid, bbox, options):
    if rays.shape[-1] > 6:
        raise ValueError(
            "the fused march only supports static [N, 6] rays, got "
            f"{rays.shape[-1]} columns"
        )
    grid_i8 = grid.to(torch.int8)
    coarse = coarse_from_grid(grid_i8 > 0, PYRAMID_FACTORS[-1])
    st = _statics_for(grid.shape[0], coarse.shape[0], near, far, options)
    return (st, rays.to(torch.float32).contiguous(),
            grid_i8.reshape(-1).contiguous(),
            coarse.to(torch.int8).reshape(-1).contiguous(),
            bbox.to(torch.float32).contiguous())


def fused_dda_gather(rays, near: float, far: float, grid, bbox,
                     options) -> dict:
    """Stage (a) traversal: ``{t_sel [N, K], valid [N, K] bool, flat_sel
    [N, K] i32, n_occ [N], n_blk [N], dist [N], "statics"}``."""
    st, rays, grid_flat, coarse_flat, bbox = _prepare(
        rays, near, far, grid, bbox, options
    )
    t_sel, valid, flat_sel, n_occ, n_blk, dist = dda_block(
        st, rays, grid_flat, coarse_flat, bbox
    )
    return {"t_sel": t_sel, "valid": valid, "flat_sel": flat_sel,
            "n_occ": n_occ, "n_blk": n_blk, "dist": dist, "statics": st}


def _march_stats(st: FusedStatics, n_rays: int, n_occ, n_blk,
                 chunk: int | None = None) -> dict:
    """Traversal telemetry shared by both stages (packed-march keys).
    With ``chunk`` each value is a ``[n_rays // chunk]`` tensor with one
    entry per chunk, as the JAX engine's per-chunk executables report."""
    if chunk is not None:
        n_occ = n_occ.reshape(-1, chunk)
        n_blk = n_blk.reshape(-1, chunk)
        n_rays = chunk
    n_occ = n_occ.to(torch.int64)
    total_occ = n_occ.sum(-1)
    dropped = torch.clamp_min(n_occ - st.k_sel, 0).sum(-1)
    return {
        "overflow_frac": (
            dropped.to(torch.float32)
            / torch.clamp_min(total_occ, 1).to(torch.float32)
        ),
        "march_candidates": torch.full_like(
            total_occ, n_rays * st.c_total, dtype=torch.float32
        ),
        "march_samples_out": total_occ.to(torch.float32),
        "march_coarse_occ": (
            n_blk.to(torch.int64).sum(-1).to(torch.float32)
            / float(n_rays * st.s_c)
        ),
    }


def march_rays_fused(apply_fn, rays, near: float, far: float, grid, bbox,
                     options) -> dict:
    """Stage (a) renderer: K4 traversal → MLP on the valid slots →
    per-ray log-space compositing with ERT. ``apply_fn(pts [R, 1, 3],
    viewdirs [R, 3], model) -> raw [R, 1, 4]``."""
    dda = fused_dda_gather(rays, near, far, grid, bbox, options)
    st: FusedStatics = dda["statics"]
    t_sel, valid, dist = dda["t_sel"], dda["valid"], dda["dist"]
    rays = rays.to(torch.float32)
    n, k = t_sel.shape
    o, d = rays[:, 0:3], rays[:, 3:6]
    viewdirs = _viewdirs(d)
    rows_b, rows_k = torch.nonzero(valid, as_tuple=True)
    pts = o[rows_b] + d[rows_b] * t_sel[rows_b, rows_k][:, None]
    raw = apply_fn(pts[:, None, :], viewdirs[rows_b], "fine")[:, 0, :]
    f32 = torch.float32
    sigma = torch.zeros((n, k), dtype=f32, device=rays.device)
    rgb = torch.zeros((n, k, 3), dtype=f32, device=rays.device)
    sigma[rows_b, rows_k] = torch.relu(raw[:, 3].to(f32))
    rgb[rows_b, rows_k] = torch.sigmoid(raw[:, :3].to(f32))

    tau = sigma * dist[:, None]
    c = torch.cumsum(tau, -1)
    trans = torch.exp(-(c - tau))
    alpha = 1.0 - torch.exp(-tau)
    weights = trans * alpha * (trans >= st.threshold).to(f32)
    rgb_map = (weights[..., None] * rgb).sum(-2)
    depth_map = (weights * t_sel).sum(-1)
    acc_map = weights.sum(-1)
    if st.white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    still_alive = torch.exp(-c[:, -1]) >= st.threshold
    lost = (dda["n_occ"] > st.k_sel) | (dda["n_blk"] > st.k_c)
    out = {
        "rgb_map_f": rgb_map,
        "depth_map_f": depth_map,
        "acc_map_f": acc_map,
        "truncated": lost & still_alive,
    }
    out.update(_march_stats(st, n, dda["n_occ"], dda["n_blk"]))
    return out


def march_rays_fused_full(weights: FusedWeights, xyz_encoder, dir_encoder,
                          rays, near: float, far: float, grid, bbox, options,
                          k_tile: int | None = None,
                          stats_chunk: int | None = None) -> dict:
    """Stage (b) renderer: the whole march in one K5 launch (forward only).
    ``k_tile`` defaults to the JAX package's tile for one
    ``march_chunk_size`` chunk; ``stats_chunk`` reports the traversal
    stats per chunk of that many rays."""
    st, rays, grid_flat, coarse_flat, bbox = _prepare(
        rays, near, far, grid, bbox, options
    )
    kt = int(k_tile) if k_tile else compositing_tile(
        options, min(int(options.chunk_size), rays.shape[0])
    )
    rgb, depth, acc, alive, n_occ, n_blk = march_full_block(
        st, weights, xyz_encoder, dir_encoder, kt, rays, grid_flat,
        coarse_flat, bbox,
    )
    lost = (n_occ > st.k_sel) | (n_blk > st.k_c)
    out = {
        "rgb_map_f": rgb,
        "depth_map_f": depth,
        "acc_map_f": acc,
        "truncated": lost & alive,
    }
    out.update(_march_stats(st, rays.shape[0], n_occ, n_blk, stats_chunk))
    return out
