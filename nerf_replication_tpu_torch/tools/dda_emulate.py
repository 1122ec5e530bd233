"""K4's warp traversal (``csrc/fused_dda.cu``) emulated in PyTorch, with
the work it does counted.

:func:`emulate_k4` follows the kernel step by step, vectorized over rays:
a coarse block is decided from its first position's parent cell and the
next block's (the exact shortcut: every axis's voxel id is monotone in the
march step), else from all its other positions' cells; blocks and
candidates take their ranks from 32-bit ballot words and prefix popcounts,
pass by pass, as the warp does; padding and the valid row come last. Its
outputs equal :func:`~..ops.fused_march.dda_block_plain`'s bit for bit
(``tests/test_torch_dda_kernels.py``), which is what makes the shortcut and
the compaction safe to run on the card.

It also counts what the kernels do on given inputs: the positions phase A
evaluates (the warp kernel with its shortcut, and the earlier CTA traversal
``dda_cta``, which walks each block until its first occupied position) and
the 32-byte sectors each kernel's stores touch. A count from this module is
a count, not a device measurement."""

from __future__ import annotations

import torch

from ..ops.fused_march import FusedStatics, _march_pts, _march_t
from ..renderer.occupancy import world_to_voxel
from ..utils.numerics import sq_norm3, sqrt_rn

LANES = 32
SECTOR = 32


def popc(w: torch.Tensor) -> torch.Tensor:
    """Population count of 32-bit words held in int64 (``__popc``)."""
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return ((w * 0x01010101) & 0xFFFFFFFF) >> 24


def ballot_ranks(bits: torch.Tensor):
    """``bits [B, L]`` bool, taken 32 a pass as a warp does: each set bit's
    rank in march order (a running popcount of the earlier passes' ballot
    words plus ``__popc(word & lanemask_lt)``), the total count and each
    pass's count ``[B, passes]``."""
    b, n = bits.shape
    passes = -(-n // LANES)
    padded = torch.zeros((b, passes * LANES), dtype=torch.int64)
    padded[:, :n] = bits.to(torch.int64)
    lane = torch.arange(LANES, dtype=torch.int64)
    words = (padded.view(b, passes, LANES) << lane).sum(-1)  # __ballot_sync
    counts = popc(words)
    before = torch.cumsum(counts, -1) - counts
    lt = (torch.ones((), dtype=torch.int64) << lane) - 1  # lanemask_lt
    within = popc(words[..., None] & lt)
    rank = (before[..., None] + within).view(b, passes * LANES)[:, :n]
    return rank, counts.sum(-1), counts


def _setup(st: FusedStatics, rays: torch.Tensor, bbox: torch.Tensor):
    """ray_setup: (o, d, t0, step_r, dd, live), as the plain version forms
    them."""
    f32 = torch.float32
    o, d = rays[:, 0:3], rays[:, 3:6]
    b = rays.shape[0]
    near = torch.tensor(st.near, dtype=f32)
    far = torch.tensor(st.far, dtype=f32)
    dd = sq_norm3(d)
    if st.clip:
        tiny = torch.tensor(1e-12, dtype=f32)
        inv = 1.0 / torch.where(d.abs() < tiny, tiny, d)
        t_lo = (bbox[0] - o) * inv
        t_hi = (bbox[1] - o) * inv
        tmin = torch.minimum(t_lo, t_hi).amax(-1)
        tmax = torch.maximum(t_lo, t_hi).amin(-1)
        t0 = torch.minimum(torch.maximum(tmin, near), far)
        t1 = torch.maximum(torch.minimum(torch.maximum(tmax, near), far), t0)
        step_r = (t1 - t0) * (1.0 / torch.tensor(float(st.n_steps), dtype=f32))
        live = (dd > 0.0) & (step_r > 0.0)
    else:
        t0 = near.expand(b)
        step_r = torch.tensor(st.step, dtype=f32).expand(b)
        live = dd > 0.0
    return o, d, t0, step_r, dd, live


def _voxels(st, o, d, t0, step_r, bbox, s: torch.Tensor):
    """(t, fine voxel ids [.., 3]) of march steps ``s [B, M]``."""
    t = _march_t(s.to(torch.float32), step_r, t0)
    return t, world_to_voxel(_march_pts(st, o, d, t), bbox, st.resolution)


def _block_decisions(st, coarse_flat, cells):
    """Phase A per (ray, block): (occupied [B, S_c], positions the warp
    kernel evaluates per live ray [B], positions dda_cta evaluates [B, S_c]).
    ``cells [B, S_pad + 1, 3]``: the parent cell of every padded position
    and of the one after the last block."""
    rc, r = st.rc, st.r
    blk = torch.arange(st.s_c)
    s0 = blk * r
    s1 = torch.clamp(s0 + r, max=st.n_steps) - 1  # >= s0: s_c = ceil(S / r)
    flat = (cells[..., 0] * rc + cells[..., 1]) * rc + cells[..., 2]
    occ_pos = coarse_flat[flat] > 0  # [B, S_pad + 1]
    j = torch.arange(r)
    pos = s0[:, None] + j[None, :]  # [S_c, r]
    occ_blk = occ_pos[:, pos] & (pos <= s1[:, None])  # [B, S_c, r]
    n_in = (s1 - s0 + 1)[None, :]

    # dda_cta: positions s0, s0 + 1, ... until the first occupied one
    first = torch.where(occ_blk, j, r).min(-1).values  # r when none
    cta_evals = torch.where(first < r, first + 1, n_in)

    # the warp kernel: the first cell of every block and of block S_c (lane
    # 0 evaluates once more the first block after each group of passes)
    group = 32 * 4  # K4_GROUP passes of 32
    firsts = (st.s_c + 1) + len(range(group, st.s_c + 1, group))
    hit = occ_pos[:, s0]
    ka, kn = cells[:, s0], cells[:, s0 + r]
    box = ((ka - kn).abs() + 1).prod(-1)
    hit_n = occ_pos[:, s0 + r]
    open_ = ~hit & (box > 1) & ((box > 2) | hit_n)
    # an open block evaluates its other positions, all at once
    occ = hit | (open_ & (occ_blk & (j > 0)).any(-1))
    evals = firsts + (open_ * (n_in - 1)).sum(-1)
    return occ, evals, cta_evals


def emulate_k4(st: FusedStatics, rays: torch.Tensor,
               grid_flat: torch.Tensor, coarse_flat: torch.Tensor,
               bbox: torch.Tensor):
    """K4's warp traversal on CPU tensors: ``(outputs, counts)``, outputs as
    :func:`~..ops.fused_march.dda_block_plain` returns them; ``counts``:
    ``rays_live`` (real rays with a non-empty span), ``positions`` (phase A,
    the warp kernel), ``positions_cta`` (phase A, ``dda_cta``),
    ``candidates`` (phase C positions), ``sectors`` and
    ``sectors_cta`` (32-byte sectors the two kernels' stores touch) and
    ``sectors_min`` (the outputs' bytes / 32)."""
    f32 = torch.float32
    b = rays.shape[0]
    o, d, t0, step_r, dd, live = _setup(st, rays, bbox)
    r, K = st.r, st.k_sel

    # A. coarse blocks: each position's parent cell, then the decision
    s_pad = st.s_c * r + 1
    _, vox = _voxels(st, o, d, t0, step_r, bbox,
                     torch.arange(s_pad).expand(b, s_pad))
    occ, evals, cta_evals = _block_decisions(st, coarse_flat,
                                             vox // st.factor)
    occ &= live[:, None]
    rank, n_blk, _ = ballot_ranks(occ)
    n_kept = torch.clamp(n_blk, max=st.k_c)
    # kept[rank] = blk for the first K_c (the rest go to a dump column)
    dest = torch.where(occ & (rank < st.k_c), rank,
                       torch.full_like(rank, st.k_c))
    kept = torch.zeros((b, st.k_c + 1), dtype=torch.int64).scatter_(
        1, dest, torch.arange(st.s_c).expand(b, -1).contiguous())[:, :st.k_c]

    # C. candidates of the kept blocks
    idx = torch.arange(st.c_total)
    i, j = idx // r, idx % r
    is_kept = i[None, :] < n_kept[:, None]
    s = torch.where(is_kept, kept[:, i], 0) * r + j[None, :]
    t, vox_c = _voxels(st, o, d, t0, step_r, bbox, s)
    R = st.resolution
    flat = (vox_c[..., 0] * R + vox_c[..., 1]) * R + vox_c[..., 2]
    cand = is_kept & (s < st.n_steps)
    occ_c = (grid_flat[flat] > 0) & cand
    slot, n_occ, pass_occ = ballot_ranks(occ_c)
    if st.compact:
        take = occ_c & (slot < K)
        dest = torch.where(take, slot, torch.full_like(slot, K))
        t_sel = torch.zeros((b, K + 1), dtype=f32).scatter_(
            1, dest, torch.where(take, t, torch.zeros_like(t)))[:, :K]
        flat_sel = torch.zeros((b, K + 1), dtype=torch.int64).scatter_(
            1, dest, torch.where(take, flat, torch.zeros_like(flat)))[:, :K]
        # D. padding is the zeros left; the valid row from n_emit
        n_emit = torch.clamp(n_occ, max=K)
        valid = torch.arange(K)[None, :] < n_emit[:, None]
        candidates = int((n_kept * r).sum())
    else:
        t_sel, flat_sel, valid = t, flat, occ_c
        candidates = b * st.c_total
    dist = step_r * sqrt_rn(dd)
    outs = (t_sel, valid, flat_sel.to(torch.int32), n_occ.to(torch.int32),
            n_blk.to(torch.int32), dist)
    counts = {
        "rays_live": int(live.sum()),
        "positions": int(evals[live].sum()),
        "positions_cta": int(cta_evals[live].sum()),
        "candidates": candidates,
        "sectors": store_sectors(st, pass_occ),
        "sectors_cta": 3 * b * K + 3 * -(-b * 4 // SECTOR),
        "sectors_min": -(-b * (K * 9 + 12) // SECTOR),
    }
    return outs, counts


def _span_sectors(start: torch.Tensor, nbytes: torch.Tensor) -> torch.Tensor:
    """Sectors one store instruction touches writing ``nbytes`` contiguous
    bytes from byte ``start`` (0 where nothing is written)."""
    last = start + nbytes - 1
    return torch.where(nbytes > 0, last // SECTOR - start // SECTOR + 1, 0)


def store_sectors(st: FusedStatics, pass_occ: torch.Tensor) -> int:
    """32-byte sectors the warp kernel's stores touch (t, voxel, valid rows
    and the per-ray counts), instruction by instruction, for K a multiple
    of 4 (the valid row as packed words); ``pass_occ [B, passes]``: the
    occupied candidates of each of phase C's passes."""
    b, K = pass_occ.shape[0], st.k_sel
    row4 = torch.arange(b, dtype=torch.int64) * K * 4  # t / voxel rows
    row1 = torch.arange(b, dtype=torch.int64) * K  # valid rows
    total = torch.zeros((), dtype=torch.int64)
    if not st.compact:
        for base in range(0, K, LANES):
            m = min(LANES, K - base)
            total += 2 * _span_sectors(row4 + 4 * base,
                                       torch.full_like(row4, 4 * m)).sum()
            total += _span_sectors(row1 + base, torch.full_like(row1, m)).sum()
    else:
        # C: each pass stores its occupied candidates' consecutive slots
        before = torch.cumsum(pass_occ, -1) - pass_occ
        for p in range(pass_occ.shape[1]):
            lo = torch.clamp(before[:, p], max=K)
            m = torch.clamp(before[:, p] + pass_occ[:, p], max=K) - lo
            total += 2 * _span_sectors(row4 + 4 * lo, 4 * m).sum()
        n_emit = torch.clamp(pass_occ.sum(-1), max=K)
        # D: the padding, 32 slots a pass
        for q in range(0, K, LANES):
            lo = torch.clamp(n_emit + q, max=K)
            m = torch.clamp(n_emit + q + LANES, max=K) - lo
            total += 2 * _span_sectors(row4 + 4 * lo, 4 * m).sum()
        for w0 in range(0, K // 4, LANES):  # the valid row, packed words
            m = min(LANES, K // 4 - w0)
            total += _span_sectors(row1 + 4 * w0,
                                   torch.full_like(row1, 4 * m)).sum()
    return int(total) + 3 * b  # n_occ, n_blk, dist: one lane a ray
