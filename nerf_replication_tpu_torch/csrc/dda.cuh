// The coarse-DDA traversal shared by the fused-march kernels: the exact
// position -> voxel helpers (ray_setup, march_t, voxel_axis, voxel_at,
// sq_norm_rn, ray_dist), run by both K4 (fused_dda.cu, a warp a ray) and K5
// (fused_march_full.cu), and the CTA traversal dda_cta, which only K5 runs.
//
// Replaces the TPU block body `_dda_block` (nerf_replication_tpu/ops/
// fused_march.py:150), which expresses compaction as a one-hot
// rank-compare (`_rank_compact` :129) because Mosaic has no scatter. On
// Hopper dda_cta tests all (ray, block) and (ray, candidate) pairs of a CTA
// in parallel into shared-memory bit masks, and one thread per ray turns the
// masks into slots in march order; the semantics, which K4's warp traversal
// keeps too:
//   * a coarse block is occupied when any of its in-range positions
//     (s < n_steps) has an occupied PARENT pyramid cell (fine voxel / factor),
//     and only for real rays (|d|^2 > 0; zero rays are bucket padding);
//   * the first K_c occupied blocks in march order are kept;
//   * their r candidates each are masked by s < n_steps and gathered in the
//     fine grid; with K < K_c*r the first K occupied ones fill slots 0..K-1
//     (unfilled slots: t = 0, voxel 0, invalid); with K = K_c*r every
//     candidate keeps its slot i*r + j, and an unfilled kept slot i marches
//     from block 0 (the one-hot sum of an empty row), invalid;
//   * n_occ counts every occupied candidate, n_blk every occupied block.
//
// Exactness: voxel ids must equal the plain version's (and the JAX
// package's), so every float operation of the position -> voxel chain is an
// explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __fmaf_rn),
// which nvcc never contracts or reorders: t = fma(s, step_r, t0),
// p = o + d * t (multiply, then add; one fma with clip_bbox, whose per-ray t
// XLA contracts into the product), u = (clip(p, lo, hi) - lo) / (hi - lo),
// i = clamp(floor(u * R), 0, R - 1); with clip_bbox, step_r = (t1 - t0) *
// (1 / S), XLA's rewrite of the division. Each of these operations is
// correctly rounded and monotone in its argument, so every axis's voxel id
// (and its parent cell) is monotone in the step s along a ray: K4's
// coarse-block shortcut rests on that (tests/test_torch_dda_kernels.py).
//
// dda_cta touches 2 MiB + 32 KiB of int8 grid (L2 resident) and does
// ~(S + K_c*r) * 30 float ops per ray. The voxel arithmetic is
// latency-bound per ray (three IEEE divisions per position), so it is
// spread over all the CTA's threads; only bits stay in shared memory, no
// [N, K_c*r] intermediate reaches global memory.
#pragma once

#include "common.cuh"

struct RayGeom {
  float o[3];
  float d[3];
  float t0;      // first march position
  float step_r;  // march step of this ray
  float dd;      // |d|^2 (sq_norm_rn)
  bool live;     // real ray with a non-empty span
};

// |d|^2 summed left to right, every product and sum rounded
__device__ __forceinline__ float sq_norm_rn(const float d[3]) {
  return __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                   __fmul_rn(d[2], d[2]));
}

__device__ __forceinline__ RayGeom ray_setup(const float* ray,
                                             const float bb[6],
                                             const MarchStatics& st) {
  RayGeom g;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g.o[c] = ray[c];
    g.d[c] = ray[3 + c];
  }
  g.dd = sq_norm_rn(g.d);
  bool span_ok = true;
  if (st.clip) {
    // slab spans, as packed_march._ray_bbox_spans
    float tmin = -INFINITY, tmax = INFINITY;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float dc = fabsf(g.d[c]) < 1e-12f ? 1e-12f : g.d[c];
      const float inv = __fdiv_rn(1.0f, dc);
      const float tl = __fmul_rn(__fsub_rn(bb[c], g.o[c]), inv);
      const float th = __fmul_rn(__fsub_rn(bb[3 + c], g.o[c]), inv);
      tmin = fmaxf(tmin, fminf(tl, th));
      tmax = fminf(tmax, fmaxf(tl, th));
    }
    const float t0 = fminf(fmaxf(tmin, st.t_near), st.t_far);
    const float t1 = fmaxf(fminf(fmaxf(tmax, st.t_near), st.t_far), t0);
    g.t0 = t0;
    // (t1 - t0) / S as XLA evaluates it: times the float32 reciprocal of S
    g.step_r = __fmul_rn(__fsub_rn(t1, t0),
                         __fdiv_rn(1.0f, static_cast<float>(st.n_steps)));
    span_ok = g.step_r > 0.0f;
  } else {
    g.t0 = st.t_near;
    g.step_r = st.step;
  }
  g.live = (g.dd > 0.0f) && span_ok;
  return g;
}

// per-sample quadrature width: step_r * |d|
__device__ __forceinline__ float ray_dist(const RayGeom& g) {
  return __fmul_rn(g.step_r, __fsqrt_rn(g.dd));
}

// march position t0 + s * step_r as one fused multiply-add (the plain
// version's _march_t; XLA contracts the JAX expression the same way)
__device__ __forceinline__ float march_t(const RayGeom& g, int s) {
  return __fmaf_rn(static_cast<float>(s), g.step_r, g.t0);
}

__device__ __forceinline__ int voxel_axis(float p, float lo, float hi,
                                          int res) {
  const float c = fminf(fmaxf(p, lo), hi);
  const float u = __fdiv_rn(__fsub_rn(c, lo), __fsub_rn(hi, lo));
  const int i = static_cast<int>(floorf(__fmul_rn(u, static_cast<float>(res))));
  return min(max(i, 0), res - 1);
}

// voxel ids of o + d * t on a res^3 grid: multiply, then add — or, with
// `fused` (march_clip_bbox, where XLA contracts the JAX expression for a
// per-ray t), one fused multiply-add
__device__ __forceinline__ void voxel_at(const RayGeom& g, float t,
                                         const float bb[6], int res,
                                         bool fused, int v[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float p = fused ? __fmaf_rn(g.d[c], t, g.o[c])
                          : __fadd_rn(g.o[c], __fmul_rn(g.d[c], t));
    v[c] = voxel_axis(p, bb[c], bb[3 + c], res);
  }
}

// Shared-memory scratch of one CTA's traversal (dda_carve lays it out).
struct DdaShared {
  RayGeom* geo;        // [nrays]
  unsigned* blk_bits;  // [nrays][bw]  occupied coarse blocks
  unsigned* cand_bits; // [nrays][cw]  occupied candidates
  int* n_kept;         // [nrays]      kept blocks (<= K_c)
  short* kept;         // [nrays][K_c] kept block indices, march order
  int bw, cw;
};

__host__ __device__ inline size_t dda_smem_bytes(int nrays,
                                                 const MarchStatics& st) {
  const int bw = (st.s_c + 31) / 32, c = st.k_c * st.r, cw = (c + 31) / 32;
  size_t b = static_cast<size_t>(nrays) * sizeof(RayGeom);
  b += static_cast<size_t>(nrays) * (bw + cw + 1) * 4;
  b += static_cast<size_t>(nrays) * st.k_c * 2;
  return (b + 15) / 16 * 16;
}

__device__ inline DdaShared dda_carve(unsigned char* base, int nrays,
                                      const MarchStatics& st) {
  DdaShared sh;
  const int c = st.k_c * st.r;
  sh.bw = (st.s_c + 31) / 32;
  sh.cw = (c + 31) / 32;
  sh.geo = reinterpret_cast<RayGeom*>(base);
  sh.blk_bits = reinterpret_cast<unsigned*>(sh.geo + nrays);
  sh.cand_bits = sh.blk_bits + nrays * sh.bw;
  sh.n_kept = reinterpret_cast<int*>(sh.cand_bits + nrays * sh.cw);
  sh.kept = reinterpret_cast<short*>(sh.n_kept + nrays);
  return sh;
}

// The traversal of the `nrays` rays starting at `rays` (global [.., 6]) by
// the whole CTA; every thread calls it (it holds barriers). Thread r < nrays
// then owns ray r: its sink received ray r's K slots (in slot order when
// compacting, in candidate order otherwise), and n_occ_out / n_blk_out hold
// its counts.
//   A. all threads: for every (ray, coarse block) pair, is any in-range
//      position's parent cell occupied? -> blk_bits;
//   B. one thread per ray: the first K_c occupied blocks in march order;
//   C. all threads: for every (ray, kept slot, fine step) candidate, the
//      fine voxel and its occupancy -> cand_bits;
//   D. one thread per ray: n_occ and the valid slots, in candidate order.
template <class Sink>
__device__ void dda_cta(const float* __restrict__ rays, int nrays,
                        const float bb[6], const int8_t* __restrict__ grid,
                        const int8_t* __restrict__ coarse,
                        const MarchStatics& st, const DdaShared& sh,
                        int& n_occ_out, int& n_blk_out, Sink& sink) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int R = st.resolution, rc = st.rc, fac = st.factor, r = st.r;
  const int c_total = st.k_c * r;
  if (tid < nrays) sh.geo[tid] = ray_setup(rays + 6 * tid, bb, st);
  // the masks of rays 0 .. nrays-1 (nrays may be below the carved count)
  for (int e = tid; e < nrays * sh.bw; e += nthr) sh.blk_bits[e] = 0u;
  for (int e = tid; e < nrays * sh.cw; e += nthr) sh.cand_bits[e] = 0u;
  __syncthreads();

  // A. coarse blocks
  for (int e = tid; e < nrays * st.s_c; e += nthr) {
    const int ray = e / st.s_c, blk = e - ray * st.s_c;
    const RayGeom& g = sh.geo[ray];
    if (!g.live) continue;
    for (int j = 0; j < r; ++j) {
      const int s = blk * r + j;
      if (s >= st.n_steps) break;
      int v[3];
      voxel_at(g, march_t(g, s), bb, R, st.clip != 0, v);
      if (coarse[((v[0] / fac) * rc + (v[1] / fac)) * rc + (v[2] / fac)] > 0) {
        atomicOr(&sh.blk_bits[ray * sh.bw + (blk >> 5)], 1u << (blk & 31));
        break;
      }
    }
  }
  __syncthreads();

  // B. kept blocks
  int n_blk = 0;
  if (tid < nrays) {
    int n_kept = 0;
    for (int w = 0; w < sh.bw; ++w) {
      unsigned m = sh.blk_bits[tid * sh.bw + w];
      n_blk += __popc(m);
      while (m && n_kept < st.k_c) {
        const int b = __ffs(m) - 1;
        m &= m - 1;
        sh.kept[tid * st.k_c + n_kept++] = static_cast<short>(w * 32 + b);
      }
    }
    sh.n_kept[tid] = n_kept;
  }
  __syncthreads();

  // C. candidates of the kept blocks
  for (int e = tid; e < nrays * c_total; e += nthr) {
    const int ray = e / c_total, idx = e - ray * c_total;
    const int i = idx / r, j = idx - i * r;
    if (i >= sh.n_kept[ray]) continue;
    const RayGeom& g = sh.geo[ray];
    const int s_f = sh.kept[ray * st.k_c + i] * r + j;
    int v[3];
    voxel_at(g, march_t(g, s_f), bb, R, st.clip != 0, v);
    const int flat = (v[0] * R + v[1]) * R + v[2];
    if (s_f < st.n_steps && grid[flat] > 0)
      atomicOr(&sh.cand_bits[ray * sh.cw + (idx >> 5)], 1u << (idx & 31));
  }
  __syncthreads();

  // D. slots
  if (tid < nrays) {
    const RayGeom& g = sh.geo[tid];
    const unsigned* bits = sh.cand_bits + tid * sh.cw;
    int n_occ = 0;
    for (int w = 0; w < sh.cw; ++w) n_occ += __popc(bits[w]);
    int emitted = 0;
    for (int w = 0; w < sh.cw; ++w) {
      unsigned m = bits[w];
      while (m && (!st.compact || emitted < st.k_sel)) {
        const int idx = w * 32 + __ffs(m) - 1;
        const int i = idx / r;
        m &= m - 1;
        sink.emit(st.compact ? emitted : idx,
                  march_t(g, sh.kept[tid * st.k_c + i] * r + (idx - i * r)));
        ++emitted;
      }
    }
    n_occ_out = n_occ;
    n_blk_out = n_blk;
  }
}
