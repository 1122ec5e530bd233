// K4: fused DDA + fine gather (the `march_fused: gather` traversal).
//
// Replaces the TPU kernel `_dda_kernel` (nerf_replication_tpu/ops/
// fused_march.py:241, launched by `_dda_pallas` :255). On the TPU it never
// lowered (Mosaic rejects in-kernel gathers), so production ran its body
// through lax.map; gathers are native here.
//
// Bound on the card: bytes. The outputs are N * K * 9 B (t f32, valid u8,
// voxel i32) plus 12 B per ray; at 16384 rays and K = 192 that is ~28 MB,
// ~8.5 us at 3.35 TB/s. The grids (2 MiB + 32 KiB int8) stay in L2 and L1.
// What costs time instead is issue slots and latency: every march position
// takes three IEEE divisions (voxel_axis), and a ray's phases depend on each
// other. So one warp owns one ray, and every phase runs on all 32 lanes,
// with no CTA barrier (K5 keeps the CTA traversal dda_cta of dda.cuh):
//   A. lanes over coarse blocks, four passes of 32 at once (their
//      positions and lookups overlap): each lane decides its blocks (the
//      exact shortcut below), __ballot_sync gathers the block bits, and the
//      first K_c occupied blocks take their rank in march order from a
//      running popcount plus __popc(bits & lanemask_lt), into a per-warp
//      list in shared memory (the kernel's only shared memory);
//   C. lanes over the kept blocks' candidates: the exact voxel and its fine
//      occupancy; a ballot and the same prefix popcount give each occupied
//      candidate its slot, so the warp writes consecutive slots (coalesced);
//   D. the warp pads slots [min(n_occ, K), K) (t = 0, voxel 0) and writes
//      the valid row as packed words (16-byte stores for the padding
//      measured no faster).
// With K = K_c * r (uncompacted) C writes every candidate's slot itself.
//
// The shortcut is exact. Along a ray each axis's voxel id is monotone in the
// step s (dda.cuh), so every position of a block lies in the box of parent
// cells spanned by the cells of the block's first position and of the next
// block's first position (which the neighbouring lane evaluates anyway). The
// block is occupied if its first cell is; it is not if the box is that one
// cell, or two cells both empty. Only the blocks left undecided (near
// occupied cells) evaluate their other positions, r - 1 lanes to a block,
// 32 / r blocks a pass. Most blocks cost one position and one lookup
// instead of up to r of each.
#include "dda.cuh"

// Phase timing (tools/profile_dda.py builds this file with -DNRT_DDA_TIMING;
// no serving build defines it). Lane 0 of each ray's warp sums the SM clock
// cycles of each phase in registers; every lane counts the positions it
// evaluated. DDA_FLUSH, which the whole warp reaches, adds them to one of
// DDA_SPREAD rows of counters (by CTA, so that the atomics do not queue on
// one address); nrt_dda_counters (DDA_DEFINE_COUNTERS) returns the rows'
// sums and zeroes them.
enum DdaCounter {
  kDdaSetup, kDdaBlocks, kDdaCands, kDdaSlots,  // cycles
  kDdaBlockPositions, kDdaCandPositions, kDdaUnits, kDdaCounters
};
#ifdef NRT_DDA_TIMING
#define DDA_SPREAD 64
__device__ unsigned long long g_dda[DDA_SPREAD][kDdaCounters];
#define DDA_CLOCK(on)                                 \
  const bool dda_on_ = (on);                          \
  unsigned long long dda_c_[kDdaCounters] = {};       \
  long long dda_t_ = clock64()
#define DDA_MARK(ph)                                              \
  do {                                                            \
    const long long now_ = clock64();                             \
    dda_c_[ph] += static_cast<unsigned long long>(now_ - dda_t_); \
    dda_t_ = now_;                                                \
  } while (0)
// positions evaluated: 0 = coarse blocks, 1 = candidates (per lane)
#define DDA_TALLY(i, n) (dda_c_[kDdaBlockPositions + (i)] += (n))
#define DDA_FLUSH()                                                       \
  do {                                                                    \
    unsigned long long* row_ = g_dda[blockIdx.x % DDA_SPREAD];            \
    for (int k_ = kDdaBlockPositions; k_ <= kDdaCandPositions; ++k_) {    \
      const unsigned w_ = __reduce_add_sync(                              \
          0xffffffffu, static_cast<unsigned>(dda_c_[k_]));                \
      if ((threadIdx.x & 31) == 0) atomicAdd(&row_[k_], 1ull * w_);       \
    }                                                                     \
    if (dda_on_) {                                                        \
      for (int k_ = kDdaSetup; k_ <= kDdaSlots; ++k_)                     \
        atomicAdd(&row_[k_], dda_c_[k_]);                                 \
      atomicAdd(&row_[kDdaUnits], 1ull);                                  \
    }                                                                     \
  } while (0)
#define DDA_DEFINE_COUNTERS                                               \
  extern "C" int nrt_dda_counters(unsigned long long* out) {              \
    static unsigned long long rows[DDA_SPREAD][kDdaCounters];             \
    cudaError_t e = cudaMemcpyFromSymbol(rows, g_dda, sizeof(rows));      \
    if (e != cudaSuccess) return static_cast<int>(e);                     \
    for (int k = 0; k < kDdaCounters; ++k) {                              \
      out[k] = 0;                                                         \
      for (int i = 0; i < DDA_SPREAD; ++i) out[k] += rows[i][k];          \
    }                                                                     \
    static const unsigned long long zero[DDA_SPREAD][kDdaCounters] = {};  \
    return static_cast<int>(cudaMemcpyToSymbol(g_dda, zero, sizeof(zero))); \
  }
#else
#define DDA_CLOCK(on) \
  do {                \
  } while (0)
#define DDA_MARK(ph) \
  do {               \
  } while (0)
#define DDA_TALLY(i, n) \
  do {                  \
  } while (0)
#define DDA_FLUSH() \
  do {              \
  } while (0)
#define DDA_DEFINE_COUNTERS
#endif

namespace {

constexpr int K4_WARPS = 8;   // rays (warps) per CTA
constexpr int K4_GROUP = 4;   // passes of 32 blocks a lane decides together
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// v / d for v >= 0 and a warp-uniform d: a shift when d is a power of two
// (the pyramid factor and r are), an integer division otherwise
__device__ __forceinline__ int div_nonneg(int v, int d) {
  return (d & (d - 1)) == 0 ? v >> (__ffs(d) - 1) : v / d;
}

// parent pyramid cell of march step s, its axes packed as x << 20 | y << 10
// | z (R_c <= 1024, checked by the host)
__device__ __forceinline__ int cell_key(const RayGeom& g, int s,
                                       const float bb[6],
                                       const MarchStatics& st) {
  int v[3];
  voxel_at(g, march_t(g, s), bb, st.resolution, st.clip != 0, v);
  return (div_nonneg(v[0], st.factor) << 20) |
         (div_nonneg(v[1], st.factor) << 10) | div_nonneg(v[2], st.factor);
}

__device__ __forceinline__ bool key_occupied(const int8_t* __restrict__ coarse,
                                             int rc, int key) {
  return coarse[((key >> 20) * rc + ((key >> 10) & 1023)) * rc +
                (key & 1023)] > 0;
}

// Cells of the box spanned by cells ka and kb.
__device__ __forceinline__ int box_cells(int ka, int kb) {
  int cells = 1;
#pragma unroll
  for (int sh = 0; sh <= 20; sh += 10)
    cells *= abs(((ka >> sh) & 1023) - ((kb >> sh) & 1023)) + 1;
  return cells;
}

__global__ void __launch_bounds__(K4_WARPS * 32)
fused_dda_kernel(const float* __restrict__ rays, int n,
                 const int8_t* __restrict__ grid,
                 const int8_t* __restrict__ coarse,
                 const float* __restrict__ bbox, MarchStatics st,
                 float* __restrict__ t_sel, uint8_t* __restrict__ valid,
                 int* __restrict__ flat_sel, int* __restrict__ n_occ_out,
                 int* __restrict__ n_blk_out, float* __restrict__ dist) {
  extern __shared__ int kept_all[];  // [K4_WARPS][K_c] kept blocks
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ray = blockIdx.x * K4_WARPS + warp;
  if (ray >= n) return;  // the whole warp: no barrier follows
  int* kept = kept_all + warp * st.k_c;
  const unsigned lt = lanemask_lt();
  const int R = st.resolution, r = st.r, K = st.k_sel;
  // resolving undecided blocks: lane = k * r + j takes position j of the
  // k-th of `per` blocks
  const int per = 32 / r, k_lane = div_nonneg(lane, r);
  const int j_lane = lane - k_lane * r;
  const unsigned block_mask = r == 32 ? kAll : (1u << r) - 1u;
  const bool clip = st.clip != 0;
  float bb[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) bb[c] = bbox[c];
  DDA_CLOCK(lane == 0);

  // setup: lanes 0-5 load the ray, every lane holds its geometry
  const float mine = lane < 6 ? rays[6 * static_cast<size_t>(ray) + lane] : 0.0f;
  float r6[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) r6[c] = __shfl_sync(kAll, mine, c);
  const RayGeom g = ray_setup(r6, bb, st);
  DDA_MARK(kDdaSetup);

  // A. coarse blocks, and the first K_c occupied ones in march order. A
  // block's first position's cell ka and the next block's, kn, bound every
  // cell of the block (its positions lie between them). Each lane takes
  // its blocks of K4_GROUP passes at once, so that their positions and
  // lookups overlap; lane 0 also evaluates the first block after the group.
  int n_blk = 0;
  if (g.live) {
    for (int base = 0; base < st.s_c; base += 32 * K4_GROUP) {
      int key[K4_GROUP];
      bool hit[K4_GROUP];
      int evals = 0;
#pragma unroll
      for (int p = 0; p < K4_GROUP; ++p) {
        const int blk = base + 32 * p + lane;
        key[p] = blk <= st.s_c ? cell_key(g, blk * r, bb, st) : 0;
        evals += blk <= st.s_c;
      }
      const int blk_x = base + 32 * K4_GROUP;  // warp-uniform
      int key_x = 0;
      if (blk_x <= st.s_c && lane == 0) {
        key_x = cell_key(g, blk_x * r, bb, st);
        ++evals;
      }
#pragma unroll
      for (int p = 0; p < K4_GROUP; ++p)
        hit[p] = key_occupied(coarse, st.rc, key[p]);
      const bool hit_x = key_occupied(coarse, st.rc, key_x);
      bool occ[K4_GROUP], open[K4_GROUP];
#pragma unroll
      for (int p = 0; p < K4_GROUP; ++p) {
        // the next block's first cell and its occupancy: the next lane's,
        // or for lane 31 lane 0's of the next pass
        const int kn_down = __shfl_down_sync(kAll, key[p], 1);
        const int kn_wrap =
            __shfl_sync(kAll, p + 1 < K4_GROUP ? key[p + 1] : key_x, 0);
        const int hn_down = __shfl_down_sync(kAll, int(hit[p]), 1);
        const int hn_wrap = __shfl_sync(
            kAll, int(p + 1 < K4_GROUP ? hit[p + 1] : hit_x), 0);
        const int kn = lane == 31 ? kn_wrap : kn_down;
        const bool hn = (lane == 31 ? hn_wrap : hn_down) != 0;
        const int cells = box_cells(key[p], kn);
        const int blk = base + 32 * p + lane;
        occ[p] = blk < st.s_c && hit[p];
        // undecided: the first cell empty, the box more than that cell, and
        // not two cells of which the next block's first is empty too
        open[p] = blk < st.s_c && !hit[p] &&
                  cells > 1 && (cells > 2 || hn);
      }
      // the undecided blocks of each pass, 32 / r at a time: a lane for
      // each of their positions after the first, all evaluated at once
#pragma unroll
      for (int p = 0; p < K4_GROUP; ++p) {
        unsigned todo = __ballot_sync(kAll, open[p]), found = 0u;
        while (todo) {  // warp-uniform
          unsigned own = todo;  // this lane's block: the k-th open one
          for (int i = 0; i < k_lane && own; ++i) own &= own - 1;
          bool hit_j = false;
          if (j_lane > 0 && k_lane < per && own) {
            const int s = (base + 32 * p + __ffs(own) - 1) * r + j_lane;
            if (s < st.n_steps) {
              hit_j = key_occupied(coarse, st.rc, cell_key(g, s, bb, st));
              ++evals;
            }
          }
          const unsigned hits = __ballot_sync(kAll, hit_j);
          for (int q = 0; q < per && todo; ++q) {
            if ((hits >> (q * r)) & block_mask)
              found |= todo & (0u - todo);  // the lowest open bit
            todo &= todo - 1;
          }
        }
        occ[p] = occ[p] || ((found >> lane) & 1u);
      }
      DDA_TALLY(0, evals);
#pragma unroll
      for (int p = 0; p < K4_GROUP; ++p) {
        const unsigned m = __ballot_sync(kAll, occ[p]);
        const int rank = n_blk + __popc(m & lt);
        if (occ[p] && rank < st.k_c) kept[rank] = base + 32 * p + lane;
        n_blk += __popc(m);
      }
    }
  }
  const int n_kept = min(n_blk, st.k_c);
  __syncwarp();
  DDA_MARK(kDdaBlocks);

  // C. candidates of the kept blocks
  const size_t row = static_cast<size_t>(ray) * K;
  float* t_row = t_sel + row;
  int* f_row = flat_sel + row;
  uint8_t* v_row = valid + row;
  int n_occ = 0;
  if (st.compact) {
    const int c_kept = n_kept * r;
    for (int base = 0; base < c_kept; base += 32) {
      const int idx = base + lane;
      bool occ = false;
      float t = 0.0f;
      int flat = 0;
      if (idx < c_kept) {
        const int i = div_nonneg(idx, r);
        const int s = kept[i] * r + (idx - i * r);
        t = march_t(g, s);
        int v[3];
        voxel_at(g, t, bb, R, clip, v);
        flat = (v[0] * R + v[1]) * R + v[2];
        occ = s < st.n_steps && grid[flat] > 0;
        DDA_TALLY(1, 1);
      }
      const unsigned m = __ballot_sync(kAll, occ);
      const int slot = n_occ + __popc(m & lt);
      if (occ && slot < K) {
        t_row[slot] = t;
        f_row[slot] = flat;
      }
      n_occ += __popc(m);
    }
  } else {
    // K = C: candidate idx keeps slot idx; an unfilled kept slot marches
    // from block 0, invalid
    for (int base = 0; base < K; base += 32) {
      const int idx = base + lane;
      bool occ = false;
      if (idx < K) {
        const int i = div_nonneg(idx, r);
        const bool is_kept = i < n_kept;
        const int s = (is_kept ? kept[i] : 0) * r + (idx - i * r);
        const float t = march_t(g, s);
        int v[3];
        voxel_at(g, t, bb, R, clip, v);
        const int flat = (v[0] * R + v[1]) * R + v[2];
        occ = is_kept && s < st.n_steps && grid[flat] > 0;
        t_row[idx] = t;
        f_row[idx] = flat;
        v_row[idx] = occ ? 1 : 0;
        DDA_TALLY(1, 1);
      }
      n_occ += __popc(__ballot_sync(kAll, occ));
    }
  }
  DDA_MARK(kDdaCands);

  // D. padding and the valid row (compacted mode)
  if (st.compact) {
    const int n_emit = min(n_occ, K);
    for (int s = n_emit + lane; s < K; s += 32) {
      t_row[s] = 0.0f;
      f_row[s] = 0;
    }
    if ((K & 3) == 0) {
      for (int w = lane; w < K / 4; w += 32) {
        const int s = 4 * w;
        reinterpret_cast<unsigned*>(v_row)[w] =
            (s < n_emit ? 1u : 0u) | (s + 1 < n_emit ? 1u << 8 : 0u) |
            (s + 2 < n_emit ? 1u << 16 : 0u) | (s + 3 < n_emit ? 1u << 24 : 0u);
      }
    } else {
      for (int s = lane; s < K; s += 32) v_row[s] = s < n_emit ? 1 : 0;
    }
  }
  DDA_MARK(kDdaSlots);
  if (lane == 0) {
    n_occ_out[ray] = n_occ;
    n_blk_out[ray] = n_blk;
    dist[ray] = ray_dist(g);
  }
  DDA_FLUSH();
}

}  // namespace

NRT_DEFINE_ERROR_STRING
DDA_DEFINE_COUNTERS

extern "C" int nrt_fused_dda(const float* rays, int n, const int8_t* grid,
                             const int8_t* coarse, const float* bbox,
                             const MarchStatics* st, float* t_sel,
                             uint8_t* valid, int* flat_sel, int* n_occ,
                             int* n_blk, float* dist, void* stream) {
  if (n <= 0) return 0;
  // the kept lists: well inside the 48 KB a launch takes without an opt-in
  const size_t smem = static_cast<size_t>(K4_WARPS) * st->k_c * sizeof(int);
  if (smem > 48 * 1024 || st->rc > 1024 || st->r > 32 ||
      (!st->compact && st->k_sel != st->k_c * st->r))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + K4_WARPS - 1) / K4_WARPS;
  fused_dda_kernel<<<blocks, K4_WARPS * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      rays, n, grid, coarse, bbox, *st, t_sel, valid, flat_sel, n_occ, n_blk,
      dist);
  return static_cast<int>(cudaGetLastError());
}
