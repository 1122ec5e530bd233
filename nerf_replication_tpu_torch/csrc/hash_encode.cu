// K6 / K6b: the multiresolution hash encoder, forward and backward.
//
// Which TPU kernel each replaces. K6 (`hash_fwd_kernel`) replaces
// `_hash_kernel` (nerf_replication_tpu/models/encoding/pallas_hash.py:102,
// launched through `_squeeze_page_kernel` :229 by the pallas_call at :207).
// On the TPU it never lowered: Mosaic rejects the in-kernel row gather, so
// the JAX package encodes through XLA. K6b (`hash_bwd_table_kernel`, and
// `hash_bwd_x_kernel` when dx is asked for) is the backward of the same
// function; the JAX package's VJP is XLA (pallas_hash.py:274-287).
//
// What bounds them on the H100. Bytes, counted once: at the NGP warm step
// (131,072 points, 16 levels, C = 2) K6 writes 16.8 MB and reads the
// touched rows of a 45.9 MB table; K6b reads 16.8 MB of cotangents and
// writes dtable. What holds them back is the L2. K6 makes 16.8 M random
// 8-byte row gathers, each a whole 32-byte sector. K6b adds the same 16.8 M
// products into those rows with atomics, which the L2 executes one by one:
// K6b runs at the L2's atomic rate (PERF.md §6), and on the coarse levels
// the adds pile onto a few thousand rows (lego_hash level 0: 4,912 rows,
// ~213 adds a row).
//
// The design.
// * K6: one thread per (point, level), the level the
//   fastest index, so the L threads of a point write its L·C output floats
//   as one coalesced run, each corner's row loaded as one vector (float2 at
//   C = 2). The per-(point, level) float operations: pos = x·scale + 0.5 as
//   one FMA (as XLA contracts it inside the jitted JAX step), every other
//   operation spelled out with __fmul_rn / __fadd_rn / __fsub_rn, corners
//   summed in JAX's order, so K6 equals its plain PyTorch version
//   (ops/hash_encode.forward_plain) bit for bit. Level-major layouts (a warp
//   per level over 32 ray-ordered points, the output staged in shared memory
//   for 16-byte stores; x staged too; warps owning a group over all levels;
//   the coarse slices copied into shared memory) were level or faster on
//   uniform points but 3-4% slower on the main path's ray-ordered points
//   (PERF.md §6): a level-fastest warp already holds two neighbouring
//   samples, which share the coarse rows.
// * K6b is level-major: a warp's 32 lanes take 32 consecutive points at one
//   level. The main path's points are ray-major (a ray's samples are
//   neighbours), so at the coarse and middle levels neighbouring lanes fall
//   into the same cell and add into the same rows. Corners go in dim-0
//   pairs (b, b + 1): the hash's dim-0 prime is 1 and slice offsets are
//   multiples of 8, so for half the cells the two rows share an aligned
//   16-byte row pair (C = 2), added by one atomic. Work items are (32-point
//   group, level), a run of two a warp (CTAs beyond what the card holds
//   refill the slots that free up); for
//   each corner pair the lanes holding the same row (or row pair) find each
//   other with __match_any_sync, sum their w·g pairwise in lane order by
//   shuffles (reduce_peers), and the lowest lane issues one vector atomic
//   (float2 / float4 atomicAdd, a REDG.E.ADD.F32x2 / x4 on sm_90): one per
//   distinct row or row pair per warp, in place of C scalar atomics per
//   lane. On the coarse levels this is what removes the contention: on the
//   main path's points it cuts lego_hash level 0's adds from 1.05 M to
//   254 k. Summing the small levels in a shared-memory copy of their slice
//   first, then flushing it, made the kernel slower on every point set
//   measured (PERF.md §6: a shared float add is a compare-and-swap loop on
//   this card, and the few CTAs that own a level run as a serial tail), so
//   every level takes the warp path. Each row gets the same products w·g
//   as in the plain version; the float32 sums add them in another order
//   each launch, so dtable is NOT deterministic run to run. dx (only when
//   asked for; march points are data) comes from a second kernel, one
//   thread per point over its levels in order: dx_d = Σ_l scale_l Σ_b
//   sign_b(d) Π_{d'≠d} w_b(d') <row_b, g_l>, with no atomics, deterministic.
#include "common.cuh"

#define NRT_HASH_MAX_LEVELS 32

// Per-level constants (ops/hash_encode.HashDescC): passed by value.
struct HashDesc {
  int levels;
  float scale[NRT_HASH_MAX_LEVELS];
  unsigned int resolution[NRT_HASH_MAX_LEVELS];
  unsigned int hashed[NRT_HASH_MAX_LEVELS];
  unsigned int offset[NRT_HASH_MAX_LEVELS];
  unsigned int size[NRT_HASH_MAX_LEVELS];
};

namespace {

constexpr int kThreads = 256;       // K6 and dx
constexpr int kBwdThreads = 512;    // K6b: two CTAs an SM
constexpr unsigned int kFull = 0xffffffffu;
// match keys: a row (< 2^31), kPairKey | (an aligned row pair's first row
// >> 1), or kNoKey | lane (a lane past the last point: a group of its own)
constexpr unsigned int kPairKey = 0x80000000u;
constexpr unsigned int kNoKey = 0xffffffe0u;
constexpr int kItemsPerWarp = 2;   // K6b: a run of 2 items a warp
__constant__ unsigned int kPrimes[4] = {1u, 19349663u, 83492791u, 25165843u};

struct LevelShared {
  float scale[NRT_HASH_MAX_LEVELS];
  unsigned int resolution[NRT_HASH_MAX_LEVELS];
  unsigned int hashed[NRT_HASH_MAX_LEVELS];
  unsigned int offset[NRT_HASH_MAX_LEVELS];
  unsigned int size[NRT_HASH_MAX_LEVELS];
};

__device__ __forceinline__ void load_levels(const HashDesc& desc,
                                            LevelShared& sh) {
  for (int l = threadIdx.x; l < desc.levels; l += blockDim.x) {
    sh.scale[l] = desc.scale[l];
    sh.resolution[l] = desc.resolution[l];
    sh.hashed[l] = desc.hashed[l];
    sh.offset[l] = desc.offset[l];
    sh.size[l] = desc.size[l];
  }
  __syncthreads();
}

template <int C>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[C]) {
  if constexpr (C == 1) {
    v[0] = __ldg(p);
  } else if constexpr (C == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < C; i += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  }
}

template <int C>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[C]) {
  if constexpr (C == 1) {
    p[0] = v[0];
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < C; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// W floats added into dtable at p by vector atomics (float2 / float4 RED:
// sm_90, global memory; each element is atomic on its own).
template <int W>
__device__ __forceinline__ void add_vec(float* p, const float* v) {
  if constexpr (W == 1) {
    atomicAdd(p, v[0]);
  } else if constexpr (W == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int i = 0; i < W; i += 4)
      atomicAdd(reinterpret_cast<float4*>(p + i),
                make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
  }
}

// One level of one point: the cell corner and the fractional position.
template <int D>
struct LevelPoint {
  unsigned int grid[D];
  float frac[D];
};

template <int D>
__device__ __forceinline__ LevelPoint<D> level_point(const float (&xv)[D],
                                                     float scale) {
  LevelPoint<D> lp;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float pos = __fmaf_rn(xv[d], scale, 0.5f);
    const float fl = floorf(pos);
    lp.frac[d] = __fsub_rn(pos, fl);
    lp.grid[d] = static_cast<unsigned int>(static_cast<int>(fl));
  }
  return lp;
}

template <int D>
__device__ __forceinline__ LevelPoint<D> level_point_at(const float* xp,
                                                        float scale) {
  float xv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) xv[d] = __ldg(xp + d);
  return level_point<D>(xv, scale);
}

// Weight Π_d (frac or 1 − frac) of corner `bits`, dimension `skip` left out,
// multiplied in dimension order from 1 (as the JAX expression does).
template <int D>
__device__ __forceinline__ float corner_weight(const LevelPoint<D>& lp,
                                               int bits, int skip = -1) {
  float w = 1.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (d == skip) continue;
    w = __fmul_rn(w, ((bits >> d) & 1) ? lp.frac[d]
                                       : __fsub_rn(1.0f, lp.frac[d]));
  }
  return w;
}

// Index of corner `bits` inside level l's slice: dense row-major or the
// XOR-prime hash, in uint32 arithmetic, modulo the slice size. K6b's level
// is warp-uniform, so only the one it needs is computed.
template <int D>
__device__ __forceinline__ unsigned int corner_index(const LevelPoint<D>& lp,
                                                     int bits,
                                                     const LevelShared& sh,
                                                     int l) {
  unsigned int index = 0u;
  if (sh.hashed[l]) {
#pragma unroll
    for (int d = 0; d < D; ++d)
      index ^= (lp.grid[d] + static_cast<unsigned int>((bits >> d) & 1)) *
               kPrimes[d];
  } else {
    const unsigned int res1 = sh.resolution[l] + 1u;
    unsigned int stride = 1u;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      index += (lp.grid[d] + static_cast<unsigned int>((bits >> d) & 1)) *
               stride;
      stride *= res1;
    }
  }
  return index % sh.size[l];
}

// Table row (offset included) of corner `bits`, for K6 and dx, where the
// levels of one warp differ: both indices are computed and one is selected.
template <int D>
__device__ __forceinline__ unsigned int corner_row(const LevelPoint<D>& lp,
                                                   int bits,
                                                   const LevelShared& sh,
                                                   int l) {
  unsigned int dense = 0u, stride = 1u, hashv = 0u;
  const unsigned int res1 = sh.resolution[l] + 1u;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const unsigned int c = lp.grid[d] + static_cast<unsigned int>((bits >> d) & 1);
    dense += c * stride;
    stride *= res1;
    hashv ^= c * kPrimes[d];
  }
  const unsigned int index = sh.hashed[l] ? hashv : dense;
  return sh.offset[l] + index % sh.size[l];
}

// Sum v over this lane's peers (`peers`: the lanes holding the same row,
// this lane among them) pairwise in lane order: the lowest peer ends with
// the group's sum (others hold partial sums). All 32 lanes call it
// together; a warp of distinct rows leaves after one vote.
template <int C>
__device__ __forceinline__ void reduce_peers(unsigned int peers,
                                             float (&v)[C]) {
  const int lane = threadIdx.x & 31;
  unsigned int rest = peers & (0xfffffffeu << lane);  // peers above me
  unsigned int rank = __popc(peers & ((1u << lane) - 1u));
  while (__any_sync(kFull, rest != 0u)) {
    const int next = __ffs(rest);  // 1 + the next live peer above, or 0
    const int src = next ? next - 1 : lane;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float t = __shfl_sync(kFull, v[c], src);
      if (next) v[c] = __fadd_rn(v[c], t);
    }
    // odd ranks have handed their sums down: drop them
    rest &= ~__ballot_sync(kFull, rank & 1u);
    rank >>= 1;
  }
}

// K6b's work on one (32-point group, level): each lane's point (valid lanes
// only) adds w·g of its 2^D corners into dtable's rows, aggregated over the
// warp: the lanes holding the same key sum their values (reduce_peers) and
// the lowest issues one vector atomic. Corners go in dim-0 pairs (b, b + 1):
// where the two rows share an aligned row pair (r0 ^ r1 == 1: half the
// cells, as the hash's dim-0 prime is 1 and slice offsets are multiples of
// 8) and C <= 2, the pair is one key and one 2C-wide add (a 16-byte RED at
// C = 2).
template <int D, int C>
__device__ __forceinline__ void scatter_level(const float (&xv)[D],
                                              bool valid, const float* gp,
                                              const LevelShared& sh, int l,
                                              float* dtable) {
  const int lane = threadIdx.x & 31;
  const unsigned int below = (1u << lane) - 1u;
  const unsigned int none = kNoKey | lane;  // a lane past the last point
  const LevelPoint<D> lp = level_point<D>(xv, sh.scale[l]);
  float gv[C];
  if (valid) {
    load_vec<C>(gp, gv);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) gv[c] = 0.0f;
  }
  const unsigned int base = sh.offset[l];
#pragma unroll
  for (int b = 0; b < (1 << D); b += 2) {
    const unsigned int r0 = base + corner_index<D>(lp, b, sh, l);
    const unsigned int r1 = base + corner_index<D>(lp, b + 1, sh, l);
    const float w0 = corner_weight<D>(lp, b), w1 = corner_weight<D>(lp, b + 1);
    float v0[C], v1[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v0[c] = __fmul_rn(w0, gv[c]);
      v1[c] = __fmul_rn(w1, gv[c]);
    }
    bool pair = false;
    if constexpr (C <= 2) {
      pair = valid && (r0 ^ r1) == 1u;
      const bool odd = r0 & 1u;
      float v[2 * C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v[c] = pair && odd ? v1[c] : v0[c];
        v[C + c] = pair ? (odd ? v0[c] : v1[c]) : 0.0f;
      }
      const unsigned int key = !valid ? none
                               : pair ? kPairKey | (r0 >> 1) : r0;
      const unsigned int peers = __match_any_sync(kFull, key);
      reduce_peers<2 * C>(peers, v);
      if (valid && (peers & below) == 0u) {
        if (pair) {
          add_vec<2 * C>(dtable + static_cast<size_t>(r0 & ~1u) * C, v);
        } else {
          add_vec<C>(dtable + static_cast<size_t>(r0) * C, v);
        }
      }
    } else {
      const unsigned int peers = __match_any_sync(kFull, valid ? r0 : none);
      reduce_peers<C>(peers, v0);
      if (valid && (peers & below) == 0u)
        add_vec<C>(dtable + static_cast<size_t>(r0) * C, v0);
    }
    if (__any_sync(kFull, valid && !pair)) {  // corner b + 1 on its own
      const bool own = valid && !pair;
      const unsigned int peers = __match_any_sync(kFull, own ? r1 : none);
      reduce_peers<C>(peers, v1);
      if (own && (peers & below) == 0u)
        add_vec<C>(dtable + static_cast<size_t>(r1) * C, v1);
    }
  }
}

template <int D>
__device__ __forceinline__ void load_point(const float* x, long long p,
                                           bool valid, float (&xv)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) xv[d] = valid ? __ldg(x + p * D + d) : 0.0f;
}

template <int D, int C>
__global__ void __launch_bounds__(kThreads)
hash_fwd_kernel(const float* __restrict__ x, long long n,
                const float* __restrict__ table, HashDesc desc,
                float* __restrict__ out) {
  __shared__ LevelShared sh;
  load_levels(desc, sh);
  const int L = desc.levels;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= n * L) return;
  const long long p = tid / L;
  const int l = static_cast<int>(tid - p * L);
  const LevelPoint<D> lp = level_point_at<D>(x + p * D, sh.scale[l]);
  float acc[C];
#pragma unroll
  for (int b = 0; b < (1 << D); ++b) {
    const float w = corner_weight<D>(lp, b);
    float v[C];
    load_vec<C>(table + static_cast<size_t>(corner_row<D>(lp, b, sh, l)) * C,
                v);
#pragma unroll
    for (int c = 0; c < C; ++c)
      acc[c] = b == 0 ? __fmul_rn(w, v[c]) : __fadd_rn(acc[c], __fmul_rn(w, v[c]));
  }
  store_vec<C>(out + static_cast<size_t>(tid) * C, acc);
}

template <int D, int C>
__global__ void __launch_bounds__(kBwdThreads, 2)
hash_bwd_table_kernel(const float* __restrict__ x, long long n,
                      HashDesc desc, const float* __restrict__ g,
                      float* __restrict__ dtable) {
  __shared__ LevelShared sh;
  load_levels(desc, sh);
  const int L = desc.levels, LC = L * C;
  const int lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  // items (32-point group, level), group-major; each warp takes a run of
  // consecutive items
  const long long items = ((n + 31) >> 5) * L;
  const long long warps = static_cast<long long>(gridDim.x) * n_warps;
  const long long wid =
      static_cast<long long>(blockIdx.x) * n_warps + (threadIdx.x >> 5);
  const long long per = (items + warps - 1) / warps;
  const long long end = wid * per + per < items ? wid * per + per : items;
  long long have = -1;
  float xv[D];
  bool valid = false;
  for (long long i = wid * per; i < end; ++i) {
    const long long grp = i / L;
    const int l = static_cast<int>(i - grp * L);
    const long long p = grp * 32 + lane;
    if (grp != have) {
      valid = p < n;
      load_point<D>(x, p, valid, xv);
      have = grp;
    }
    scatter_level<D, C>(xv, valid, g + p * LC + l * C, sh, l, dtable);
  }
}

template <int D, int C>
__global__ void __launch_bounds__(kThreads)
hash_bwd_x_kernel(const float* __restrict__ x, long long n,
                  const float* __restrict__ table, HashDesc desc,
                  const float* __restrict__ g, float* __restrict__ dx) {
  __shared__ LevelShared sh;
  load_levels(desc, sh);
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int L = desc.levels;
  float dxa[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dxa[d] = 0.0f;
  for (int l = 0; l < L; ++l) {
    const LevelPoint<D> lp = level_point_at<D>(x + p * D, sh.scale[l]);
    float gv[C];
    load_vec<C>(g + (static_cast<size_t>(p) * L + l) * C, gv);
    float rowg[1 << D];
#pragma unroll
    for (int b = 0; b < (1 << D); ++b) {
      float v[C];
      load_vec<C>(table + static_cast<size_t>(corner_row<D>(lp, b, sh, l)) * C,
                  v);
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) s = __fadd_rn(s, __fmul_rn(v[c], gv[c]));
      rowg[b] = s;
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float acc = 0.0f;
#pragma unroll
      for (int b = 0; b < (1 << D); ++b) {
        const float t = __fmul_rn(corner_weight<D>(lp, b, d), rowg[b]);
        acc = ((b >> d) & 1) ? __fadd_rn(acc, t) : __fsub_rn(acc, t);
      }
      dxa[d] = __fadd_rn(dxa[d], __fmul_rn(sh.scale[l], acc));
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) dx[p * D + d] = dxa[d];
}

template <int D, int C>
int launch_fwd(const float* x, long long n, const float* table,
               const HashDesc& desc, float* out, cudaStream_t stream) {
  const long long threads = n * desc.levels;
  const unsigned int blocks =
      static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  hash_fwd_kernel<D, C><<<blocks, kThreads, 0, stream>>>(x, n, table, desc,
                                                        out);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int C>
int launch_bwd(const float* x, long long n, const float* table,
               const HashDesc& desc, const float* g, float* dtable, float* dx,
               cudaStream_t stream) {
  // a run of kItemsPerWarp items a warp; CTAs beyond what the card holds
  // queue up and take the slots that free up
  const long long items = ((n + 31) / 32) * desc.levels;
  const long long per_cta = static_cast<long long>(kBwdThreads / 32) *
                            kItemsPerWarp;
  const unsigned int blocks =
      static_cast<unsigned int>((items + per_cta - 1) / per_cta);
  hash_bwd_table_kernel<D, C><<<blocks, kBwdThreads, 0, stream>>>(
      x, n, desc, g, dtable);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || dx == nullptr) return static_cast<int>(e);
  const unsigned int pblocks =
      static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  hash_bwd_x_kernel<D, C><<<pblocks, kThreads, 0, stream>>>(x, n, table, desc,
                                                           g, dx);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on (D, C) in {2, 3, 4} x {1, 2, 4, 8}.
template <template <int, int> class F, typename... Args>
int dispatch(int d, int c, Args... args) {
#define NRT_HASH_CASE(DD, CC) \
  if (d == DD && c == CC) return F<DD, CC>::run(args...);
  NRT_HASH_CASE(2, 1) NRT_HASH_CASE(2, 2) NRT_HASH_CASE(2, 4) NRT_HASH_CASE(2, 8)
  NRT_HASH_CASE(3, 1) NRT_HASH_CASE(3, 2) NRT_HASH_CASE(3, 4) NRT_HASH_CASE(3, 8)
  NRT_HASH_CASE(4, 1) NRT_HASH_CASE(4, 2) NRT_HASH_CASE(4, 4) NRT_HASH_CASE(4, 8)
#undef NRT_HASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D, int C>
struct Fwd {
  static int run(const float* x, long long n, const float* table,
                 const HashDesc* desc, float* out, cudaStream_t stream) {
    return launch_fwd<D, C>(x, n, table, *desc, out, stream);
  }
};

template <int D, int C>
struct Bwd {
  static int run(const float* x, long long n, const float* table,
                 const HashDesc* desc, const float* g, float* dtable,
                 float* dx, cudaStream_t stream) {
    return launch_bwd<D, C>(x, n, table, *desc, g, dtable, dx, stream);
  }
};

// The table's rows stay below 2^31 (the match keys' pair bit).
bool bad_desc(const HashDesc* desc) {
  if (desc->levels <= 0 || desc->levels > NRT_HASH_MAX_LEVELS) return true;
  for (int l = 0; l < desc->levels; ++l) {
    if (desc->size[l] == 0u) return true;
    if (static_cast<unsigned long long>(desc->offset[l]) + desc->size[l] >
        0x7fffffffull)
      return true;
  }
  return false;
}

}  // namespace

NRT_DEFINE_ERROR_STRING

extern "C" int nrt_hash_encode_fwd(const float* x, long long n, int d,
                                   const float* table, int c,
                                   const HashDesc* desc, float* out,
                                   void* stream) {
  if (n <= 0) return 0;
  if (bad_desc(desc)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Fwd>(d, c, x, n, table, desc, out,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int nrt_hash_encode_bwd(const float* x, long long n, int d,
                                   const float* table, int c,
                                   const HashDesc* desc, const float* g,
                                   float* dtable, float* dx, void* stream) {
  if (n <= 0) return 0;
  if (bad_desc(desc)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Bwd>(d, c, x, n, table, desc, g, dtable, dx,
                       static_cast<cudaStream_t>(stream));
}
