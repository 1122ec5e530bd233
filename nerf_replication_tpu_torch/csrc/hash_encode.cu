// K6 / K6b: the multiresolution hash encoder, forward and backward.
//
// K6 replaces the TPU kernel `_hash_kernel` (nerf_replication_tpu/models/
// encoding/pallas_hash.py:102, launched through `_squeeze_page_kernel` :229
// by the pallas_call at :207). On the TPU it never lowered: Mosaic rejects
// the in-kernel row gather, so the JAX package encodes through XLA. Here the
// gather is native. K6b is the backward of the same function (the JAX
// package's VJP is XLA): the atomicAdd scatter of the reference CUDA encoder.
//
// Design: one thread per (point, level), the level the fastest index, so the
// L threads of a point write its L·C output floats as one coalesced run (128
// B for lego_hash's 16 levels x 2 features). Each thread computes pos =
// x·scale + 0.5 as one fused multiply-add (XLA contracts it inside the
// jitted JAX train step), then visits the 2^D corners in JAX's order, each
// corner's table row loaded as one vector (float2 at C = 2). Every other
// float operation is spelled out with __fmul_rn / __fadd_rn / __fsub_rn, so
// nothing else is contracted and K6 equals its plain PyTorch version
// (ops/hash_encode.forward_plain) bit for bit. The dense and hashed indices
// are both computed and one is selected: levels of one warp differ.
//
// Bound on the card: bytes. At the NGP warm step (N = 131,072 points, 16
// levels, C = 2) x is 1.6 MB, out 16.8 MB and the rows touched at most the
// whole 45.9 MB table: ~0.019 ms at 3.35 TB/s. The work is 16.8 M random
// 8-byte gathers; the table nearly fits the 50 MB L2, and its coarse levels
// are touched by every point. Making it fast (sorted points, an L2-resident
// table) is later work.
//
// K6b: the same thread mapping recomputes the indices and weights and
// atomically adds w·g into the rows of dtable (zeroed by the wrapper). The
// float32 atomics add in another order each launch: dtable is NOT
// deterministic run to run. dx (only when asked for; march points are data)
// comes from a second kernel, one thread per point over its levels in order:
// dx_d = Σ_l scale_l Σ_b sign_b(d) Π_{d'≠d} w_b(d') <row_b, g_l>, with no
// atomics, deterministic.
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

constexpr int kThreads = 256;
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

// One level of one point: the cell corner and the fractional position.
template <int D>
struct LevelPoint {
  unsigned int grid[D];
  float frac[D];
};

template <int D>
__device__ __forceinline__ LevelPoint<D> level_point(const float* xp,
                                                     float scale) {
  LevelPoint<D> lp;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float pos = __fmaf_rn(__ldg(xp + d), scale, 0.5f);
    const float fl = floorf(pos);
    lp.frac[d] = __fsub_rn(pos, fl);
    lp.grid[d] = static_cast<unsigned int>(static_cast<int>(fl));
  }
  return lp;
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

// Table row (offset included) of corner `bits`: dense row-major or the
// XOR-prime hash, in uint32 arithmetic, modulo the level's slice size.
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
  const LevelPoint<D> lp = level_point<D>(x + p * D, sh.scale[l]);
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
__global__ void __launch_bounds__(kThreads)
hash_bwd_table_kernel(const float* __restrict__ x, long long n,
                      HashDesc desc, const float* __restrict__ g,
                      float* __restrict__ dtable) {
  __shared__ LevelShared sh;
  load_levels(desc, sh);
  const int L = desc.levels;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= n * L) return;
  const long long p = tid / L;
  const int l = static_cast<int>(tid - p * L);
  const LevelPoint<D> lp = level_point<D>(x + p * D, sh.scale[l]);
  float gv[C];
  load_vec<C>(g + static_cast<size_t>(tid) * C, gv);
#pragma unroll
  for (int b = 0; b < (1 << D); ++b) {
    const float w = corner_weight<D>(lp, b);
    float* row = dtable + static_cast<size_t>(corner_row<D>(lp, b, sh, l)) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) atomicAdd(row + c, __fmul_rn(w, gv[c]));
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
    const LevelPoint<D> lp = level_point<D>(x + p * D, sh.scale[l]);
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
  const long long threads = n * desc.levels;
  const unsigned int blocks =
      static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  hash_bwd_table_kernel<D, C><<<blocks, kThreads, 0, stream>>>(x, n, desc, g,
                                                              dtable);
  cudaError_t e = cudaGetLastError();
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

bool bad_desc(const HashDesc* desc) {
  if (desc->levels <= 0 || desc->levels > NRT_HASH_MAX_LEVELS) return true;
  for (int l = 0; l < desc->levels; ++l)
    if (desc->size[l] == 0u) return true;
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
