// K1 + K3a: the standalone fused NeRF MLP forward.
//
// K1 replaces the TPU kernel `_fwd_kernel` (nerf_replication_tpu/ops/
// fused_mlp.py:339, launched :450): the whole MLP (`_forward_tile` :183) on
// tiles of rows, writing only raw8 = rgb8 + alpha8 [M, 8]. The backward
// (K2, K3b) is fused_mlp_bwd.cu.
//
// Rows: x [M, c_in_pad] and v [M, c_views_pad] float32 from global memory;
// the first `m` rows are real (the host pads M to the TPU tile multiple as
// the JAX package does; the kernels skip the padded rows, whose outputs the
// caller slices off). bf16: a CTA takes 2 x CH_M = 128 rows: each of two
// consumer warpgroups reads its 64 rows into shared memory (rounded to the
// compute type as they are stored) and runs the Hopper chain of
// mlp_chain_sm90.cuh on them, every column its own (wgmma products), while
// one thread of a third (producer) warpgroup streams one pass of the
// weights through the TMA ring that both read. The producer warpgroup gives
// its registers to the consumers (setmaxnreg), whose m64n256 accumulator
// alone is 128 registers a thread. float32 (3xTF32): a CTA takes CH_M = 64
// rows and each consumer warpgroup half of every layer's columns (the
// chain's kCols, as K5), since the chain adds its tensor-core partial sums
// into IEEE float32 sums, and both fit in registers only at 128 columns;
// the heads' halves meet in shared memory. A ragged last tile reads zeros
// and writes only its real rows.
//
// Bound on the card: operations. Forward 1.19 MFLOP per row at lego width:
// bf16 at the tensor cores' 989 TFLOP/s; float32 as three TF32 products at
// 495 TFLOP/s (the CUDA cores' 67 TFLOP/s for one float32 product was the
// bound of the earlier chain). The weights (4.8 MB split float32, 1.2 MB
// bf16) come from L2 once per CTA: 64 rows (float32), 128 (bf16).
//
// K3a is the same body with the compile-time flag MASKED (K1 is the
// MASKED = false instantiation). K3a replaces `_fwd_kernel_masked`
// (fused_mlp.py:370, launched :528): the packed march's per-row occupancy
// bit `valid` [M] (float32 0/1) streams in, a tile with no valid
// row writes exact zeros and skips its chain (one block-uniform
// __syncthreads_or over the tile's bits), and every other tile stores
// raw8 * valid. A row's arithmetic does not depend on the other rows of its
// tile, so K3a's valid rows are bitwise K1's. The packed stream is sorted
// valid-first, so at ~5% occupancy ~95% of its tiles skip: K3a's bound is
// then the bytes of x, v and the bit of all M rows plus raw8, or the
// operations of the valid rows — whichever is larger.
#include <type_traits>

#include "mlp_chain_sm90.cuh"

namespace {

using namespace chain;

// the float32 family splits columns (kCols), bf16 rows
template <typename CT>
constexpr bool kColsOf = std::is_same<CT, float>::value;
// rows per CTA
template <typename CT>
constexpr int kTile = kColsOf<CT> ? CH_M : 2 * CH_M;

// shared memory: the activation buffers of a tile's rows (and, kCols, the
// heads' two halves: [2][CH_M][4] float32), then the ring, then its
// barriers
template <typename CT>
__host__ __device__ inline size_t fwd_fixed_bytes(const MlpDesc& md) {
  const size_t heads = kColsOf<CT> ? 2 * CH_M * 4 * sizeof(float) : 0;
  return (act_bytes<CT>(md, kTile<CT>) + heads + 127) / 128 * 128;
}
template <typename CT>
int fwd_stages(const MlpDesc& md) {
  const long long room = 232448 - static_cast<long long>(fwd_fixed_bytes<CT>(md)) -
                         2 * CH_MAX_STAGES * 8;
  const long long fit = room / CH_STAGE_BYTES;
  return static_cast<int>(fit < CH_MAX_STAGES ? fit : CH_MAX_STAGES);
}

// dst[r, 0:C] (pitch C + pad, type AT) = src[row0 + r, 0:C] for the CH_M
// rows of one warpgroup (zeros past m); the warpgroup's 128 threads
template <typename AT>
__device__ __forceinline__ void load_rows(AT* dst, int pitch,
                                          const float* __restrict__ src, int C,
                                          int row0, int m) {
  const int c4 = C / 4;
  for (int e = threadIdx.x & 127; e < CH_M * c4; e += 128) {
    const int r = e / c4, q = e - r * c4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < m)
      val = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row0 + r) * C + 4 * q);
    AT* d = dst + r * pitch + 4 * q;
    store2(d, val.x, val.y);
    store2(d + 2, val.z, val.w);
  }
}

template <typename CT, int W, bool MASKED>
__global__ void __launch_bounds__(CH_THREADS_WS, 1)
    fused_mlp_fwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ v,
                         const float* __restrict__ valid, int m, MlpDesc md,
                         const unsigned char* __restrict__ wmat,
                         const float* __restrict__ bias,
                         const float* __restrict__ wh, int n_stages,
                         float* __restrict__ raw8) {
  using AT = typename Fam<CT>::AT;
  constexpr int pad = Fam<CT>::kPad;
  constexpr bool kCols = kColsOf<CT>;
  constexpr int TILE = kTile<CT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldh = W + pad, ldx = md.c_in_pad + pad, ldv = md.c_views_pad + pad;
  AT* H = reinterpret_cast<AT*>(smem);
  AT* xs = H + TILE * ldh;
  AT* vs = xs + TILE * ldx;
  // kCols: the heads' column halves [2][CH_M][4]
  float* hp = reinterpret_cast<float*>(smem + act_bytes<CT>(md, TILE));
  unsigned char* ring_mem = smem + fwd_fixed_bytes<CT>(md);
  Ring ring{reinterpret_cast<uint64_t*>(ring_mem + n_stages * CH_STAGE_BYTES),
            nullptr, smem_u32(ring_mem), n_stages};
  ring.empty = ring.full + n_stages;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TILE;
  if (MASKED) {
    const bool mine = tid < TILE && row0 + tid < m && valid[row0 + tid] != 0.0f;
    if (!__syncthreads_or(mine)) {  // block-uniform: the whole block leaves
      for (int e = tid; e < TILE * 8; e += CH_THREADS_WS)
        if (row0 + e / 8 < m) raw8[static_cast<size_t>(row0) * 8 + e] = 0.0f;
      return;
    }
  }
  if (tid == 0) ring_init(ring);
  __syncthreads();
  RingPos pos;
  if (tid >= CH_CONSUMERS) {  // the producer warpgroup: one thread copies
    producer_regs();
    if (tid == CH_CONSUMERS) produce_pass<CT>(md, wmat, ring, pos);
    return;
  }
  consumer_regs();  // an m64n256 bf16-family accumulator is 128 registers
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const float ba = __ldg(wh + W * 8 + 3);
  const float* br = wh + W * 8 + 8 + (W / 2) * 8;
  if constexpr (kCols) {
    // both warpgroups on the tile's 64 rows, each half of the columns:
    // one loads x, the other v
    if (wg == 0)
      load_rows(xs, ldx, x, md.c_in_pad, row0, m);
    else
      load_rows(vs, ldv, v, md.c_views_pad, row0, m);
    consumers_sync();
    const HeadOut ho = chain_forward<CT, W, true, true>(
        md, bias, wh, xs, ldx, vs, ldv, H, ldh, ring, pos);
    if ((lane & 3) == 0) {
      float* half = hp + wg * CH_M * 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * ((tid >> 5) & 3) + (lane >> 2) + 8 * h;
        *reinterpret_cast<float4*>(half + row * 4) = make_float4(
            ho.rgb[h][0], ho.rgb[h][1], ho.rgb[h][2], ho.alpha[h]);
      }
    }
    consumers_sync();
    // raw8 by (row, column): the halves' sum + the head bias
    for (int e = tid; e < CH_M * 8; e += CH_CONSUMERS) {
      const int r = e / 8, c = e & 7;
      if (row0 + r >= m) break;
      float o = 0.0f;
      if (c < 4) {
        const float hb = c < 3 ? __ldg(br + c) : ba;
        o = (hp[r * 4 + c] + hp[CH_M * 4 + r * 4 + c]) + hb;
        if (MASKED) o = o * valid[row0 + r];  // raw8 * valid
      }
      raw8[static_cast<size_t>(row0 + r) * 8 + c] = o;
    }
  } else {
    const int r0 = row0 + wg * CH_M;
    AT* Hw = H + wg * CH_M * ldh;
    AT* xw = xs + wg * CH_M * ldx;
    AT* vw = vs + wg * CH_M * ldv;
    load_rows(xw, ldx, x, md.c_in_pad, r0, m);
    load_rows(vw, ldv, v, md.c_views_pad, r0, m);
    warpgroup_sync(wg);
    const HeadOut ho =
        chain_forward<CT, W, false, false>(md, bias, wh, xw, ldx, vw, ldv,
                                           Hw, ldh, ring, pos);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 16 * ((tid >> 5) & 3) + (lane >> 2) + 8 * h;
        if (row >= m) continue;
        float o[4] = {ho.rgb[h][0] + __ldg(br), ho.rgb[h][1] + __ldg(br + 1),
                      ho.rgb[h][2] + __ldg(br + 2), ho.alpha[h] + ba};
        if (MASKED) {
          const float bit = valid[row];
#pragma unroll
          for (int c = 0; c < 4; ++c) o[c] = o[c] * bit;  // raw8 * valid
        }
        float4* dst =
            reinterpret_cast<float4*>(raw8 + static_cast<size_t>(row) * 8);
        dst[0] = make_float4(o[0], o[1], o[2], o[3]);
        dst[1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

template <typename CT, int W, bool MASKED>
int launch_fwd(const float* x, const float* v, const float* valid, int m,
               const MlpDesc& md, const void* wmat, const float* bias,
               const float* wh, float* raw8, cudaStream_t stream) {
  const int ns = fwd_stages<CT>(md);
  if (ns < CH_MIN_STAGES) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_fixed_bytes<CT>(md) +
                      static_cast<size_t>(ns) * (CH_STAGE_BYTES + 16);
  auto kernel = fused_mlp_fwd_kernel<CT, W, MASKED>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (m + kTile<CT> - 1) / kTile<CT>;
  kernel<<<blocks, CH_THREADS_WS, smem, stream>>>(
      x, v, valid, m, md, static_cast<const unsigned char*>(wmat), bias, wh,
      ns, raw8);
  return static_cast<int>(cudaGetLastError());
}

template <typename CT, bool MASKED>
int launch_width(const float* x, const float* v, const float* valid, int m,
                 const MlpDesc& md, const void* wmat, const float* bias,
                 const float* wh, float* raw8, cudaStream_t s) {
  switch (md.W) {
    case 64:
      return launch_fwd<CT, 64, MASKED>(x, v, valid, m, md, wmat, bias, wh,
                                        raw8, s);
    case 128:
      return launch_fwd<CT, 128, MASKED>(x, v, valid, m, md, wmat, bias, wh,
                                         raw8, s);
    case 192:
      return launch_fwd<CT, 192, MASKED>(x, v, valid, m, md, wmat, bias, wh,
                                         raw8, s);
    case 256:
      return launch_fwd<CT, 256, MASKED>(x, v, valid, m, md, wmat, bias, wh,
                                         raw8, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

NRT_DEFINE_ERROR_STRING

// K1 when `valid` is null; K3a with `valid` [M] float32 0/1. `wmat` is
// pack_for_chain's weight image, `bias` its float32 biases, `wh` the heads.
extern "C" int nrt_fused_mlp_fwd(const float* x, const float* v,
                                 const float* valid, int m,
                                 const MlpDesc* md, const void* wmat,
                                 const float* bias, int bf16,
                                 const float* wh, float* raw8, void* stream) {
  if (m <= 0) return 0;
  if (!chain_shape_ok(*md)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return valid ? launch_width<__nv_bfloat16, true>(x, v, valid, m, *md,
                                                     wmat, bias, wh, raw8, s)
                 : launch_width<__nv_bfloat16, false>(x, v, valid, m, *md,
                                                      wmat, bias, wh, raw8, s);
  return valid ? launch_width<float, true>(x, v, valid, m, *md, wmat, bias,
                                           wh, raw8, s)
               : launch_width<float, false>(x, v, valid, m, *md, wmat, bias,
                                            wh, raw8, s);
}
