// CUDA-core and mma.sync pieces of the fused NeRF-MLP tile on MLP_M rows
// held in shared memory, used by K2a's forward recompute and dX chain
// (fused_mlp_bwd.cu, through mlp_rows.cuh). The forward kernels K1/K3a and
// K5 run the Hopper chain of mlp_chain_sm90.cuh instead.
//
// The rounding points are those of the TPU tile body `_forward_tile`
// (nerf_replication_tpu/ops/fused_mlp.py:183): operands rounded to the
// compute type CT (float, or __nv_bfloat16), float32 accumulation, float32
// activations between layers, biases streamed in CT, the alpha and rgb
// heads in float32 on float32 activations.
//
// Weight layout: `ws` is every CT tensor of FusedSpec.flatten_params in
// canonical order, concatenated — matrices [in, out] row-major for float32,
// [out, in] for bf16 (the tensor-core B operand), biases as they are; `wh`
// is the float32 heads [Wa (W x 8), ba (8), Wr (W/2 x 8), br (8)]
// (ops/fused_mlp.pack_for_kernel).
//
// Tiles are 64 rows: two 64 x W float32 activation buffers ping-pong in
// shared memory and each layer's weights stream through two shared-memory
// slices with cp.async, the next slice copied while the current one is
// consumed. gemm_acc for float32 gives each of 256 threads an 8 x 8
// register block of FMAs on the CUDA cores (one float32 product; the
// forward kernels now take theirs as three TF32 tensor-core products,
// which K2a's dX chain does too). gemm_acc for bf16 runs mma.sync.m16n8k16
// (bf16 operands, float32 accumulation): each warp owns 16 rows x N/2
// columns, A fragments come from the float32 activations (rounded to bf16
// as they are packed), B fragments from a bf16 weight slice staged as
// [N][32 + 8]. Activation rows are padded by MLP_PAD floats so both paths
// read them without shared-memory bank conflicts.
#pragma once

#include "common.cuh"

constexpr int MLP_M = 64;         // rows per tile
// threads that run the chain. 256 (8 warps): on the H100, 512 made the bf16
// family 7% faster and the f32 family 6% slower (see PERF.md).
constexpr int MLP_THREADS = 256;
constexpr int MLP_WARPS = MLP_THREADS / 32;
constexpr int MLP_ROWS_PER_WARP = MLP_M / MLP_WARPS;  // f32 tile rows
constexpr int MLP_KS = 16;        // f32 weight rows per shared-memory slice
constexpr int MMA_KS = 32;        // bf16 weight k per shared-memory slice
constexpr int MLP_PAD = 8;        // floats of padding per activation row
constexpr int MMA_PB = MMA_KS + 8;  // bf16 pitch of one staged weight row

// floats of the weight-staging region (two slice buffers of either path)
__host__ __device__ constexpr int mlp_stage_floats(int W) {
  return (2 * MLP_KS * W > W * MMA_PB) ? 2 * MLP_KS * W : W * MMA_PB;
}

// 16-byte asynchronous global -> shared copies, committed in groups
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void zero_acc(float (&acc)[MLP_ROWS_PER_WARP][8]) {
#pragma unroll
  for (int i = 0; i < MLP_ROWS_PER_WARP; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
}

__device__ __forceinline__ float4 f4_or_zero(const float* p, bool ok) {
  return ok ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float f4_at(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// -- float32 family: CUDA-core GEMM ---------------------------------------------

// acc += A[0:64, 0:K] (shared, row stride lda) @ Wg[0:K, 0:N] (global f32)
// for this thread's MLP_ROWS_PER_WARP x 8 block: rows of its warp, columns
// lane*4 .. +3 and 128 + lane*4 .. +3 (those < N). K % MLP_KS == 0, N % 4 == 0,
// N <= 256, lda % 4 == 0. Weight slices [MLP_KS][N] are copied into two
// shared buffers with cp.async, the next one while the current one is
// consumed; shared memory is read in 128-bit words. The caller's writes of
// A are made visible by the first slice's barrier; the last barrier frees
// the staging region for the next call.
__device__ void gemm_acc(float (&acc)[MLP_ROWS_PER_WARP][8], const float* A,
                         int lda, int K, const float* __restrict__ Wg, int N,
                         float* wst) {
  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * MLP_ROWS_PER_WARP;
  const int lane = tid & 31;
  const bool lo_ok = lane * 4 < N;
  const bool hi_ok = 128 + lane * 4 < N;
  const int n4 = MLP_KS * N / 4;
  const int ns = K / MLP_KS;
  auto stage = [&](int s) {
    float* dst = wst + (s & 1) * MLP_KS * N;
    const float* src = Wg + static_cast<size_t>(s) * MLP_KS * N;
    for (int e = tid; e < n4; e += MLP_THREADS) cp_async16(dst + 4 * e, src + 4 * e);
    cp_async_commit();
  };
  stage(0);
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) {
      stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slice s (and the caller's A) visible to all
    const float* ws = wst + (s & 1) * MLP_KS * N;
    const int k0 = s * MLP_KS;
#pragma unroll
    for (int kq = 0; kq < MLP_KS; kq += 4) {
      float4 a4[MLP_ROWS_PER_WARP];
#pragma unroll
      for (int i = 0; i < MLP_ROWS_PER_WARP; ++i)
        a4[i] = *reinterpret_cast<const float4*>(A + (r0 + i) * lda + k0 + kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = ws + (kq + kk) * N + lane * 4;
        const float4 bl = f4_or_zero(brow, lo_ok);
        const float4 bh = f4_or_zero(brow + 128, hi_ok);
        const float b[8] = {bl.x, bl.y, bl.z, bl.w, bh.x, bh.y, bh.z, bh.w};
#pragma unroll
        for (int i = 0; i < MLP_ROWS_PER_WARP; ++i) {
          const float a = f4_at(a4[i], kk);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // buffer s & 1 is free for slice s + 2
  }
}

// out[row, col] = act(acc + bias[col]) for this thread's block; with `save`
// the same values also go to save[row * lds + col] (global)
__device__ __forceinline__ void store_act(
    const float (&acc)[MLP_ROWS_PER_WARP][8], const float* __restrict__ bias,
    int N, bool relu, float* out, int ldo, float* save = nullptr,
    int lds = 0) {
  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * MLP_ROWS_PER_WARP;
  const int lane = tid & 31;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int col = g * 128 + lane * 4;
    if (col >= N) break;
    float b[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = __ldg(bias + col + c);
#pragma unroll
    for (int i = 0; i < MLP_ROWS_PER_WARP; ++i) {
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[c] = acc[i][4 * g + c] + b[c];
        if (relu) v[c] = fmaxf(v[c], 0.0f);
      }
      *reinterpret_cast<float4*>(out + (r0 + i) * ldo + col) =
          make_float4(v[0], v[1], v[2], v[3]);
      if (save != nullptr)
        *reinterpret_cast<float4*>(save + (r0 + i) * lds + col) =
            make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// -- bf16 family: tensor-core GEMM --------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16x2(float2 v) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);  // .x low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// bf16 warp tile: rows 16*(warp % 4) .. +15, columns
// (warp / 4)*N/MMA_COL_GROUPS .. +N/MMA_COL_GROUPS as n8 tiles
constexpr int MMA_COL_GROUPS = MLP_WARPS / 4;
constexpr int MMA_TILES = 256 / 8 / MMA_COL_GROUPS;  // for N <= 256

__device__ __forceinline__ void zero_acc(float (&acc)[MMA_TILES][4]) {
#pragma unroll
  for (int j = 0; j < MMA_TILES; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;
}

// acc += A[0:64, 0:K] (float32 shared, rounded to bf16) @ W[0:K, 0:N] with
// W given transposed, wt [N][K] bf16 (global). Warp w owns rows
// 16*(w%4) .. +15 and N/MMA_COL_GROUPS columns from (w/4)*N/MMA_COL_GROUPS,
// as n8 tiles.
// K % MMA_KS == 0, N % 16 == 0, N <= 256, lda % 32 == MLP_PAD. Slices
// [N][MMA_KS] are copied with cp.async into two buffers of pitch MMA_PB,
// the next one while the current one is consumed.
__device__ void gemm_acc(float (&acc)[MMA_TILES][4], const float* A, int lda, int K,
                         const __nv_bfloat16* __restrict__ wt, int N,
                         float* wst) {
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(wst);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16;
  const int n_base = (warp >> 2) * (N / MMA_COL_GROUPS);
  const int nt = N / (8 * MMA_COL_GROUPS);
  constexpr int kParts = MMA_KS / 8;  // 16-byte chunks per staged row
  const int ns = K / MMA_KS;
  auto stage = [&](int s) {
    __nv_bfloat16* dst = bs + (s & 1) * N * MMA_PB;
    const __nv_bfloat16* src = wt + s * MMA_KS;
    for (int e = tid; e < N * kParts; e += MLP_THREADS) {
      const int n = e / kParts, part = e - n * kParts;
      cp_async16(dst + n * MMA_PB + 8 * part,
                 src + static_cast<size_t>(n) * K + 8 * part);
    }
    cp_async_commit();
  };
  stage(0);
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) {
      stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slice s (and the caller's A) visible to all
    const __nv_bfloat16* b_s = bs + (s & 1) * N * MMA_PB;
#pragma unroll
    for (int kk = 0; kk < MMA_KS; kk += 16) {
      const float* a_lo = A + (r0 + g) * lda + s * MMA_KS + kk + 2 * t;
      const float* a_hi = a_lo + 8 * lda;
      const uint32_t a0 = pack_bf16x2(*reinterpret_cast<const float2*>(a_lo));
      const uint32_t a1 = pack_bf16x2(*reinterpret_cast<const float2*>(a_hi));
      const uint32_t a2 = pack_bf16x2(*reinterpret_cast<const float2*>(a_lo + 8));
      const uint32_t a3 = pack_bf16x2(*reinterpret_cast<const float2*>(a_hi + 8));
#pragma unroll
      for (int j = 0; j < MMA_TILES; ++j) {
        if (j < nt) {
          const __nv_bfloat16* bp = b_s + (n_base + 8 * j + g) * MMA_PB + kk + 2 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
              "{%0, %1, %2, %3};\n"
              : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]),
                "+f"(acc[j][3])
              : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
        }
      }
    }
    __syncthreads();  // buffer s & 1 is free for slice s + 2
  }
}

// out[row, col] = act(acc + bias[col]) for this warp's mma tiles (and the
// same values into save[row * lds + col] when `save` is given)
__device__ __forceinline__ void store_act(const float (&acc)[MMA_TILES][4],
                                          const __nv_bfloat16* __restrict__ bias,
                                          int N, bool relu, float* out,
                                          int ldo, float* save = nullptr,
                                          int lds = 0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16;
  const int n_base = (warp >> 2) * (N / MMA_COL_GROUPS);
  const int nt = N / (8 * MMA_COL_GROUPS);
#pragma unroll
  for (int j = 0; j < MMA_TILES; ++j) {
    if (j >= nt) break;
    const int col = n_base + 8 * j + 2 * t;
    const float b0 = __bfloat162float(bias[col]);
    const float b1 = __bfloat162float(bias[col + 1]);
    float v[4] = {acc[j][0] + b0, acc[j][1] + b1, acc[j][2] + b0,
                  acc[j][3] + b1};
    if (relu) {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = fmaxf(v[c], 0.0f);
    }
    *reinterpret_cast<float2*>(out + (r0 + g) * ldo + col) = make_float2(v[0], v[1]);
    *reinterpret_cast<float2*>(out + (r0 + g + 8) * ldo + col) = make_float2(v[2], v[3]);
    if (save != nullptr) {
      *reinterpret_cast<float2*>(save + (r0 + g) * lds + col) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(save + (r0 + g + 8) * lds + col) = make_float2(v[2], v[3]);
    }
  }
}

// the accumulator of each family's GEMM
template <typename CT>
struct TileAcc {
  float v[MLP_ROWS_PER_WARP][8];  // CUDA-core block (float32 family)
};
template <>
struct TileAcc<__nv_bfloat16> {
  float v[MMA_TILES][4];  // mma n8 tiles x 4 (bf16 family)
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// raw[row * 4 + c] = sum_k H[row, k] * Wh[k * 8 + col_c] + bh[col_c], float32,
// for the `n_out` columns cols[0..n_out); warp w owns MLP_ROWS_PER_WARP
// rows from w * MLP_ROWS_PER_WARP.
__device__ __forceinline__ void head_f32(const float* H, int ldh, int K,
                                         const float* __restrict__ Wh,
                                         const float* __restrict__ bh,
                                         int col0, int n_out, int raw_col0,
                                         float* raw) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < MLP_ROWS_PER_WARP; ++i) {
    const int row = warp * MLP_ROWS_PER_WARP + i;
    for (int c = 0; c < n_out; ++c) {
      float part = 0.0f;
      for (int k = lane; k < K; k += 32)
        part = fmaf(H[row * ldh + k], __ldg(Wh + k * 8 + col0 + c), part);
      part = warp_sum(part);
      if (lane == 0) raw[row * 4 + raw_col0 + c] = part + __ldg(bh + col0 + c);
    }
  }
}
