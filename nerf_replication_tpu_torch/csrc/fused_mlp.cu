// K1 + K2: the standalone fused NeRF MLP, forward and backward.
//
// K1 replaces the TPU kernel `_fwd_kernel` (nerf_replication_tpu/ops/
// fused_mlp.py:339, launched :450): the whole MLP (`_forward_tile` :183) on
// tiles of rows, writing only raw8 = rgb8 + alpha8 [M, 8]. K2 replaces
// `_bwd_kernel` (:348, launched :491): it recomputes the tile forward and
// runs the chain backward of `_backward_tile` (:244), returning dx, dv and
// one float32 gradient per weight tensor of FusedSpec.flatten_params.
//
// Rows: x [M, c_in_pad] and v [M, c_views_pad] float32 from global memory;
// the first `m` rows are real (the host pads M to the TPU tile multiple as
// the JAX package does; K1/K2 skip the padded rows, whose outputs the caller
// slices off and whose cotangent is zero). Tiles are MLP_M = 64 rows; a
// ragged last tile reads zeros and writes only its real rows.
//
// K1 is one CTA per tile running mlp_tile_forward (mlp_tile.cuh): float32
// products on the CUDA cores for the f32 family, bf16 mma.sync for the bf16
// family, each with the rounding points of `_forward_tile`.
//
// K2 keeps the JAX backward's arithmetic: relu masks from the saved
// activations, every backward product (`dotT` = a @ b^T, `Tdot` = a^T @ b)
// in float32 whatever the compute type (:275-287 cast both operands to f32),
// both heads taking the full [T, 8] cotangent (:265-271). Two things differ
// from the TPU kernel, and the design answers each:
//  * The activations do not fit in shared memory. The backward needs all
//    D + 2 activations of a tile (10 x 64 x 256 x 4 B = 640 KB at lego
//    width) against 227 KB per CTA. The recompute writes them to a per-CTA
//    global scratch as it produces them, and the backward reads each back
//    into shared memory when it needs it (132 CTAs x 640 KB = 84 MB, mostly
//    L2-resident). Shared memory holds x, v, the cotangent of the current
//    layer, one activation and the weight-staging buffers (208 KB).
//  * The TPU kernel accumulates dW/db across its sequential grid (:358-367).
//    Hopper CTAs run concurrently and in no order, so K2 is a persistent
//    grid of at most one CTA per SM: each CTA loops over tiles
//    blockIdx.x, blockIdx.x + gridDim.x, ... and accumulates into its own
//    float32 partial of every weight gradient (2.4 MB at lego width), and a
//    second kernel sums the partials in CTA order. No atomics: the result is
//    deterministic for a given grid, and the tests keep fixed tolerances.
//
// Bound on the card: operations. Forward 1.19 MFLOP per row at lego width
// (f32 CUDA cores: 67 TFLOP/s; bf16 tensor cores: 989 TFLOP/s); K2 does the
// forward again plus two float32 backward products of the same size, all on
// the CUDA cores. The partial read-modify-write adds ~4.8 MB per tile.
#include "mlp_tile.cuh"

namespace {

constexpr int MAX_PARAMS = 64;

// element offsets of every tensor of the flatten_params order (the
// gradient partials and the transposed float32 weights share them)
struct ParamOffsets {
  int n;
  long long total;
  long long off[MAX_PARAMS];
};

// indices into ParamOffsets of one configuration
struct ParamIndex {
  int w0, b0, wa, ba, wf, bf, wvf, wvv, bv, wr, br;
};

__host__ __device__ inline ParamIndex param_index(const MlpDesc& md) {
  int n = 2;
  for (int i = 1; i < md.D; ++i) n += (i == md.skip + 1) ? 3 : 2;
  ParamIndex p;
  p.w0 = 0;
  p.b0 = 1;
  p.wa = n;
  p.ba = n + 1;
  p.wf = n + 2;
  p.bf = n + 3;
  p.wvf = n + 4;
  p.wvv = n + 5;
  p.bv = n + 6;
  p.wr = n + 7;
  p.br = n + 8;
  return p;
}

ParamOffsets param_offsets(const MlpDesc& md) {
  const long long W = md.W, W2 = md.W / 2, cin = md.c_in_pad,
                  cvp = md.c_views_pad;
  long long sizes[MAX_PARAMS];
  int n = 0;
  sizes[n++] = cin * W;
  sizes[n++] = W;
  for (int i = 1; i < md.D; ++i) {
    if (i == md.skip + 1) sizes[n++] = cin * W;
    sizes[n++] = W * W;
    sizes[n++] = W;
  }
  sizes[n++] = W * 8;
  sizes[n++] = 8;
  sizes[n++] = W * W;
  sizes[n++] = W;
  sizes[n++] = W * W2;
  sizes[n++] = cvp * W2;
  sizes[n++] = W2;
  sizes[n++] = W2 * 8;
  sizes[n++] = 8;
  ParamOffsets po;
  po.n = n;
  long long acc = 0;
  for (int i = 0; i < n; ++i) {
    po.off[i] = acc;
    acc += sizes[i];
  }
  po.total = acc;
  return po;
}

size_t tile_smem_bytes(const MlpDesc& md) {
  const size_t floats = 2 * static_cast<size_t>(MLP_M) * (md.W + MLP_PAD) +
                        static_cast<size_t>(MLP_M) * (md.c_in_pad + MLP_PAD) +
                        static_cast<size_t>(MLP_M) * (md.c_views_pad + MLP_PAD) +
                        static_cast<size_t>(mlp_stage_floats(md.W)) +
                        MLP_M * 4 + MLP_M * 8;
  return floats * sizeof(float);
}

struct TileSmem {
  float *xs, *vs, *b1, *b2, *wst, *raw, *d8;
};

__device__ __forceinline__ TileSmem carve(float* smem, const MlpDesc& md) {
  TileSmem s;
  const int ldh = md.W + MLP_PAD;
  s.b1 = smem;
  s.b2 = s.b1 + MLP_M * ldh;
  s.xs = s.b2 + MLP_M * ldh;
  s.vs = s.xs + MLP_M * (md.c_in_pad + MLP_PAD);
  s.wst = s.vs + MLP_M * (md.c_views_pad + MLP_PAD);
  s.raw = s.wst + mlp_stage_floats(md.W);
  s.d8 = s.raw + MLP_M * 4;
  return s;
}

// dst[r, 0:C] (pitch C + MLP_PAD) = src[row0 + r, 0:C] (pitch C) for the
// rows below m, zeros past them; C % 4 == 0
__device__ __forceinline__ void load_rows(float* dst, const float* src, int C,
                                          int row0, int m) {
  const int c4 = C / 4;
  for (int e = threadIdx.x; e < MLP_M * c4; e += MLP_THREADS) {
    const int r = e / c4, q = e - r * c4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < m)
      val = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row0 + r) * C + 4 * q);
    *reinterpret_cast<float4*>(dst + r * (C + MLP_PAD) + 4 * q) = val;
  }
}

// dst[r, 0:C] (pitch ldd) = src[r, 0:C] (pitch lds), all MLP_M rows
__device__ __forceinline__ void copy_tile(float* dst, int ldd,
                                          const float* src, int lds, int C) {
  const int c4 = C / 4;
  for (int e = threadIdx.x; e < MLP_M * c4; e += MLP_THREADS) {
    const int r = e / c4, q = e - r * c4;
    *reinterpret_cast<float4*>(dst + r * ldd + 4 * q) =
        *reinterpret_cast<const float4*>(src + r * lds + 4 * q);
  }
}

// P[k, n] (= or +=) sum_r A[r, k] * Z[r, n] over the MLP_M rows: the JAX
// `Tdot(a, z)` of one tile, float32. A (pitch lda, K wide) and Z (pitch ldz,
// N <= 256 wide) in shared memory; P [K, N] row-major in global memory, this
// CTA's partial. Thread tile: 8 k-rows (warp * 8 + 64 * pass) x 8 columns
// (lane * 4 .. +3, 128 + lane * 4 .. +3). K % 8 == 0, N % 4 == 0.
__device__ void tdot_acc(const float* A, int lda, int K, const float* Z,
                         int ldz, int N, float* __restrict__ P, bool first) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool lo_ok = lane * 4 < N;
  const bool hi_ok = 128 + lane * 4 < N;
  for (int k0 = warp * 8; k0 < K; k0 += MLP_WARPS * 8) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int r = 0; r < MLP_M; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(A + r * lda + k0);
      const float4 a1 = *reinterpret_cast<const float4*>(A + r * lda + k0 + 4);
      const float* zr = Z + r * ldz + lane * 4;
      const float4 zl = f4_or_zero(zr, lo_ok);
      const float4 zh = f4_or_zero(zr + 128, hi_ok);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float z[8] = {zl.x, zl.y, zl.z, zl.w, zh.x, zh.y, zh.z, zh.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], z[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        if (g == 0 ? !lo_ok : !hi_ok) continue;
        float4* dst = reinterpret_cast<float4*>(
            P + static_cast<size_t>(k0 + i) * N + g * 128 + lane * 4);
        float4 val = make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                                 acc[i][4 * g + 2], acc[i][4 * g + 3]);
        if (!first) {
          const float4 old = *dst;
          val.x = old.x + val.x;
          val.y = old.y + val.y;
          val.z = old.z + val.z;
          val.w = old.w + val.w;
        }
        *dst = val;
      }
    }
  }
}

// Pb[n] (= or +=) sum_r Z[r, n]: the bias gradient of one tile
__device__ __forceinline__ void colsum_acc(const float* Z, int ldz, int N,
                                           float* __restrict__ Pb,
                                           bool first) {
  for (int n = threadIdx.x; n < N; n += MLP_THREADS) {
    float s = 0.0f;
    for (int r = 0; r < MLP_M; ++r) s = s + Z[r * ldz + n];
    Pb[n] = first ? s : Pb[n] + s;
  }
}

// one head's gradients: Pw[k, c] (= or +=) sum_r A[r, k] d8[r, c] ([K, 8])
// and Pb[c] (= or +=) sum_r d8[r, c], over all 8 raw columns
__device__ __forceinline__ void head_grad(const float* A, int lda, int K,
                                          const float* d8,
                                          float* __restrict__ Pw,
                                          float* __restrict__ Pb,
                                          bool first) {
  for (int e = threadIdx.x; e < K * 8; e += MLP_THREADS) {
    const int k = e >> 3, c = e & 7;
    float s = 0.0f;
    for (int r = 0; r < MLP_M; ++r) s = fmaf(A[r * lda + k], d8[r * 8 + c], s);
    Pw[e] = first ? s : Pw[e] + s;
  }
  if (threadIdx.x < 8) {
    const int c = threadIdx.x;
    float s = 0.0f;
    for (int r = 0; r < MLP_M; ++r) s = s + d8[r * 8 + c];
    Pb[c] = first ? s : Pb[c] + s;
  }
}

// Epilogue of a float32 backward product (the gemm_acc thread block):
// out[row, col] = mask[row, col] > 0 ? acc + extra(row, col) : 0, where the
// relu mask is a saved post-activation (or a pre-activation for the feature
// layer's none). mask may alias out: every element is read and written by
// the same thread.
template <typename Extra>
__device__ __forceinline__ void store_masked(
    const float (&acc)[MLP_ROWS_PER_WARP][8], int N, const float* mask,
    int ldm, float* out, int ldo, Extra extra) {
  const int r0 = (threadIdx.x >> 5) * MLP_ROWS_PER_WARP;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int col = g * 128 + lane * 4;
    if (col >= N) break;
#pragma unroll
    for (int i = 0; i < MLP_ROWS_PER_WARP; ++i) {
      const int row = r0 + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v = extra(row, col + c, acc[i][4 * g + c]);
        if (mask != nullptr && !(mask[row * ldm + col + c] > 0.0f)) v = 0.0f;
        out[row * ldo + col + c] = v;
      }
    }
  }
}

// rows of a float32 backward product into a global [M, N] output (the real
// rows only); with `add`, out = out + acc (the same thread wrote it before)
__device__ __forceinline__ void store_rows(
    const float (&acc)[MLP_ROWS_PER_WARP][8], int N, float* __restrict__ out,
    int row0, int m, bool add) {
  const int r0 = (threadIdx.x >> 5) * MLP_ROWS_PER_WARP;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int col = g * 128 + lane * 4;
    if (col >= N) break;
#pragma unroll
    for (int i = 0; i < MLP_ROWS_PER_WARP; ++i) {
      const int row = row0 + r0 + i;
      if (row >= m) continue;
      float4* dst = reinterpret_cast<float4*>(
          out + static_cast<size_t>(row) * N + col);
      float4 val = make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                               acc[i][4 * g + 2], acc[i][4 * g + 3]);
      if (add) {
        const float4 old = *dst;
        val.x = old.x + val.x;
        val.y = old.y + val.y;
        val.z = old.z + val.z;
        val.w = old.w + val.w;
      }
      *dst = val;
    }
  }
}

struct NoExtra {
  __device__ __forceinline__ float operator()(int, int, float a) const {
    return a;
  }
};

template <typename CT>
__global__ void __launch_bounds__(MLP_THREADS, 1)
    fused_mlp_fwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ v, int m, MlpDesc md,
                         const CT* __restrict__ ws,
                         const float* __restrict__ wh, float* __restrict__ raw8) {
  extern __shared__ __align__(16) float smem[];
  const TileSmem s = carve(smem, md);
  const int row0 = blockIdx.x * MLP_M;
  load_rows(s.xs, x, md.c_in_pad, row0, m);
  load_rows(s.vs, v, md.c_views_pad, row0, m);
  // the first GEMM's barrier makes the rows visible
  mlp_tile_forward<CT>(md, ws, wh, s.xs, s.vs, s.b1, s.b2, s.wst, s.raw);
  for (int e = threadIdx.x; e < MLP_M * 8; e += MLP_THREADS) {
    const int r = e >> 3, c = e & 7;
    if (row0 + r < m)
      raw8[static_cast<size_t>(row0 + r) * 8 + c] = c < 4 ? s.raw[r * 4 + c] : 0.0f;
  }
}

// K2. wt: every tensor of the flatten order as float32, 2-D ones transposed
// to [out, in] (the B operand of `dotT` for gemm_acc); acts: gridDim.x x
// (D + 2) x MLP_M x W floats; partials: gridDim.x x po.total floats.
template <typename CT>
__global__ void __launch_bounds__(MLP_THREADS, 1)
    fused_mlp_bwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ v,
                         const float* __restrict__ draw, int m, MlpDesc md,
                         const CT* __restrict__ ws,
                         const float* __restrict__ wh,
                         const float* __restrict__ wt, ParamOffsets po,
                         float* __restrict__ acts_all,
                         float* __restrict__ partials, float* __restrict__ dx,
                         float* __restrict__ dv) {
  extern __shared__ __align__(16) float smem[];
  const TileSmem s = carve(smem, md);
  const int W = md.W, W2 = md.W / 2, cin = md.c_in_pad, cvp = md.c_views_pad;
  const int ldh = W + MLP_PAD, ldx = cin + MLP_PAD, ldv = cvp + MLP_PAD;
  const ParamIndex ix = param_index(md);
  float* acts = acts_all + static_cast<size_t>(blockIdx.x) * (md.D + 2) * MLP_M * W;
  float* P = partials + static_cast<size_t>(blockIdx.x) * po.total;
  auto act = [&](int slot) { return acts + static_cast<size_t>(slot) * MLP_M * W; };
  const float* wa = wh;                    // [W, 8]
  const float* wr = wh + W * 8 + 8;        // [W2, 8]
  const int n_tiles = (m + MLP_M - 1) / MLP_M;
  float acc[MLP_ROWS_PER_WARP][8];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == static_cast<int>(blockIdx.x);
    const int row0 = tile * MLP_M;
    load_rows(s.xs, x, cin, row0, m);
    load_rows(s.vs, v, cvp, row0, m);
    // recompute: every activation lands in the CTA's scratch
    mlp_tile_forward<CT, true>(md, ws, wh, s.xs, s.vs, s.b1, s.b2, s.wst,
                               s.raw, acts);
    for (int e = threadIdx.x; e < MLP_M * 8; e += MLP_THREADS) {
      const int r = e >> 3;
      s.d8[e] = row0 + r < m ? draw[static_cast<size_t>(row0) * 8 + e] : 0.0f;
    }
    copy_tile(s.b2, ldh, act(md.D + 1), W, W2);  // vh
    __syncthreads();

    // rgb head: dWr = vh^T draw, dbr = sum draw, dvh = (draw @ Wr^T) * (vh > 0)
    head_grad(s.b2, ldh, W2, s.d8, P + po.off[ix.wr], P + po.off[ix.br], first);
    for (int e = threadIdx.x; e < MLP_M * W2; e += MLP_THREADS) {
      const int r = e / W2, k = e - r * W2;
      float t = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) t = fmaf(s.d8[r * 8 + c], wr[k * 8 + c], t);
      s.b1[r * ldh + k] = s.b2[r * ldh + k] > 0.0f ? t : 0.0f;
    }
    __syncthreads();
    copy_tile(s.b2, ldh, act(md.D), W, W);  // f
    __syncthreads();

    // views branch: dWvf = f^T dvh, dWvv = v^T dvh, dbv, dv = dvh @ Wvv^T,
    // df = dvh @ Wvf^T
    tdot_acc(s.b2, ldh, W, s.b1, ldh, W2, P + po.off[ix.wvf], first);
    tdot_acc(s.vs, ldv, cvp, s.b1, ldh, W2, P + po.off[ix.wvv], first);
    colsum_acc(s.b1, ldh, W2, P + po.off[ix.bv], first);
    if (dv != nullptr) {
      zero_acc(acc);
      gemm_acc(acc, s.b1, ldh, W2, wt + po.off[ix.wvv], cvp, s.wst);
      store_rows(acc, cvp, dv, row0, m, false);
    }
    zero_acc(acc);
    gemm_acc(acc, s.b1, ldh, W2, wt + po.off[ix.wvf], W, s.wst);
    store_masked(acc, W, nullptr, 0, s.b2, ldh, NoExtra());  // df (f is dead)
    copy_tile(s.b1, ldh, act(md.D - 1), W, W);                // h_last
    __syncthreads();

    // feature + alpha heads: dWf = h^T df, dbf, dWa = h^T draw, dba,
    // dh = df @ Wf^T + draw @ Wa^T, masked by the last trunk relu
    tdot_acc(s.b1, ldh, W, s.b2, ldh, W, P + po.off[ix.wf], first);
    colsum_acc(s.b2, ldh, W, P + po.off[ix.bf], first);
    head_grad(s.b1, ldh, W, s.d8, P + po.off[ix.wa], P + po.off[ix.ba], first);
    zero_acc(acc);
    gemm_acc(acc, s.b2, ldh, W, wt + po.off[ix.wf], W, s.wst);
    {
      const float* d8 = s.d8;
      store_masked(acc, W, s.b1, ldh, s.b1, ldh,
                   [d8, wa](int row, int col, float a) {
                     float t = 0.0f;
#pragma unroll
                     for (int c = 0; c < 8; ++c)
                       t = fmaf(d8[row * 8 + c], wa[col * 8 + c], t);
                     return a + t;
                   });
    }
    __syncthreads();

    // trunk in reverse: b1 holds dz_i = dh_i * (a_i > 0)
    int pi = po.n - 9;  // one past the last trunk tensor
    for (int i = md.D - 1; i >= 1; --i) {
      const bool skip = i == md.skip + 1;
      const int i_b = pi - 1, i_w = pi - 2, i_wx = skip ? pi - 3 : -1;
      pi -= skip ? 3 : 2;
      copy_tile(s.b2, ldh, act(i - 1), W, W);  // a_{i-1}
      __syncthreads();
      tdot_acc(s.b2, ldh, W, s.b1, ldh, W, P + po.off[i_w], first);
      colsum_acc(s.b1, ldh, W, P + po.off[i_b], first);
      if (skip) {
        tdot_acc(s.xs, ldx, cin, s.b1, ldh, W, P + po.off[i_wx], first);
        if (dx != nullptr) {
          zero_acc(acc);
          gemm_acc(acc, s.b1, ldh, W, wt + po.off[i_wx], cin, s.wst);
          store_rows(acc, cin, dx, row0, m, false);
        }
      }
      zero_acc(acc);
      gemm_acc(acc, s.b1, ldh, W, wt + po.off[i_w], W, s.wst);
      store_masked(acc, W, s.b2, ldh, s.b1, ldh, NoExtra());
      __syncthreads();
    }
    // first layer: dW0 = x^T dz0, db0, dx += dz0 @ W0^T
    tdot_acc(s.xs, ldx, cin, s.b1, ldh, W, P + po.off[ix.w0], first);
    colsum_acc(s.b1, ldh, W, P + po.off[ix.b0], first);
    if (dx != nullptr) {
      zero_acc(acc);
      gemm_acc(acc, s.b1, ldh, W, wt + po.off[ix.w0], cin, s.wst);
      store_rows(acc, cin, dx, row0, m, md.skip >= 0);
    }
    __syncthreads();  // the next tile overwrites xs, b1, b2
  }
}

// grad[j] = sum over CTAs c, in order, of partials[c, j]
__global__ void fused_mlp_reduce_kernel(const float* __restrict__ partials,
                                        int n_part, long long total,
                                        float* __restrict__ grad) {
  for (long long j = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       j < total; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = partials[j];
    for (int c = 1; c < n_part; ++c) s = s + partials[c * total + j];
    grad[j] = s;
  }
}

bool shape_ok(const MlpDesc& md) {
  // D <= 24 keeps the 2D + 10 tensors of the flatten order in ParamOffsets
  return md.D >= 2 && md.D <= 24 && md.W % 64 == 0 && md.W <= 256 &&
         md.c_in_pad % MMA_KS == 0 && md.c_in_pad <= 64 &&
         md.c_views_pad % MMA_KS == 0 && md.c_views_pad <= 32 &&
         md.skip < md.D - 1 && tile_smem_bytes(md) <= 232448;
}

template <typename CT>
int launch_fwd(const float* x, const float* v, int m, const MlpDesc& md,
               const void* ws, const float* wh, float* raw8,
               cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(md);
  cudaError_t e = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (m + MLP_M - 1) / MLP_M;
  fused_mlp_fwd_kernel<CT><<<blocks, MLP_THREADS, smem, stream>>>(
      x, v, m, md, static_cast<const CT*>(ws), wh, raw8);
  return static_cast<int>(cudaGetLastError());
}

template <typename CT>
int launch_bwd(const float* x, const float* v, const float* draw, int m,
               const MlpDesc& md, const void* ws, const float* wh,
               const float* wt, float* acts, float* partials, int n_ctas,
               float* dx, float* dv, float* grad, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(md);
  cudaError_t e = cudaFuncSetAttribute(
      fused_mlp_bwd_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const ParamOffsets po = param_offsets(md);
  fused_mlp_bwd_kernel<CT><<<n_ctas, MLP_THREADS, smem, stream>>>(
      x, v, draw, m, md, static_cast<const CT*>(ws), wh, wt, po, acts,
      partials, dx, dv);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = 256;
  const long long want = (po.total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  fused_mlp_reduce_kernel<<<blocks, threads, 0, stream>>>(partials, n_ctas,
                                                          po.total, grad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NRT_DEFINE_ERROR_STRING

extern "C" int nrt_fused_mlp_fwd(const float* x, const float* v, int m,
                                 const MlpDesc* md, const void* ws, int bf16,
                                 const float* wh, float* raw8, void* stream) {
  if (m <= 0) return 0;
  if (!shape_ok(*md)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_fwd<__nv_bfloat16>(x, v, m, *md, ws, wh, raw8, s);
  return launch_fwd<float>(x, v, m, *md, ws, wh, raw8, s);
}

extern "C" int nrt_fused_mlp_bwd(const float* x, const float* v,
                                 const float* draw, int m, const MlpDesc* md,
                                 const void* ws, int bf16, const float* wh,
                                 const float* wt, float* acts,
                                 float* partials, int n_ctas, float* dx,
                                 float* dv, float* grad, void* stream) {
  if (m <= 0) return 0;
  const int n_tiles = (m + MLP_M - 1) / MLP_M;
  if (!shape_ok(*md) || n_ctas < 1 || n_ctas > n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_bwd<__nv_bfloat16>(x, v, draw, m, *md, ws, wh, wt, acts,
                                     partials, n_ctas, dx, dv, grad, s);
  return launch_bwd<float>(x, v, draw, m, *md, ws, wh, wt, acts, partials,
                           n_ctas, dx, dv, grad, s);
}
