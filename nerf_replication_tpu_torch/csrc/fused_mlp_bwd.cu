// K2 + K3b: the backward of the standalone fused NeRF MLP, as two kernels
// (K2a rows, K2b weight gradients) and an ordered reduce.
//
// K2 replaces the TPU kernel `_bwd_kernel` (nerf_replication_tpu/ops/
// fused_mlp.py:348, launched :491), K3b `_bwd_kernel_masked` (:397,
// launched :568). Both compute what `_backward_tile` (:244) computes: the
// recompute of the forward in the compute type, every backward product in
// float32 whatever the compute type (:275-287), both heads taking the full
// [T, 8] cotangent, and under K3b the cotangent draw * valid with zero dx/dv
// on invalid rows. Outputs: dx, dv (each only when asked for) and one
// float32 gradient per tensor of FusedSpec.flatten_params, in that order.
//
// The TPU kernel sums dW/db across its sequential grid in VMEM. An earlier
// design here gave each CTA of a persistent grid a float32 partial of every
// gradient (2.4 MB at lego width) and read-modify-wrote it after each
// 64-row tile: 4.8 MB of traffic per tile, 132 x 2.4 MB = 314 MB of
// partials beside 132 x 640 KB = 84 MB of activation scratch, both above
// the 50 MB L2, and weight-gradient products only 64 rows deep, all behind
// the FMAs of the same 8 warps. This design splits the work by what bounds
// each part:
//
//  * K2a (`fused_mlp_bwd_rows_kernel`): one CTA per 64-row tile, as K1. It
//    recomputes the tile forward (mlp_tile_forward's chain, in the compute
//    type), runs the dX chain (relu masks from the recomputed activations,
//    the float32 `dotT` products; dx/dv only when asked for) and writes
//    every float32 operand the weight gradients need to a global scratch,
//    one block per tile (GradScratch): the activations a_0 .. a_{D-1}, f,
//    vh, the masked cotangents dz_0 .. dz_{D-1}, df, dvh, and the tile's x,
//    v and draw (* valid), ~21.6 KB a row at lego width, written once, each
//    tile by one bulk copy from shared memory as soon as it is there (per
//    row copies, or stores from registers, stalled the chain); the relu
//    masks the chain needs stay in shared memory as bits. Bound:
//    operations (the recompute at the compute type's peak, the dX chain's
//    float32 products). Under MASKED a tile with no valid row writes zero
//    dx/dv rows and a 0 into its live flag, and skips its chain; every
//    other tile writes a 1.
//  * K2b (`fused_mlp_bwd_dw_kernel`): dW = A^T Z and db = sum Z for every
//    tensor of the flatten order, reduced over all rows of the chunk as
//    long-K products. Grid (job, split): a job is one DW_T x DW_T tile of
//    one [K, N] gradient (the bias rides with the k = 0 tile of the weight
//    that shares its Z); split s of S takes a contiguous share of the
//    chunk's live tiles, in order, so a dead tile adds nothing and costs
//    nothing. Each CTA streams one tile's A and Z columns at a time through
//    shared memory with cp.async (DW_STAGES stages), accumulates its output
//    tile in registers over thousands of rows (a sum per tile, added into a
//    running total) and writes it once into a [S, total] partial. Bound:
//    operations (1.19 MFLOP per live row at lego width), then the bytes of
//    the scratch (read about twice).
//  * `fused_mlp_reduce_kernel`: grad[j] = the sum over every chunk's and
//    split's partial of element j, in order.
//
// The float32 products of the dX chain and of K2b run as 3xTF32 on the
// tensor cores: each float32 operand is split into a TF32 high part and a
// remainder, and three mma.sync.m16n8k8 products (small terms first)
// replace one float32 product, CUTLASS's OpMultiplyAddFastF32 scheme. On
// the H100 that measured faster than float32 FMAs on the CUDA cores in both
// places (PERF.md). Plain 1xTF32 (~3 digits) is not used: it is not the
// float32 backward.
//
// No atomics: every sum runs in a fixed order, so two calls on the same
// inputs give bitwise-equal gradients. The host (ops/fused_mlp.
// mlp_backward) splits the rows into chunks of at most MAX_CHUNK_TILES
// tiles (the scratch holds one chunk: 2.8 GB at lego width), runs K2a + K2b
// per chunk into its own partials, and reduces once.
#include "mlp_rows.cuh"

namespace {

constexpr int MAX_PARAMS = 64;
constexpr int MAX_CHUNK_TILES = 2048;  // 131,072 rows
constexpr int DW_T = 128;              // K2b output tile: DW_T k x DW_T n
constexpr int DW_R = MLP_M;            // rows per streamed block: a tile
constexpr int DW_P = DW_T + 8;         // shared pitch (conflict-free mma reads)
constexpr int DW_STAGES = 3;
constexpr int DW_THREADS = 512;
constexpr int DW_BIAS_PAR = DW_THREADS / DW_T;  // row parities of the bias
constexpr int DW_STAGE_FLOATS = 2 * DW_R * DW_P;  // A and Z blocks

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

// float offsets of the operands inside one tile's block of the scratch;
// each operand is [MLP_M][width] row-major at the pitch of its shared-memory
// tile (width + MLP_PAD), so that one bulk copy moves a whole tile
struct GradScratch {
  long long act;  // D + 2 slots: the D trunk outputs, f, vh (W/2 wide)
  long long dz;   // D slots: dz_0 .. dz_{D-1}
  long long df;   // one slot
  long long dvh;  // one slot, W/2 wide
  long long x;    // [MLP_M][c_in_pad], pitch c_in_pad + MLP_PAD
  long long v;    // [MLP_M][c_views_pad], pitch c_views_pad + MLP_PAD
  long long d8;   // [MLP_M][8]: draw (* valid), zero past the real rows
  long long tile;  // floats per tile block
};

// floats of one [MLP_M, W] slot (pitch W + MLP_PAD)
__host__ __device__ inline long long slot_floats(const MlpDesc& md) {
  return static_cast<long long>(MLP_M) * (md.W + MLP_PAD);
}

__host__ __device__ inline GradScratch grad_scratch(const MlpDesc& md) {
  const long long M = MLP_M, slot = slot_floats(md);
  GradScratch g;
  long long o = 0;
  g.act = o;
  o += (md.D + 2) * slot;
  g.dz = o;
  o += md.D * slot;
  g.df = o;
  o += slot;
  g.dvh = o;
  o += slot;
  g.x = o;
  o += M * (md.c_in_pad + MLP_PAD);
  g.v = o;
  o += M * (md.c_views_pad + MLP_PAD);
  g.d8 = o;
  o += M * 8;
  g.tile = o;
  return g;
}

// one operand of a weight gradient: offset in the tile block, row pitch
struct GradOp {
  long long off;
  int ld;
};

// dW[K, N] = A^T Z over the rows (param index w), and db = sum Z (param
// index b, -1: the bias rides with another weight)
struct GradJob {
  GradOp a, z;
  int K, N, w, b;
};

// Finds the DW_T x DW_T tile `want` of the weight gradients, counted over
// the flatten order; `seen` ends as the number of tiles.
struct TilePicker {
  int want;
  int seen;
  bool found;
  GradJob j;
  int kt, nt;
  __host__ __device__ void add(GradOp a, GradOp z, int K, int N, int w,
                               int b) {
    const int nk = (K + DW_T - 1) / DW_T, nn = (N + DW_T - 1) / DW_T;
    if (!found && want >= seen && want < seen + nk * nn) {
      const int r = want - seen;
      kt = r / nn;
      nt = r - kt * nn;
      j = GradJob{a, z, K, N, w, b};
      found = true;
    }
    seen += nk * nn;
  }
};

// every weight tensor of the flatten order with its operands
__host__ __device__ inline void for_each_grad(const MlpDesc& md,
                                              TilePicker& f) {
  const GradScratch g = grad_scratch(md);
  const int W = md.W, W2 = md.W / 2, cin = md.c_in_pad, cvp = md.c_views_pad;
  const int ldh = W + MLP_PAD;
  const long long slot = slot_floats(md);
  const GradOp X{g.x, cin + MLP_PAD}, V{g.v, cvp + MLP_PAD}, D8{g.d8, 8},
      DF{g.df, ldh}, DVH{g.dvh, ldh};
  auto act = [&](int s) { return GradOp{g.act + s * slot, ldh}; };
  auto dz = [&](int i) { return GradOp{g.dz + i * slot, ldh}; };
  f.add(X, dz(0), cin, W, 0, 1);  // W0, b0
  int p = 2;
  for (int i = 1; i < md.D; ++i) {
    if (i == md.skip + 1) {
      f.add(X, dz(i), cin, W, p, -1);              // Wsx
      f.add(act(i - 1), dz(i), W, W, p + 1, p + 2);  // Wsh, bs
      p += 3;
    } else {
      f.add(act(i - 1), dz(i), W, W, p, p + 1);
      p += 2;
    }
  }
  f.add(act(md.D - 1), D8, W, 8, p, p + 1);      // Wa, ba
  f.add(act(md.D - 1), DF, W, W, p + 2, p + 3);  // Wf, bf
  f.add(act(md.D), DVH, W, W2, p + 4, p + 6);    // Wvf, bv
  f.add(V, DVH, cvp, W2, p + 5, -1);             // Wvv
  f.add(act(md.D + 1), D8, W2, 8, p + 7, p + 8);  // Wr, br
}

__host__ __device__ inline TilePicker pick_tile(const MlpDesc& md, int want) {
  TilePicker t{want, 0, false, {}, 0, 0};
  for_each_grad(md, t);
  return t;
}

// -- 3xTF32 on the tensor cores --------------------------------------------

// x = hi + lo: hi is x truncated to TF32 (its low 13 mantissa bits
// cleared), lo = x - hi exactly (|lo| < 2^-10 |x|); the tensor core reads
// lo's TF32 part (it ignores the low 13 bits), so hi + lo keeps ~21 bits of
// x. Two instructions, where rounding each part (cvt.rna) takes several.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- K2a ----------------------------------------------------------------------

// words of the relu-mask bits of one [MLP_M, W] activation: word (row,
// col / 32), bit col % 32, set when the activation is > 0
__host__ __device__ inline int mask_words(const MlpDesc& md) {
  return MLP_M * (md.W / 32);
}

// K2a's shared memory: K1's tile, then the mask bits of the D trunk outputs
__host__ __device__ inline size_t rows_smem_bytes(const MlpDesc& md) {
  return tile_smem_bytes(md) +
         static_cast<size_t>(md.D) * mask_words(md) * sizeof(uint32_t);
}

bool rows_shape_ok(const MlpDesc& md) {
  return shape_ok(md) && rows_smem_bytes(md) <= 232448;
}

// Copies `floats` contiguous floats of shared memory (a whole tile, pads
// included) to the scratch through the bulk-copy engine: asynchronous, no
// registers or load/store slots of the chain. All threads call it after
// writing the tile: each fences its shared writes for the async proxy, a
// barrier, then thread 0 issues one copy as one bulk group. floats * 4 is a
// multiple of 16.
__device__ __forceinline__ void save_tile(float* g, const float* src,
                                          long long floats) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
            "l"(g), "r"(s), "r"(static_cast<unsigned>(floats * 4))
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// waits until at most N of the latest save_tile copies still read shared
// memory, then a barrier: the tiles of the older ones may be overwritten
template <int N>
__device__ __forceinline__ void saved_read() {
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  __syncthreads();
}

// the relu-mask bits of a shared [MLP_M, W] activation (pitch ld); after a
// barrier that made the rows visible
__device__ __forceinline__ void relu_bits(const float* act, int ld, int W,
                                          uint32_t* bits) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpr = W / 32;
  for (int q = warp; q < MLP_M * wpr; q += MLP_WARPS) {
    const int row = q / wpr, c = q - row * wpr;
    const unsigned b =
        __ballot_sync(0xffffffffu, act[row * ld + 32 * c + lane] > 0.0f);
    if (lane == 0) bits[q] = b;
  }
}

// mlp_tile_forward (mlp_tile.cuh) with the backward's saves: each
// activation leaves for the scratch by save_tile as soon as it is in shared
// memory (slot s at save + s * slot_floats: the D trunk outputs, the
// feature, the views branch), the relu-mask bits of the trunk outputs stay
// in shared memory, and a buffer is overwritten only once its copy has read
// it. Returns the buffer that holds vh; the other one holds f.
template <typename CT>
__device__ float* forward_saving(const MlpDesc& md, const CT* __restrict__ ws,
                                 const float* __restrict__ wh,
                                 const float* xs, const float* vs, float* hA,
                                 float* hB, float* wst, float* raw,
                                 float* save, uint32_t* bits) {
  const int W = md.W, W2 = md.W / 2, cin = md.c_in_pad, cvp = md.c_views_pad;
  const int ldh = W + MLP_PAD, ldx = cin + MLP_PAD, ldv = cvp + MLP_PAD;
  const CT* p = ws;
  TileAcc<CT> acc;
  const long long tile = slot_floats(md);
  auto slot = [&](int s) { return save + s * tile; };

  zero_acc(acc.v);
  gemm_acc(acc.v, xs, ldx, cin, p, W, wst);
  p += static_cast<size_t>(cin) * W;
  store_act(acc.v, p, W, true, hA, ldh);
  p += W;
  save_tile(slot(0), hA, tile);
  relu_bits(hA, ldh, W, bits);
  float* cur = hA;
  float* nxt = hB;
  for (int i = 1; i < md.D; ++i) {
    zero_acc(acc.v);
    if (i == md.skip + 1) {
      gemm_acc(acc.v, xs, ldx, cin, p, W, wst);
      p += static_cast<size_t>(cin) * W;
    }
    gemm_acc(acc.v, cur, ldh, W, p, W, wst);
    p += static_cast<size_t>(W) * W;
    saved_read<1>();  // nxt's copy, two saves back
    store_act(acc.v, p, W, true, nxt, ldh);
    p += W;
    save_tile(slot(i), nxt, tile);
    relu_bits(nxt, ldh, W, bits + i * mask_words(md));
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // alpha head: column 3 of Wa / ba (save_tile's barrier made cur complete)
  head_f32(cur, ldh, W, wh, wh + W * 8, 3, 1, 3, raw);
  // feature (no activation) into nxt
  zero_acc(acc.v);
  gemm_acc(acc.v, cur, ldh, W, p, W, wst);
  p += static_cast<size_t>(W) * W;
  saved_read<1>();
  store_act(acc.v, p, W, false, nxt, ldh);
  p += W;
  save_tile(slot(md.D), nxt, tile);
  // views: relu(f @ Wvf + v @ Wvv + bv) into cur (the trunk output is dead:
  // gemm_acc's barriers order the alpha head's reads before these writes)
  zero_acc(acc.v);
  gemm_acc(acc.v, nxt, ldh, W, p, W2, wst);
  p += static_cast<size_t>(W) * W2;
  gemm_acc(acc.v, vs, ldv, cvp, p, W2, wst);
  p += static_cast<size_t>(cvp) * W2;
  saved_read<1>();
  store_act(acc.v, p, W2, true, cur, ldh);
  save_tile(slot(md.D + 1), cur, tile);
  // rgb head: columns 0-2 of Wr / br
  const float* wr = wh + W * 8 + 8;
  head_f32(cur, ldh, W2, wr, wr + W2 * 8, 0, 3, 0, raw);
  __syncthreads();
  return cur;
}

struct NoExtra {
  __device__ __forceinline__ float operator()(int, int, float a) const {
    return a;
  }
};

// the relu-mask bits of `n` columns from col (within one word) of a row;
// all set without a mask
__device__ __forceinline__ unsigned row_bits(const uint32_t* bits, int wpr,
                                             int row, int col, int n) {
  if (bits == nullptr) return (1u << n) - 1u;
  return (bits[row * wpr + (col >> 5)] >> (col & 31)) & ((1u << n) - 1u);
}

// The dX chain's products, dotT(dz, w) = dz @ w^T as
// acc = A[0:64, 0:K] @ Wg[0:K, 0:N] (Wg = w^T row-major, global), in
// 3xTF32, with their epilogues: store_dz (shared, relu mask, an extra term)
// and store_rows (dx / dv rows in global memory). Warp w owns rows
// 32(w & 1) .. +31 (2 m16 tiles) and columns 64(w >> 1) .. +63 (8 n8 tiles)
// of the [64, N] product. Weight slices [MLP_KS][N] are staged with
// cp.async at pitch N + 8 (conflict-free B fragments; A's pitch W + MLP_PAD
// is 8 mod 32 as well), two buffers in the staging region, as gemm_acc does
// (four buffers, three slices ahead, measured no faster on the H100).
struct DxTf32x3 {
  float acc[2][8][4];
  __device__ __forceinline__ void gemm(const float* A, int lda, int K,
                                       const float* __restrict__ Wg, int N,
                                       float* wst) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = 32 * (warp & 1), c0 = 64 * (warp >> 1);
    const bool active = c0 < N;  // warp-uniform
    const int ldb = N + 8, n4 = N / 4, ns = K / MLP_KS;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;
    auto stage = [&](int s) {
      float* dst = wst + (s & 1) * MLP_KS * ldb;
      const float* src = Wg + static_cast<size_t>(s) * MLP_KS * N;
      for (int e = threadIdx.x; e < MLP_KS * n4; e += MLP_THREADS) {
        const int r = e / n4, q = e - r * n4;
        cp_async16(dst + r * ldb + 4 * q, src + r * N + 4 * q);
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
      const float* bs = wst + (s & 1) * MLP_KS * ldb;
      if (active) {
#pragma unroll
        for (int kk = 0; kk < MLP_KS; kk += 8) {
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float* ap =
                A + (r0 + 16 * i + g) * lda + s * MLP_KS + kk + t;
            split_tf32(ap[0], ah[i][0], al[i][0]);            // (g, t)
            split_tf32(ap[8 * lda], ah[i][1], al[i][1]);      // (g + 8, t)
            split_tf32(ap[4], ah[i][2], al[i][2]);            // (g, t + 4)
            split_tf32(ap[8 * lda + 4], ah[i][3], al[i][3]);  // (g+8, t+4)
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = c0 + 8 * j;
            if (n >= N) break;
            const float* bp = bs + (kk + t) * ldb + n + g;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(bp[0], bh0, bl0);
            split_tf32(bp[4 * ldb], bh1, bl1);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_tf32(acc[i][j], al[i], bh0, bh1);
              mma_tf32(acc[i][j], ah[i], bl0, bl1);
              mma_tf32(acc[i][j], ah[i], bh0, bh1);
            }
          }
        }
      }
      __syncthreads();  // buffer s & 1 is free for slice s + 2
    }
  }
  template <typename Extra>
  __device__ __forceinline__ void store_dz(int N, const uint32_t* bits,
                                           int wpr, float* out, int ldo,
                                           Extra extra) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r0 = 32 * (warp & 1) + (lane >> 2), c0 = 64 * (warp >> 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + 8 * j + 2 * (lane & 3);
      if (col >= N) break;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 16 * i + 8 * h;
          const unsigned keep = row_bits(bits, wpr, row, col, 2);
          float v0 = extra(row, col, acc[i][j][2 * h]);
          float v1 = extra(row, col + 1, acc[i][j][2 * h + 1]);
          if (!(keep & 1u)) v0 = 0.0f;
          if (!(keep & 2u)) v1 = 0.0f;
          *reinterpret_cast<float2*>(out + row * ldo + col) =
              make_float2(v0, v1);
        }
      }
    }
  }
  __device__ __forceinline__ void store_rows(int N, float* __restrict__ out,
                                             int row0, int m,
                                             bool add) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r0 = 32 * (warp & 1) + (lane >> 2), c0 = 64 * (warp >> 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + 8 * j + 2 * (lane & 3);
      if (col >= N) break;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + r0 + 16 * i + 8 * h;
          if (row >= m) continue;
          float2* dst = reinterpret_cast<float2*>(
              out + static_cast<size_t>(row) * N + col);
          float2 val = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          if (add) {
            const float2 old = *dst;
            val.x = old.x + val.x;
            val.y = old.y + val.y;
          }
          *dst = val;
        }
      }
    }
  }
};

// K2a (MASKED = false, valid unused) and its K3b twin (MASKED = true). wt:
// every tensor of the flatten order as float32, 2-D ones transposed to
// [out, in] (the B operand of `dotT`); scratch: one GradScratch block per
// tile of this chunk, written only by bulk copies from shared memory; live:
// one flag per tile. Two shared [MLP_M, W] buffers alternate: each product
// writes the one whose copy is the older, after saved_read<1>.
template <typename CT, bool MASKED>
__global__ void __launch_bounds__(MLP_THREADS, 1)
    fused_mlp_bwd_rows_kernel(const float* __restrict__ x,
                              const float* __restrict__ v,
                              const float* __restrict__ valid,
                              const float* __restrict__ draw, int m,
                              MlpDesc md, const CT* __restrict__ ws,
                              const float* __restrict__ wh,
                              const float* __restrict__ wt, ParamOffsets po,
                              float* __restrict__ scratch,
                              int* __restrict__ live, float* __restrict__ dx,
                              float* __restrict__ dv) {
  extern __shared__ __align__(16) float smem[];
  const TileSmem s = carve(smem, md);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem) + tile_smem_bytes(md) / 4;
  const int W = md.W, W2 = md.W / 2, cin = md.c_in_pad, cvp = md.c_views_pad;
  const int ldh = W + MLP_PAD, ldx = cin + MLP_PAD, ldv = cvp + MLP_PAD;
  const int wpr = W / 32;
  const ParamIndex ix = param_index(md);
  const GradScratch gs = grad_scratch(md);
  const int tile_id = blockIdx.x, row0 = tile_id * MLP_M;
  if (MASKED && !tile_has_valid(valid, row0, m)) {
    // a dead tile: zero dx/dv rows, nothing into the scratch
    if (dx != nullptr) zero_rows(dx, cin, row0, m);
    if (dv != nullptr) zero_rows(dv, cvp, row0, m);
    if (threadIdx.x == 0) live[tile_id] = 0;
    return;
  }
  if (threadIdx.x == 0) live[tile_id] = 1;
  float* blk = scratch + static_cast<long long>(tile_id) * gs.tile;
  const long long tile = slot_floats(md);
  auto dzs = [&](int i) { return blk + gs.dz + i * tile; };
  const float* wa = wh;              // [W, 8]
  const float* wr = wh + W * 8 + 8;  // [W2, 8]
  DxTf32x3 p;  // the dX chain's products

  load_rows(s.xs, x, cin, row0, m);
  load_rows(s.vs, v, cvp, row0, m);
  for (int e = threadIdx.x; e < MLP_M * 8; e += MLP_THREADS) {
    const int r = e >> 3;
    float d = row0 + r < m ? draw[static_cast<size_t>(row0) * 8 + e] : 0.0f;
    if (MASKED && row0 + r < m) d = d * valid[row0 + r];  // draw * valid
    s.d8[e] = d;
  }
  save_tile(blk + gs.x, s.xs, MLP_M * ldx);
  save_tile(blk + gs.v, s.vs, MLP_M * ldv);
  save_tile(blk + gs.d8, s.d8, MLP_M * 8);
  // recompute: every activation leaves for the scratch; X holds vh, Y f
  float* X = forward_saving<CT>(md, ws, wh, s.xs, s.vs, s.b1, s.b2, s.wst,
                                s.raw, blk + gs.act, bits);
  float* Y = X == s.b1 ? s.b2 : s.b1;

  // rgb head: dvh = (draw @ Wr^T) * (vh > 0) into Y (f's copy has read it)
  saved_read<1>();
  for (int e = threadIdx.x; e < MLP_M * W2; e += MLP_THREADS) {
    const int r = e / W2, k = e - r * W2;
    float t = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) t = fmaf(s.d8[r * 8 + c], wr[k * 8 + c], t);
    Y[r * ldh + k] = X[r * ldh + k] > 0.0f ? t : 0.0f;
  }
  save_tile(blk + gs.dvh, Y, tile);

  // views branch: dv = dvh @ Wvv^T, df = dvh @ Wvf^T into X
  if (dv != nullptr) {
    p.gemm(Y, ldh, W2, wt + po.off[ix.wvv], cvp, s.wst);
    p.store_rows(cvp, dv, row0, m, false);
  }
  p.gemm(Y, ldh, W2, wt + po.off[ix.wvf], W, s.wst);
  saved_read<1>();
  p.store_dz(W, nullptr, 0, X, ldh, NoExtra());
  save_tile(blk + gs.df, X, tile);

  // feature + alpha heads: dz_{D-1} = (df @ Wf^T + draw @ Wa^T) masked by
  // the last trunk relu, into Y
  p.gemm(X, ldh, W, wt + po.off[ix.wf], W, s.wst);
  saved_read<1>();
  {
    const float* d8 = s.d8;
    p.store_dz(W, bits + (md.D - 1) * mask_words(md), wpr, Y, ldh,
               [d8, wa](int row, int col, float a) {
                 float t = 0.0f;
#pragma unroll
                 for (int c = 0; c < 8; ++c)
                   t = fmaf(d8[row * 8 + c], wa[col * 8 + c], t);
                 return a + t;
               });
  }
  save_tile(dzs(md.D - 1), Y, tile);

  // trunk in reverse: `cur` holds dz_i, dz_{i-1} goes to the other buffer
  float* cur = Y;
  float* nxt = X;
  int pi = po.n - 9;  // one past the last trunk tensor
  for (int i = md.D - 1; i >= 1; --i) {
    const bool skip = i == md.skip + 1;
    const int i_w = pi - 2, i_wx = skip ? pi - 3 : -1;
    pi -= skip ? 3 : 2;
    if (skip && dx != nullptr) {
      p.gemm(cur, ldh, W, wt + po.off[i_wx], cin, s.wst);
      p.store_rows(cin, dx, row0, m, false);
    }
    p.gemm(cur, ldh, W, wt + po.off[i_w], W, s.wst);
    saved_read<1>();
    p.store_dz(W, bits + (i - 1) * mask_words(md), wpr, nxt, ldh, NoExtra());
    save_tile(dzs(i - 1), nxt, tile);
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // first layer: dx += dz0 @ W0^T
  if (dx != nullptr) {
    p.gemm(cur, ldh, W, wt + po.off[ix.w0], cin, s.wst);
    p.store_rows(cin, dx, row0, m, md.skip >= 0);
  }
  // the copies must have read shared memory before the block leaves
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// -- K2b ----------------------------------------------------------------------

// Compacts the indices of the n live tiles (flag != 0) into list, in order;
// returns their count. All DW_THREADS threads call it.
__device__ int compact_live(const int* __restrict__ live, int n,
                            short* list) {
  __shared__ int warp_sum[DW_THREADS / 32];
  const int per = (n + DW_THREADS - 1) / DW_THREADS;
  const int beg = min(n, static_cast<int>(threadIdx.x) * per);
  const int end = min(n, beg + per);
  int c = 0;
  for (int i = beg; i < end; ++i) c += live[i] != 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  int base = 0, total = 0;
  for (int w = 0; w < DW_THREADS / 32; ++w) {
    if (w < warp) base += warp_sum[w];
    total += warp_sum[w];
  }
  int pos = base + x - c;
  for (int i = beg; i < end; ++i)
    if (live[i] != 0) list[pos++] = static_cast<short>(i);
  __syncthreads();
  return total;
}

// K2b's products, in 3xTF32. They sum hierarchically: each DW_R-row block
// into a fresh accumulator (`acc`), which is then added into the running
// total (`tot`) with a round-to-nearest float32 add. A single accumulator
// over thousands of rows drifts (the tensor cores' accumulation truncates),
// and the sum then depends on how the rows are split; block sums keep every
// grouping within ~1e-6. The tile's k rows are the mma's M, its n columns
// the mma's N, the streamed rows the mma's K. Warp w owns k rows
// 32(w & 3) .. +31 (2 m16 tiles) and n columns 32(w >> 2) .. +31 (4 n8
// tiles). Fragments are read from the row-major blocks transposed
// (A[m][k] = As[k][m]); the pitch DW_P = 8 mod 32 keeps the 32 lanes on 32
// banks.
struct DwTf32x3 {
  float acc[2][4][4], tot[2][4][4];
  int wk, wn, g, t;
  bool active;
  __device__ __forceinline__ void init(int kext, int next) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    wk = 32 * (warp & 3);
    wn = 32 * (warp >> 2);
    g = lane >> 2;
    t = lane & 3;
    active = wk < kext && wn < next;  // warp-uniform
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) tot[i][j][c] = 0.0f;
  }
  __device__ __forceinline__ void block(const float* As, const float* Zs) {
    if (!active) return;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DW_R; kk += 8) {
      const float* a_t = As + (kk + t) * DW_P + wk + g;
      const float* a_t4 = a_t + 4 * DW_P;
      const float* z_t = Zs + (kk + t) * DW_P + wn + g;
      const float* z_t4 = z_t + 4 * DW_P;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split_tf32(z_t[8 * j], bh[j][0], bl[j][0]);
        split_tf32(z_t4[8 * j], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t ah[4], al[4];
        split_tf32(a_t[16 * i], ah[0], al[0]);       // (g, t)
        split_tf32(a_t[16 * i + 8], ah[1], al[1]);   // (g + 8, t)
        split_tf32(a_t4[16 * i], ah[2], al[2]);      // (g, t + 4)
        split_tf32(a_t4[16 * i + 8], ah[3], al[3]);  // (g + 8, t + 4)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(acc[i][j], al, bh[j][0], bh[j][1]);
          mma_tf32(acc[i][j], ah, bl[j][0], bl[j][1]);
          mma_tf32(acc[i][j], ah, bh[j][0], bh[j][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) tot[i][j][c] = tot[i][j][c] + acc[i][j][c];
  }
  __device__ __forceinline__ void store(float* __restrict__ P, int N, int k0,
                                        int n0, int kext, int next) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + 8 * j + 2 * t;
        if (n >= next) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = wk + 16 * i + g + 8 * h;
          if (k >= kext) continue;
          *reinterpret_cast<float2*>(
              P + static_cast<long long>(k0 + k) * N + n0 + n) =
              make_float2(tot[i][j][2 * h], tot[i][j][2 * h + 1]);
        }
      }
    }
  }
};

size_t dw_smem_bytes() {
  return static_cast<size_t>(DW_STAGES) * DW_STAGE_FLOATS * sizeof(float) +
         DW_THREADS * sizeof(float) +      // bias parities
         MAX_CHUNK_TILES * sizeof(short);  // live list
}

// K2b: blockIdx.x picks the gradient tile (pick_tile), blockIdx.y the split
// of the chunk's live tiles; partials points at this chunk's first split
// ([gridDim.y, po.total]). Every element of a split's partial is written
// by exactly one CTA (zeros when its share of live tiles is empty).
__global__ void __launch_bounds__(DW_THREADS, 1)
    fused_mlp_bwd_dw_kernel(MlpDesc md, const float* __restrict__ scratch,
                            const int* __restrict__ live, int n_tiles,
                            ParamOffsets po, float* __restrict__ partials) {
  extern __shared__ __align__(16) float smem[];
  float* bias_par = smem + DW_STAGES * DW_STAGE_FLOATS;
  short* list = reinterpret_cast<short*>(bias_par + DW_THREADS);
  const TilePicker tp = pick_tile(md, blockIdx.x);
  const GradJob& jb = tp.j;
  const long long tile_floats = grad_scratch(md).tile;
  const int k0 = tp.kt * DW_T, n0 = tp.nt * DW_T;
  const int kext = min(DW_T, jb.K - k0), next = min(DW_T, jb.N - n0);
  const int ka = kext / 4, na = next / 4;
  const bool with_bias = jb.b >= 0 && tp.kt == 0;
  const int n_live = compact_live(live, n_tiles, list);
  const int S = gridDim.y, split = blockIdx.y;
  const int lo = static_cast<int>(static_cast<long long>(split) * n_live / S);
  const int hi =
      static_cast<int>(static_cast<long long>(split + 1) * n_live / S);
  const int n_blk = hi - lo;  // one DW_R-row block per tile
  const int tid = threadIdx.x;

  // block b of this split into stage st
  auto load = [&](int b, int st) {
    const int tile = list[lo + b];
    const float* base = scratch + tile * tile_floats;
    const float* A = base + jb.a.off + k0;
    const float* Z = base + jb.z.off + n0;
    float* As = smem + st * DW_STAGE_FLOATS;
    float* Zs = As + DW_R * DW_P;
    for (int e = tid; e < DW_R * ka; e += DW_THREADS) {
      const int r = e / ka, q = e - r * ka;
      cp_async16(As + r * DW_P + 4 * q, A + r * jb.a.ld + 4 * q);
    }
    for (int e = tid; e < DW_R * na; e += DW_THREADS) {
      const int r = e / na, q = e - r * na;
      cp_async16(Zs + r * DW_P + 4 * q, Z + r * jb.z.ld + 4 * q);
    }
  };

  DwTf32x3 tl;
  tl.init(kext, next);
  // the bias: thread tid sums column tid % DW_T over the rows r of parity
  // r % DW_BIAS_PAR = tid / DW_T, block by block as the tile; the parities
  // are added in order at the end
  const int bcol = tid % DW_T, bpar = tid / DW_T;
  const bool sums_bias = with_bias && bcol < next;
  float btot = 0.0f;
#pragma unroll
  for (int b = 0; b < DW_STAGES - 1; ++b) {
    if (b < n_blk) load(b, b);
    cp_async_commit();
  }
  for (int b = 0; b < n_blk; ++b) {
    cp_async_wait<DW_STAGES - 2>();
    __syncthreads();  // block b visible; the stage of block b - 1 is free
    const int nb = b + DW_STAGES - 1;
    if (nb < n_blk) load(nb, nb % DW_STAGES);
    cp_async_commit();
    const float* As = smem + (b % DW_STAGES) * DW_STAGE_FLOATS;
    const float* Zs = As + DW_R * DW_P;
    tl.block(As, Zs);
    if (sums_bias) {
      float blk = 0.0f;
      for (int r = bpar; r < DW_R; r += DW_BIAS_PAR)
        blk = blk + Zs[r * DW_P + bcol];
      btot = btot + blk;
    }
  }
  cp_async_wait<0>();
  float* P = partials + static_cast<long long>(split) * po.total;
  tl.store(P + po.off[jb.w], jb.N, k0, n0, kext, next);
  if (with_bias) {
    bias_par[tid] = btot;
    __syncthreads();
    if (tid < next) {
      float b = bias_par[tid];
      for (int q = 1; q < DW_BIAS_PAR; ++q) b = b + bias_par[q * DW_T + tid];
      P[po.off[jb.b] + n0 + tid] = b;
    }
  }
}

// grad[j] = sum over partials p, in order, of partials[p, j]
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

template <typename CT, bool MASKED>
int launch_rows(const float* x, const float* v, const float* valid,
                const float* draw, int m, const MlpDesc& md, const void* ws,
                const float* wh, const float* wt, float* scratch, int* live,
                float* dx, float* dv, cudaStream_t stream) {
  const size_t smem = rows_smem_bytes(md);
  cudaError_t e = cudaFuncSetAttribute(
      fused_mlp_bwd_rows_kernel<CT, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (m + MLP_M - 1) / MLP_M;
  fused_mlp_bwd_rows_kernel<CT, MASKED><<<blocks, MLP_THREADS, smem, stream>>>(
      x, v, valid, draw, m, md, static_cast<const CT*>(ws), wh, wt,
      param_offsets(md), scratch, live, dx, dv);
  return static_cast<int>(cudaGetLastError());
}

int launch_dw(int n_tiles, const MlpDesc& md, const float* scratch,
              const int* live, int splits, float* partials,
              cudaStream_t stream) {
  const size_t smem = dw_smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      fused_mlp_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(fused_mlp_bwd_dw_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(pick_tile(md, -1).seen, splits);
  fused_mlp_bwd_dw_kernel<<<grid, DW_THREADS, smem, stream>>>(
      md, scratch, live, n_tiles, param_offsets(md), partials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NRT_DEFINE_ERROR_STRING

// out[0]: floats of the scratch per 64-row tile; out[1]: K2b gradient tiles
// (jobs); out[2]: floats of one gradient partial (every tensor of the
// flatten order); out[3]: the most tiles a chunk may hold
extern "C" int nrt_fused_mlp_bwd_layout(const MlpDesc* md, long long* out) {
  if (!rows_shape_ok(*md)) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = grad_scratch(*md).tile;
  out[1] = pick_tile(*md, -1).seen;
  out[2] = param_offsets(*md).total;
  out[3] = MAX_CHUNK_TILES;
  return 0;
}

// K2a over the m rows of one chunk (K3b's twin when `valid` is given);
// dx / dv may be null (not asked for)
extern "C" int nrt_fused_mlp_bwd_rows(const float* x, const float* v,
                                      const float* valid, const float* draw,
                                      int m, const MlpDesc* md,
                                      const void* ws, int bf16,
                                      const float* wh, const float* wt,
                                      float* scratch, int* live, float* dx,
                                      float* dv, void* stream) {
  if (m <= 0) return 0;
  if (!rows_shape_ok(*md) || (m + MLP_M - 1) / MLP_M > MAX_CHUNK_TILES)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return valid ? launch_rows<__nv_bfloat16, true>(
                       x, v, valid, draw, m, *md, ws, wh, wt, scratch, live,
                       dx, dv, s)
                 : launch_rows<__nv_bfloat16, false>(
                       x, v, valid, draw, m, *md, ws, wh, wt, scratch, live,
                       dx, dv, s);
  return valid ? launch_rows<float, true>(x, v, valid, draw, m, *md, ws, wh,
                                          wt, scratch, live, dx, dv, s)
               : launch_rows<float, false>(x, v, valid, draw, m, *md, ws, wh,
                                           wt, scratch, live, dx, dv, s);
}

// K2b over the chunk K2a just wrote (m rows): `splits` partials from
// `partials` on
extern "C" int nrt_fused_mlp_bwd_dw(int m, const MlpDesc* md,
                                    const float* scratch, const int* live,
                                    int splits, float* partials,
                                    void* stream) {
  const int n_tiles = (m + MLP_M - 1) / MLP_M;
  if (m <= 0 || !shape_ok(*md) || n_tiles > MAX_CHUNK_TILES || splits < 1 ||
      splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_dw(n_tiles, *md, scratch, live, splits, partials,
                   static_cast<cudaStream_t>(stream));
}

// grad = the ordered sum of n_part partials
extern "C" int nrt_fused_mlp_bwd_reduce(const MlpDesc* md,
                                        const float* partials, int n_part,
                                        float* grad, void* stream) {
  if (!shape_ok(*md) || n_part < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = param_offsets(*md).total;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  fused_mlp_reduce_kernel<<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      partials, n_part, total, grad);
  return static_cast<int>(cudaGetLastError());
}
