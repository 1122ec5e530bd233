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
//  * K2a (`fused_mlp_bwd_rows_kernel`): one CTA per 64-row tile on the
//    Hopper chain of mlp_chain_sm90.cuh, the one K1 and K5 run: two
//    consumer warpgroups each take half of every product's columns (the
//    chain's kCols) with wgmma products, A from registers, while a producer
//    warpgroup gives its registers to them and one of its threads streams
//    the weights through a TMA ring of mbarrier stages (no consumer thread
//    copies a weight, no CTA-wide barrier per slice). It recomputes the
//    tile forward in the compute type — bf16 m64nNk16, or float32 as K1
//    computes it (3xTF32 into IEEE sums, so its relu masks are K1's) —
//    from pack_for_chain's image, keeping every activation in float32 for
//    the scratch. Then it runs the dX chain, dz @ w^T for the forward's
//    weights in reverse, as 3xTF32 wgmma products with the truncating split;
//    each w^T is split and packed once a call on the host
//    (ops/fused_mlp.pack_for_dx_chain) and streams after the forward's image
//    through the same ring (a bf16 weight's TF32 low part is zero: the bf16
//    family streams the high parts alone and reads the low one from zeros
//    in shared memory, half the bytes). The epilogues run from the
//    accumulators: bias, relu and the relu-mask bits (kept in shared memory
//    for the dX chain), the masked dz, the alpha head's draw @ Wa^T on
//    dz_{D-1}, dx / dv rows (only when asked for). It writes every float32
//    operand the weight gradients need to a global scratch, one block per
//    tile (GradScratch): the activations a_0 .. a_{D-1}, f, vh, the masked
//    cotangents dz_0 .. dz_{D-1}, df, dvh, and the tile's x, v and draw (*
//    valid), ~21.6 KB a row at lego width, written once, each tile by one
//    bulk copy from shared memory as soon as it is there. One activation
//    buffer, rewritten in place once both warpgroups' products and the copy
//    of what it held have read it; the shared memory a second one would
//    take goes to the ring.
//    Bound: operations (the recompute at the compute type's peak, the dX
//    chain's float32 products as three TF32 products), then the scratch
//    bytes (22.6 GB a lego step at 3.35 TB/s, ~0.8 of the operations'
//    time); the bulk copies overlap them with the products. Measured on the
//    H100, the ring sets the pace: about one 8 KB stage per ~950 cycles of
//    an SM, whether the stage feeds one bf16 product or three TF32 ones
//    (PERF.md). Under MASKED a
//    tile with no valid row writes zero dx/dv rows and a 0 into its live
//    flag, and skips its chain; every other tile writes a 1.
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
// remainder (chain::split_trunc), and three products (small terms first)
// replace one float32 product, CUTLASS's OpMultiplyAddFastF32 scheme: K2a's
// with wgmma m64nNk8, K2b's with mma.sync.m16n8k8. On the H100 that
// measured faster than float32 FMAs on the CUDA cores (PERF.md). Plain
// 1xTF32 (~3 digits) is not used: it is not the float32 backward.
//
// No atomics: every sum runs in a fixed order, so two calls on the same
// inputs give bitwise-equal gradients. The host (ops/fused_mlp.
// mlp_backward) splits the rows into chunks of at most MAX_CHUNK_TILES
// tiles (the scratch holds one chunk: 2.8 GB at lego width), runs K2a + K2b
// per chunk into its own partials, and reduces once.
#include <type_traits>

#include "mlp_chain_sm90.cuh"
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

// -- K2a ----------------------------------------------------------------------

using namespace chain;

// words of the relu-mask bits of one [MLP_M, W] activation: word (row,
// col / 32), bit col % 32, set when the activation is > 0
__host__ __device__ inline int mask_words(const MlpDesc& md) {
  return MLP_M * (md.W / 32);
}

// K2a's shared memory before the ring: the activation buffer H [MLP_M, W],
// x, v and draw of the tile (each at its scratch pitch, so that one bulk
// copy moves a tile), the D relu-mask tiles, and for the bf16 family the
// zero part its dX chain reads as B's low part (32 W bytes)
template <typename CT>
__host__ __device__ inline size_t rows_fixed_bytes(const MlpDesc& md) {
  const size_t floats =
      static_cast<size_t>(MLP_M) * ((md.W + MLP_PAD) +
                                    (md.c_in_pad + MLP_PAD) +
                                    (md.c_views_pad + MLP_PAD) + 8) +
      static_cast<size_t>(md.D) * mask_words(md) +
      (kDxParts<CT> == 1 ? 8 * md.W : 0);
  return (floats * 4 + 127) / 128 * 128;
}
template <typename CT>
int rows_stages(const MlpDesc& md) {
  const long long room = 232448 -
                         static_cast<long long>(rows_fixed_bytes<CT>(md)) -
                         2 * CH_MAX_STAGES * 8;
  const long long fit = room / CH_STAGE_BYTES;
  return static_cast<int>(fit < CH_MAX_STAGES ? fit : CH_MAX_STAGES);
}
// whether the ring holds a whole group of the dX chain's widest product
// (all its parts are waited for before its first product) and the
// recompute's CH_MIN_STAGES
template <typename CT>
bool rows_ring_ok(const MlpDesc& md) {
  const int group = kDxGroup * kDxParts<CT> * 32 * md.W / CH_STAGE_BYTES;
  return rows_stages<CT>(md) >= max(CH_MIN_STAGES, group);
}

// K2a's shapes: the chain's with D >= 2, and x / v widths whose dx / dv
// column halves are products of the chain (c_in_pad 32 or 64, c_views_pad
// 32), with a ring beside the buffers that rows_ring_ok takes (every D the
// chain takes: 14 stages float32, 13 bf16 at lego's shape)
bool rows_shape_ok(const MlpDesc& md) {
  return chain_shape_ok(md) && md.D >= 2 && md.c_in_pad % 32 == 0 &&
         md.c_views_pad == 32 && rows_ring_ok<float>(md) &&
         rows_ring_ok<__nv_bfloat16>(md);
}

// barrier among the consumers after each wrote its part of a tile in
// shared memory, with its writes fenced for the async proxy (the bulk copy)
__device__ __forceinline__ void publish() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumers_sync();
}
// thread 0: `floats` (a multiple of 4) contiguous floats of shared memory
// to global memory through the bulk-copy engine, in the open bulk group
__device__ __forceinline__ void bulk_store(float* g, const float* src,
                                           long long floats) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(g),
      "r"(smem_u32(src)), "r"(static_cast<unsigned>(floats * 4))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// before a write of H: every bulk copy has read its source, and both
// warpgroups' products have read H
__device__ __forceinline__ void copies_read() {
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  consumers_sync();
}

// dst[r, 0:C] (pitch C + MLP_PAD) = src[row0 + r, 0:C] for the MLP_M rows
// (zeros past m); the consumers' 256 threads
__device__ __forceinline__ void load_rows(float* dst, const float* src, int C,
                                          int row0, int m) {
  const int c4 = C / 4;
  for (int e = threadIdx.x; e < MLP_M * c4; e += CH_CONSUMERS) {
    const int r = e / c4, q = e - r * c4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < m)
      val = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row0 + r) * C + 4 * q);
    *reinterpret_cast<float4*>(dst + r * (C + MLP_PAD) + 4 * q) = val;
  }
}

// zero rows row0 .. row0 + MLP_M (those below m) of a global [M, C] array
__device__ __forceinline__ void zero_rows(float* __restrict__ out, int C,
                                          int row0, int m) {
  for (int e = threadIdx.x; e < MLP_M * C; e += blockDim.x)
    if (row0 + e / C < m) out[static_cast<size_t>(row0) * C + e] = 0.0f;
}

// The recompute's product in the compute type: float32 as K1 (3xTF32 into
// IEEE sums), bf16 from the float32 activations
template <typename CT, int NC>
__device__ __forceinline__ void fwd_gemm(float (&acc)[NC / 2], const float* A,
                                         int lda, int K, int N, int col0,
                                         bool accumulate, const Ring& r,
                                         RingPos& pos) {
  if constexpr (std::is_same<CT, float>::value)
    chain_gemm<float, NC, true>(acc, A, lda, K, N, col0, accumulate, r, pos);
  else
    bwd_gemm<false, NC>(acc, A, lda, K, N, col0, accumulate, 0, r, pos);
}

// An activation from the accumulator: v = acc + bias (relu'd when asked)
// into H at this warpgroup's columns, and with kBits its relu-mask words
// into `bits` (the four lanes of a row hold 8 bits of a word each j-group
// of four; NC a multiple of 32).
template <int NC, bool kBits>
__device__ __forceinline__ void act_epilogue(const float (&acc)[NC / 2],
                                             const float* __restrict__ bias,
                                             int col0, bool relu, float* H,
                                             int ldh, uint32_t* bits,
                                             int wpr) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;
  constexpr int kWords = kBits ? NC / 32 : 1;
  uint32_t w[2][kWords];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < kWords; ++q) w[h][q] = 0u;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int col = col0 + 8 * j + 2 * t;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h] + b0;
      float v1 = acc[4 * j + 2 * h + 1] + b1;
      if (relu) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      }
      store2(H + (r0 + 8 * h) * ldh + col, v0, v1);
      if constexpr (kBits)
        w[h][j / 4] |= (static_cast<uint32_t>(v0 > 0.0f) |
                        (static_cast<uint32_t>(v1 > 0.0f) << 1))
                       << (8 * (j % 4) + 2 * t);
    }
  }
  if constexpr (kBits) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        uint32_t b = w[h][q];
        b |= __shfl_xor_sync(0xffffffffu, b, 1);
        b |= __shfl_xor_sync(0xffffffffu, b, 2);
        if (t == 0) bits[(r0 + 8 * h) * wpr + col0 / 32 + q] = b;
      }
  }
}

struct NoExtra {
  __device__ __forceinline__ float operator()(int, int, float a) const {
    return a;
  }
};

// A cotangent from the accumulator: extra(row, col, acc), zeroed where the
// relu-mask bit is clear (no mask: `bits` null), into H
template <int NC, typename Extra>
__device__ __forceinline__ void dz_epilogue(const float (&acc)[NC / 2],
                                            int col0, const uint32_t* bits,
                                            int wpr, float* H, int ldh,
                                            Extra extra) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int col = col0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + g + 8 * h;
      float v0 = extra(row, col, acc[4 * j + 2 * h]);
      float v1 = extra(row, col + 1, acc[4 * j + 2 * h + 1]);
      if (bits != nullptr) {
        const unsigned keep = bits[row * wpr + (col >> 5)] >> (col & 31);
        if (!(keep & 1u)) v0 = 0.0f;
        if (!(keep & 2u)) v1 = 0.0f;
      }
      store2(H + row * ldh + col, v0, v1);
    }
  }
}

// dx / dv rows from the accumulator (those below m) into out [M, N];
// `add` adds them to what the same thread wrote there before
template <int NC>
__device__ __forceinline__ void store_rows(const float (&acc)[NC / 2],
                                           int col0, int N,
                                           float* __restrict__ out, int row0,
                                           int m, bool add) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int col = col0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * warp + g + 8 * h;
      if (row >= m) continue;
      float2* dst =
          reinterpret_cast<float2*>(out + static_cast<size_t>(row) * N + col);
      float2 val = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if (add) {
        const float2 old = *dst;
        val.x = old.x + val.x;
        val.y = old.y + val.y;
      }
      *dst = val;
    }
  }
}

// out rows = A (H, the tile's dz or dvh, K wide) @ the next product of the
// stream (K x N: dx or dv), each warpgroup half of the N columns
template <int NH>
__device__ __forceinline__ void rows_product(const float* A, int lda, int K,
                                             int N, float* out, int row0,
                                             int m, bool add, uint32_t zero_lo,
                                             const Ring& r, RingPos& pos) {
  const int col0 = (threadIdx.x >> 7) * NH;
  float acc[NH / 2];
  bwd_gemm<true, NH>(acc, A, lda, K, N, col0, false, zero_lo, r, pos);
  store_rows<NH>(acc, col0, N, out, row0, m, add);
}
__device__ __forceinline__ void dx_product(const float* A, int lda, int K,
                                           int N, float* out, int row0, int m,
                                           bool add, uint32_t zero_lo,
                                           const Ring& r, RingPos& pos) {
  if (N == 64)
    rows_product<32>(A, lda, K, N, out, row0, m, add, zero_lo, r, pos);
  else
    rows_product<16>(A, lda, K, N, out, row0, m, add, zero_lo, r, pos);
}

// K2a (MASKED = false, valid unused) and its K3b twin (MASKED = true), for
// a width W. wmat / bias / wh: pack_for_chain's weight image, biases and
// float32 heads; wdx: pack_for_dx_chain's image; scratch: one GradScratch
// block per tile of this chunk, written only by bulk copies from shared
// memory; live: one flag per tile. The consumers' warpgroup wg takes
// columns [wg W/2, (wg + 1) W/2) of every W-wide product (W/4 of the views),
// half of dx's and dv's.
template <typename CT, int W, bool MASKED>
__global__ void __launch_bounds__(CH_THREADS_WS, 1)
    fused_mlp_bwd_rows_kernel(const float* __restrict__ x,
                              const float* __restrict__ v,
                              const float* __restrict__ valid,
                              const float* __restrict__ draw, int m,
                              MlpDesc md,
                              const unsigned char* __restrict__ wmat,
                              const float* __restrict__ bias,
                              const float* __restrict__ wh,
                              const unsigned char* __restrict__ wdx,
                              int n_stages, float* __restrict__ scratch,
                              int* __restrict__ live, float* __restrict__ dx,
                              float* __restrict__ dv) {
  constexpr int W2 = W / 2, NC = W / 2, NV = W / 4;
  constexpr int ldh = W + MLP_PAD, wpr = W / 32;
  const int cin = md.c_in_pad, cvp = md.c_views_pad;
  const int ldx = cin + MLP_PAD, ldv = cvp + MLP_PAD;
  extern __shared__ __align__(128) unsigned char rows_smem[];
  float* H = reinterpret_cast<float*>(rows_smem);
  float* xs = H + MLP_M * ldh;
  float* vs = xs + MLP_M * ldx;
  float* d8 = vs + MLP_M * ldv;
  uint32_t* bits = reinterpret_cast<uint32_t*>(d8 + MLP_M * 8);
  float* zeros = reinterpret_cast<float*>(bits + md.D * mask_words(md));
  unsigned char* ring_mem = rows_smem + rows_fixed_bytes<CT>(md);
  Ring ring{reinterpret_cast<uint64_t*>(ring_mem + n_stages * CH_STAGE_BYTES),
            nullptr, smem_u32(ring_mem), n_stages};
  ring.empty = ring.full + n_stages;

  const int tid = threadIdx.x;
  const int tile_id = blockIdx.x, row0 = tile_id * MLP_M;
  if (MASKED) {
    const bool mine =
        tid < MLP_M && row0 + tid < m && valid[row0 + tid] != 0.0f;
    if (!__syncthreads_or(mine)) {  // block-uniform: a dead tile
      if (dx != nullptr) zero_rows(dx, cin, row0, m);
      if (dv != nullptr) zero_rows(dv, cvp, row0, m);
      if (tid == 0) live[tile_id] = 0;
      return;
    }
  }
  if (tid == 0) {
    live[tile_id] = 1;
    ring_init(ring);
  }
  __syncthreads();
  RingPos pos;
  if (tid >= CH_CONSUMERS) {  // the producer warpgroup: one thread copies
    producer_regs();
    if (tid == CH_CONSUMERS)
      produce_backward<CT>(md, wmat, wdx, dx != nullptr, dv != nullptr, ring,
                           pos);
    return;
  }
  consumer_regs();
  const int wg = tid >> 7;
  const int col0 = wg * NC, colv0 = wg * NV;
  const GradScratch gs = grad_scratch(md);
  float* blk = scratch + static_cast<long long>(tile_id) * gs.tile;
  const long long slot = slot_floats(md);
  // H's tile written: fence, barrier, its copy to `dst` as one bulk group
  auto save_h = [&](float* dst) {
    publish();
    if (tid == 0) {
      bulk_store(dst, H, slot);
      bulk_commit();
    }
  };

  // B's low part of the bf16 family's dX chain (32 W zero bytes)
  constexpr bool kZeroLo = kDxParts<CT> == 1;
  const uint32_t zero_lo = kZeroLo ? smem_u32(zeros) : 0u;
  if constexpr (kZeroLo)
    for (int e = tid; e < 8 * W; e += CH_CONSUMERS) zeros[e] = 0.0f;
  load_rows(xs, x, cin, row0, m);
  load_rows(vs, v, cvp, row0, m);
  for (int e = tid; e < MLP_M * 8; e += CH_CONSUMERS) {
    const int r = e >> 3;
    float d = row0 + r < m ? draw[static_cast<size_t>(row0) * 8 + e] : 0.0f;
    if (MASKED && row0 + r < m) d = d * valid[row0 + r];  // draw * valid
    d8[e] = d;
  }
  publish();
  if (tid == 0) {
    bulk_store(blk + gs.x, xs, MLP_M * ldx);
    bulk_store(blk + gs.v, vs, MLP_M * ldv);
    bulk_store(blk + gs.d8, d8, MLP_M * 8);
    bulk_commit();
  }

  // the recompute: every activation into H in place, then to the scratch
  float acc[NC / 2];
  const float* b = bias;
  fwd_gemm<CT, NC>(acc, xs, ldx, cin, W, col0, false, ring, pos);
  copies_read();
  act_epilogue<NC, true>(acc, b, col0, true, H, ldh, bits, wpr);
  save_h(blk + gs.act);
  b += W;
  for (int i = 1; i < md.D; ++i) {
    if (i == md.skip + 1) {
      fwd_gemm<CT, NC>(acc, xs, ldx, cin, W, col0, false, ring, pos);
      fwd_gemm<CT, NC>(acc, H, ldh, W, W, col0, true, ring, pos);
    } else {
      fwd_gemm<CT, NC>(acc, H, ldh, W, W, col0, false, ring, pos);
    }
    copies_read();
    act_epilogue<NC, true>(acc, b, col0, true, H, ldh,
                           bits + i * mask_words(md), wpr);
    save_h(blk + gs.act + i * slot);
    b += W;
  }
  // the feature (no activation)
  fwd_gemm<CT, NC>(acc, H, ldh, W, W, col0, false, ring, pos);
  copies_read();
  act_epilogue<NC, false>(acc, b, col0, false, H, ldh, nullptr, wpr);
  save_h(blk + gs.act + md.D * slot);
  b += W;
  // the views, vh = relu(f @ Wvf + v @ Wvv + bv), and from it the rgb
  // head's cotangent dvh = (draw @ Wr^T) * (vh > 0), kept in registers
  float dvh[NV / 2];
  {
    float accv[NV / 2];
    fwd_gemm<CT, NV>(accv, H, ldh, W, W2, colv0, false, ring, pos);
    fwd_gemm<CT, NV>(accv, vs, ldv, cvp, W2, colv0, true, ring, pos);
    copies_read();
    act_epilogue<NV, false>(accv, b, colv0, true, H, ldh, nullptr,
                           wpr);
    const float* wr = wh + W * 8 + 8;  // [W2, 8]
    const int lane = tid & 31, r0 = 16 * ((tid >> 5) & 3) + (lane >> 2);
#pragma unroll
    for (int j = 0; j < NV / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
          const int row = r0 + 8 * h, col = colv0 + 8 * j + 2 * (lane & 3) + c2;
          float s = 0.0f;
#pragma unroll
          for (int c = 0; c < 8; ++c)
            s = fmaf(d8[row * 8 + c], __ldg(wr + col * 8 + c), s);
          const int e = 4 * j + 2 * h + c2;
          dvh[e] = accv[e] + __ldg(b + col) > 0.0f ? s : 0.0f;
        }
      }
    }
  }
  save_h(blk + gs.act + (md.D + 1) * slot);
  copies_read();
  dz_epilogue<NV>(dvh, colv0, nullptr, wpr, H, ldh, NoExtra());
  save_h(blk + gs.dvh);

  // the dX chain: dv = dvh @ Wvv^T, df = dvh @ Wvf^T
  if (dv != nullptr)
    rows_product<16>(H, ldh, W2, cvp, dv, row0, m, false, zero_lo, ring,
                     pos);
  bwd_gemm<true, NC>(acc, H, ldh, W2, W, col0, false, zero_lo, ring, pos);
  copies_read();
  dz_epilogue<NC>(acc, col0, nullptr, wpr, H, ldh, NoExtra());
  save_h(blk + gs.df);
  // dz_{D-1} = (df @ Wf^T + draw @ Wa^T) masked by the last trunk relu
  bwd_gemm<true, NC>(acc, H, ldh, W, W, col0, false, zero_lo, ring, pos);
  copies_read();
  {
    const float* wa = wh;  // [W, 8]
    dz_epilogue<NC>(acc, col0, bits + (md.D - 1) * mask_words(md), wpr, H,
                    ldh, [d8, wa](int row, int col, float a) {
                      float s = 0.0f;
#pragma unroll
                      for (int c = 0; c < 8; ++c)
                        s = fmaf(d8[row * 8 + c], __ldg(wa + col * 8 + c), s);
                      return a + s;
                    });
  }
  save_h(blk + gs.dz + (md.D - 1) * slot);
  // the trunk in reverse: H holds dz_i, dz_{i-1} replaces it
  for (int i = md.D - 1; i >= 1; --i) {
    if (i == md.skip + 1 && dx != nullptr)
      dx_product(H, ldh, W, cin, dx, row0, m, false, zero_lo, ring, pos);
    bwd_gemm<true, NC>(acc, H, ldh, W, W, col0, false, zero_lo, ring, pos);
    copies_read();
    dz_epilogue<NC>(acc, col0, bits + (i - 1) * mask_words(md), wpr, H, ldh,
                    NoExtra());
    save_h(blk + gs.dz + (i - 1) * slot);
  }
  // first layer: dx (+)= dz_0 @ W0^T
  if (dx != nullptr)
    dx_product(H, ldh, W, cin, dx, row0, m, md.skip >= 0, zero_lo, ring,
               pos);
  // the copies must have read shared memory before the block leaves
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// -- K2b ----------------------------------------------------------------------

// one float32 product of K2b on the tensor cores, m16n8k8 in TF32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
        split_trunc(z_t[8 * j], bh[j][0], bl[j][0]);
        split_trunc(z_t4[8 * j], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t ah[4], al[4];
        split_trunc(a_t[16 * i], ah[0], al[0]);       // (g, t)
        split_trunc(a_t[16 * i + 8], ah[1], al[1]);   // (g + 8, t)
        split_trunc(a_t4[16 * i], ah[2], al[2]);      // (g, t + 4)
        split_trunc(a_t4[16 * i + 8], ah[3], al[3]);  // (g + 8, t + 4)
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

template <typename CT, int W, bool MASKED>
int launch_rows(const float* x, const float* v, const float* valid,
                const float* draw, int m, const MlpDesc& md, const void* wmat,
                const float* bias, const float* wh, const void* wdx,
                float* scratch, int* live, float* dx, float* dv,
                cudaStream_t stream) {
  const int ns = rows_stages<CT>(md);
  const size_t smem = rows_fixed_bytes<CT>(md) +
                      static_cast<size_t>(ns) * (CH_STAGE_BYTES + 16);
  auto kernel = fused_mlp_bwd_rows_kernel<CT, W, MASKED>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (m + MLP_M - 1) / MLP_M;
  kernel<<<blocks, CH_THREADS_WS, smem, stream>>>(
      x, v, valid, draw, m, md, static_cast<const unsigned char*>(wmat), bias,
      wh, static_cast<const unsigned char*>(wdx), ns, scratch, live, dx, dv);
  return static_cast<int>(cudaGetLastError());
}

// the rows kernel of md.W (a compile-time width, as K1's launch_width)
template <typename CT, bool MASKED>
int launch_rows_width(const float* x, const float* v, const float* valid,
                      const float* draw, int m, const MlpDesc& md,
                      const void* wmat, const float* bias, const float* wh,
                      const void* wdx, float* scratch, int* live, float* dx,
                      float* dv, cudaStream_t s) {
  switch (md.W) {
    case 64:
      return launch_rows<CT, 64, MASKED>(x, v, valid, draw, m, md, wmat, bias,
                                         wh, wdx, scratch, live, dx, dv, s);
    case 128:
      return launch_rows<CT, 128, MASKED>(x, v, valid, draw, m, md, wmat,
                                          bias, wh, wdx, scratch, live, dx,
                                          dv, s);
    case 192:
      return launch_rows<CT, 192, MASKED>(x, v, valid, draw, m, md, wmat,
                                          bias, wh, wdx, scratch, live, dx,
                                          dv, s);
    case 256:
      return launch_rows<CT, 256, MASKED>(x, v, valid, draw, m, md, wmat,
                                          bias, wh, wdx, scratch, live, dx,
                                          dv, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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

// K2a over the m rows of one chunk (K3b's twin when `valid` is given):
// `wmat` / `bias` / `wh` pack_for_chain's image, biases and heads, `wdx`
// pack_for_dx_chain's image; dx / dv may be null (not asked for)
extern "C" int nrt_fused_mlp_bwd_rows(const float* x, const float* v,
                                      const float* valid, const float* draw,
                                      int m, const MlpDesc* md,
                                      const void* wmat, const float* bias,
                                      int bf16, const float* wh,
                                      const void* wdx, float* scratch,
                                      int* live, float* dx, float* dv,
                                      void* stream) {
  if (m <= 0) return 0;
  if (!rows_shape_ok(*md) || (m + MLP_M - 1) / MLP_M > MAX_CHUNK_TILES)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return valid ? launch_rows_width<__nv_bfloat16, true>(
                       x, v, valid, draw, m, *md, wmat, bias, wh, wdx,
                       scratch, live, dx, dv, s)
                 : launch_rows_width<__nv_bfloat16, false>(
                       x, v, valid, draw, m, *md, wmat, bias, wh, wdx,
                       scratch, live, dx, dv, s);
  return valid ? launch_rows_width<float, true>(x, v, valid, draw, m, *md,
                                                wmat, bias, wh, wdx, scratch,
                                                live, dx, dv, s)
               : launch_rows_width<float, false>(x, v, valid, draw, m, *md,
                                                 wmat, bias, wh, wdx, scratch,
                                                 live, dx, dv, s);
}

// K2b over the chunk K2a just wrote (m rows): `splits` partials from
// `partials` on
extern "C" int nrt_fused_mlp_bwd_dw(int m, const MlpDesc* md,
                                    const float* scratch, const int* live,
                                    int splits, float* partials,
                                    void* stream) {
  const int n_tiles = (m + MLP_M - 1) / MLP_M;
  if (m <= 0 || !rows_shape_ok(*md) || n_tiles > MAX_CHUNK_TILES ||
      splits < 1 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_dw(n_tiles, *md, scratch, live, splits, partials,
                   static_cast<cudaStream_t>(stream));
}

// grad = the ordered sum of n_part partials
extern "C" int nrt_fused_mlp_bwd_reduce(const MlpDesc* md,
                                        const float* partials, int n_part,
                                        float* grad, void* stream) {
  if (!rows_shape_ok(*md) || n_part < 1)
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
