// The fused NeRF-MLP forward chain for Hopper: K1/K3a (fused_mlp.cu), K5
// (fused_march_full.cu) and K2a's recompute and dX chain (fused_mlp_bwd.cu)
// run it in both families.
//
// It computes what the TPU tile body `_forward_tile` (nerf_replication_tpu/
// ops/fused_mlp.py:183) computes, with its rounding points: operands rounded
// to the compute type CT (float, or __nv_bfloat16), float32 accumulation,
// float32 activations between layers (bf16 family: rounded to bf16 where
// they are stored, since they are only ever read again as bf16 operands),
// biases rounded to CT, the alpha and rgb heads in float32 on the float32
// activations, raw = rgb8 + alpha8 (the caller adds the head biases).
//
// Design (the bound is the products: 1.19 MFLOP a row at lego width):
//  * Products on the tensor cores with `wgmma.mma_async` (wgmma.cuh), A
//    (activations) from registers, B (weights) from shared memory, the sum
//    in registers. Each of two consumer warpgroups issues them for 64 rows.
//    bf16: m64nNk16. float32: 3xTF32 with m64nNk8, a_lo b_hi + a_hi b_lo +
//    a_hi b_hi (small terms first) into one accumulator (K5), or (K1/K3a,
//    kSums) into a partial sum over kPromote k-steps, then added into an
//    IEEE float32 sum (the tensor cores' own sums round toward zero;
//    chain_gemm), which takes a column split (kCols) for the registers of
//    both: x ~ hi + lo
//    with hi = x rounded to TF32 to nearest, lo = x - hi (split_tf32
//    below; the weights' lo rounded too), ~22 unbiased bits an operand.
//    K2a's dX chain (fused_mlp_bwd.cu, the backward's pieces at the end)
//    runs on the same ring and products with K2's truncating split:
//    measured against float64 it is as close as the plain version.
//    Weights are split once, on the host, at pack time (ops/fused_mlp.
//    pack_for_chain; splitting each staged slice in shared memory by
//    producer warps halves the L2 stream but measured slower on the H100);
//    an activation once per element as its A fragment goes into registers.
//  * Weights through the TMA engine. Host-packed in exactly the
//    shared-memory image the products read (below), they stream through a
//    ring of CH_STAGE_BYTES stages: one producer warp issues one
//    `cp.async.bulk` per stage against a `full` mbarrier (transaction
//    bytes), consumers free a stage with an arrive on its `empty` mbarrier
//    once the products that read it have retired. No consumer thread
//    spends an instruction on a copy and there is no CTA-wide barrier per
//    slice.
//  * Accumulators in registers: the epilogue (bias, relu, the activation
//    written back in place, the float32 heads from the accumulators of the
//    last trunk layer and of the view layer) runs from them. One activation
//    buffer: a warp reads (as A fragments) and writes (from its
//    accumulator rows) the same 16 rows.
//  * Two split modes. kCols = false (K1/K3a bf16): each consumer warpgroup
//    owns 64 rows and every column, so a CTA takes 128 rows per weight pass
//    and the warpgroups never wait for each other. kCols = true (K5, whose
//    rounds are 64 rows, and the float32 family of K1/K3a, whose promoted
//    sums need the registers): both warpgroups take the same 64 rows, each
//    half of every layer's columns; two 256-thread barriers a layer order
//    the in-place rewrite, and the heads' halves are summed by the caller.
//
// Weight stream (pack_for_chain): for each product of the chain in order —
// layer 0 (x: K = c_in_pad, N = W); trunk layer i (the skip layer first x,
// then h); the feature (W, W); the views (f: W, W/2; v: c_views_pad, W/2) —
// its k-steps in order (8 k a step for float32, 16 for bf16), each step as
// parts of N x 32 bytes (float32: a TF32-high part, then a low part; bf16:
// one part). A part is B [N][32 bytes], K-major, in the no-swizzle core
// matrix layout: byte (kh * N + n) * 16 + e holds the element of row n and
// byte 16 kh + e of the step's 32 bytes; its descriptor has LBO = 16 N
// bytes (the two 16-byte halves of K) and SBO = 128 bytes (eight rows). A
// stage holds P = CH_STAGE_BYTES / (32 N) consecutive parts of one product
// (fewer at its end); producer and consumers walk the same sequence.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace chain {

constexpr int CH_M = 64;                  // rows of one consumer warpgroup
constexpr int CH_CONSUMERS = 256;         // two consumer warpgroups
constexpr int CH_THREADS = CH_CONSUMERS + 32;  // + the producer warp
// + a whole producer warpgroup, which can hand its registers to the
// consumers (setmaxnreg: 40 a producer thread, 232 a consumer thread)
constexpr int CH_THREADS_WS = CH_CONSUMERS + 128;
constexpr int CH_STAGE_BYTES = 8192;
// a float32 step at N = 256 takes 2 stages, and each warpgroup holds the
// stages of its current step: 4 keep both going
constexpr int CH_MIN_STAGES = 4;
constexpr int CH_MAX_STAGES = 16;
constexpr int CH_PAD_BYTES = 16;  // per activation row: conflict-free A loads
// float32: k-steps whose products the tensor cores sum before an IEEE add
// (4: each 256-long product's 96 tensor-core adds fall to 8 float32 adds
// plus 12-add partial sums, 1/64 of the truncation bias)
constexpr int kPromote = 4;
// float32 IEEE sums: k-steps issued between two waits for the products
// (every K of the chain is a multiple of 16, two float32 k-steps; 2
// measured 1.46 ms for K1 at 65,573 rows against 1.82 with 1, and 4, with
// a guard for a short last group, spilled and ran 1.93)
constexpr int kGroup = 2;

// per family: the type activations are stored in, k per step, parts per
// step, padding elements per row
template <typename CT>
struct Fam {
  using AT = float;
  static constexpr int kStep = 8;
  static constexpr int kParts = 2;
  static constexpr int kPad = CH_PAD_BYTES / 4;
};
template <>
struct Fam<__nv_bfloat16> {
  using AT = __nv_bfloat16;
  static constexpr int kStep = 16;
  static constexpr int kParts = 1;
  static constexpr int kPad = CH_PAD_BYTES / 2;
};

// -- mbarriers and the bulk copy ---------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, through the TMA engine; completes as transaction bytes on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// B's descriptor: no swizzle, LBO = 16 N bytes, SBO = 128 bytes
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, int N) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(N) << 16) |  // (16 N) >> 4
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// float32 x as TF32, rounded to nearest (ties away from zero, cvt.rna's
// rule): half a TF32 ulp added to the magnitude bits, the low 13 cleared
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with hi = x rounded to TF32 (to nearest) and lo = x - hi
// exactly; the tensor core reads lo's TF32 part, truncating it, which is
// unbiased here since a rounded hi leaves lo of either sign: ~22 bits of x
// with no sign bias. (A truncated hi made every operand smaller, a bias no
// dot product cancels and that compounds over the chain's products.)
// Rounding lo as well (as pack_for_chain does for the weights, for free)
// measured no closer on a CPU emulation of the chain.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// register hand-over between warpgroups (all threads of a warpgroup)
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// barriers among the consumers alone (the producer warp is elsewhere)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// -- the ring ------------------------------------------------------------------

struct Ring {
  uint64_t* full;   // [ns], count 1 + transaction bytes
  uint64_t* empty;  // [ns], count 2 (one arrive per consumer warpgroup)
  uint32_t base;    // shared address of stage 0
  int ns;
};

// the stages a thread has taken (q) and freed (rel) so far; every consumer
// thread keeps its own copy, all walk the same sequence
struct RingPos {
  int q = 0, rel = 0;
};

// one thread: set up the barriers (then a CTA barrier before any use)
__device__ __forceinline__ void ring_init(const Ring& r) {
  for (int s = 0; s < r.ns; ++s) {
    mbar_init(&r.full[s], 1);
    mbar_init(&r.empty[s], 2);
  }
  mbar_init_fence();
}

// every product of the chain, in stream order: f(K, N)
template <class F>
__device__ __forceinline__ void for_each_product(const MlpDesc& md, F&& f) {
  const int W = md.W, cin = md.c_in_pad;
  f(cin, W);
  for (int i = 1; i < md.D; ++i) {
    if (i == md.skip + 1) f(cin, W);
    f(W, W);
  }
  f(W, W);
  f(W, W / 2);
  f(md.c_views_pad, W / 2);
}

// The producer's part of one product with N columns: its `parts` parts of
// 32 N bytes at `w` through the ring, P parts a stage. Returns the end of
// the product's image.
__device__ __forceinline__ const unsigned char* produce_product(
    int parts, int N, const unsigned char* w, const Ring& r, RingPos& pos) {
  const int part = 32 * N;
  const int per = CH_STAGE_BYTES / part;
  for (int p0 = 0; p0 < parts; p0 += per) {
    const unsigned bytes = static_cast<unsigned>(min(per, parts - p0) * part);
    const int slot = pos.q % r.ns;
    mbar_wait(&r.empty[slot], ((pos.q / r.ns) & 1) ^ 1);
    mbar_expect_tx(&r.full[slot], bytes);
    bulk_load(r.base + slot * CH_STAGE_BYTES, w, bytes, &r.full[slot]);
    w += bytes;
    ++pos.q;
  }
  return w;
}

// The producer: one lane streams one whole pass of the weights
// (`w`, pack_for_chain's image) through the ring.
template <typename CT>
__device__ void produce_pass(const MlpDesc& md, const unsigned char* w,
                             const Ring& r, RingPos& pos) {
  for_each_product(md, [&](int K, int N) {
    w = produce_product(Fam<CT>::kParts * K / Fam<CT>::kStep, N, w, r, pos);
  });
}

// frees stages [pos.rel, upto): one arrive per consumer warpgroup
__device__ __forceinline__ void release_upto(const Ring& r, RingPos& pos,
                                             int upto) {
  for (; pos.rel < upto; ++pos.rel)
    if ((threadIdx.x & 127) == 0) mbar_arrive(&r.empty[pos.rel % r.ns]);
}

// acc (+)= A[rows of this warpgroup, 0:K] @ B[0:K, col0:col0 + NC] where B is
// the next product of the stream (K x N). A is in shared memory (type AT,
// row pitch lda, row 0 = the warpgroup's first row). `accumulate` adds to
// acc (the skip layer's and the views' second product), else overwrites.
// kSums (float32): acc is an IEEE float32 sum of tensor-core partial sums
// over kPromote k-steps, not the tensor cores' own accumulator.
template <typename CT, int NC, bool kSums>
__device__ __forceinline__ void chain_gemm(float (&acc)[NC / 2],
                                           const typename Fam<CT>::AT* A,
                                           int lda, int K, int N, int col0,
                                           bool accumulate, const Ring& r,
                                           RingPos& pos) {
  constexpr int kStep = Fam<CT>::kStep, kParts = Fam<CT>::kParts;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int per = CH_STAGE_BYTES / (32 * N);
  const auto* row0 = A + (16 * warp + g) * lda;
  const auto* row1 = row0 + 8 * lda;
  // the A fragment of the step at k0: float32 as TF32 (hi, lo) pairs, bf16
  // as four bf16 pairs
  auto load_a = [&](int k0, uint32_t (&a)[kParts][4]) {
    if constexpr (kParts == 2) {
      split_tf32(row0[k0 + t], a[0][0], a[1][0]);
      split_tf32(row1[k0 + t], a[0][1], a[1][1]);
      split_tf32(row0[k0 + t + 4], a[0][2], a[1][2]);
      split_tf32(row1[k0 + t + 4], a[0][3], a[1][3]);
    } else {
      a[0][0] = *reinterpret_cast<const uint32_t*>(row0 + k0 + 2 * t);
      a[0][1] = *reinterpret_cast<const uint32_t*>(row1 + k0 + 2 * t);
      a[0][2] = *reinterpret_cast<const uint32_t*>(row0 + k0 + 8 + 2 * t);
      a[0][3] = *reinterpret_cast<const uint32_t*>(row1 + k0 + 8 + 2 * t);
    }
  };
  int part_i = 0;
  uint32_t stage = 0;
  // the next part of the stream (its shared address at this warpgroup's
  // columns), waiting for its stage to arrive
  auto next_part = [&]() {
    if (part_i % per == 0) {
      const int slot = pos.q % r.ns;
      mbar_wait(&r.full[slot], (pos.q / r.ns) & 1);
      stage = r.base + slot * CH_STAGE_BYTES;
      ++pos.q;
    }
    const uint32_t addr = stage + (part_i % per) * 32 * N + 16 * col0;
    ++part_i;
    return addr;
  };
  if constexpr (kSums) {
    // float32 into IEEE sums: the products of kPromote k-steps into
    // `part`, which is then added into acc with IEEE float32 adds (the
    // tensor cores round their own sums toward zero, and 96 such adds into
    // one accumulator a 256-long product drifted each layer by ~1e-6: K1
    // sat 1.1-1.4e-5 of max|raw| from float64 on trained weights). A
    // column split keeps `part` in registers beside acc (NC <= 128), and
    // kGroup k-steps go out between waits: their A fragments are all
    // loaded before the first product, so none is rewritten in flight
    static_assert(kParts == 2 && NC <= 128 && kPromote % kGroup == 0,
                  "IEEE sums: the float32 family with a column split");
    float part[NC / 2];
    bool fresh = !accumulate;
    for (int k0 = 0; k0 < K; k0 += kGroup * kStep) {
      uint32_t a[kGroup][kParts][4];
      uint64_t dh[kGroup], dl[kGroup];
#pragma unroll
      for (int gi = 0; gi < kGroup; ++gi) {
        load_a(k0 + gi * kStep, a[gi]);
        dh[gi] = b_desc(next_part(), N);
        dl[gi] = b_desc(next_part(), N);
      }
      const int ps = (k0 / kStep) % kPromote;
      wgmma_fence();
#pragma unroll
      for (int gi = 0; gi < kGroup; ++gi) {  // small terms first
        wgmma_tf32<NC>(part, a[gi][1], dh[gi], ps + gi == 0 ? 0 : 1);
        wgmma_tf32<NC>(part, a[gi][0], dl[gi], 1);
        wgmma_tf32<NC>(part, a[gi][0], dh[gi], 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (ps + kGroup == kPromote || k0 + kGroup * kStep >= K) {
        fence_regs<NC / 2>(part);
#pragma unroll
        for (int i = 0; i < NC / 2; ++i)
          acc[i] = fresh ? part[i] : __fadd_rn(acc[i], part[i]);
        fresh = false;
      }
      release_upto(r, pos, part_i % per == 0 ? pos.q : pos.q - 1);
    }
  } else {
    uint32_t cur[kParts][4];
    for (int k0 = 0; k0 < K; k0 += kStep) {
      load_a(k0, cur);
      uint32_t bpart[kParts];
#pragma unroll
      for (int p = 0; p < kParts; ++p) bpart[p] = next_part();
      const int scale = (accumulate || k0 > 0) ? 1 : 0;
      wgmma_fence();
      if constexpr (kParts == 2) {  // float32: 3xTF32, small terms first
        const uint64_t dh = b_desc(bpart[0], N), dl = b_desc(bpart[1], N);
        wgmma_tf32<NC>(acc, cur[1], dh, scale);
        wgmma_tf32<NC>(acc, cur[0], dl, 1);
        wgmma_tf32<NC>(acc, cur[0], dh, 1);
      } else {  // bf16
        wgmma_bf16<NC>(acc, cur[0], b_desc(bpart[0], N), scale);
      }
      wgmma_commit();
      // retire the products before the next step writes A registers: they
      // read theirs asynchronously, and the compiler may give the next
      // fragment the same registers (loading it during the products
      // measured wrong results)
      wgmma_wait<0>();
      // free every stage this warpgroup has read to its end, at once: the
      // producer refills it while the next steps run
      release_upto(r, pos, part_i % per == 0 ? pos.q : pos.q - 1);
    }
  }
  fence_regs<NC / 2>(acc);
  release_upto(r, pos, pos.q);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Epilogue of one layer from the accumulator: v = acc + bias (relu'd when
// asked) into H (in place, with `store`), and with NH > 0 each row's
// partial sum sum_col v * head[col * 8 + hc] for hc in [hc0, hc0 + NH) into
// out[2][0:NH] (rows g and g + 8 of the warp), summed over the four lanes
// of a row.
template <typename AT, int NC, int NH>
__device__ __forceinline__ void epilogue(const float (&acc)[NC / 2],
                                         const float* __restrict__ bias,
                                         int col0, bool relu, bool store,
                                         AT* H, int ldh,
                                         const float* __restrict__ head,
                                         int hc0, float (&out)[2][3]) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 3; ++c) out[h][c] = 0.0f;
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
      if (store) store2(H + (r0 + 8 * h) * ldh + col, v0, v1);
#pragma unroll
      for (int c = 0; c < NH; ++c)
          out[h][c] = fmaf(v1, __ldg(head + (col + 1) * 8 + hc0 + c),
                           fmaf(v0, __ldg(head + col * 8 + hc0 + c),
                                out[h][c]));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < NH; ++c) {
      out[h][c] += __shfl_xor_sync(0xffffffffu, out[h][c], 1);
      out[h][c] += __shfl_xor_sync(0xffffffffu, out[h][c], 2);
    }
}

// What the chain returns to each thread: the float32 head sums (before
// their biases) of rows 16 w + g (index 0) and + 8 (index 1) of its
// warpgroup, over the warpgroup's columns (all columns unless kCols).
struct HeadOut {
  float alpha[2];   // Wa column 3
  float rgb[2][3];  // Wr columns 0-2
};

// The whole MLP on 64 rows per consumer warpgroup (kCols: the same 64 rows
// for both, each half the columns); kSums as chain_gemm's. xs [.., c_in_pad] / vs [.., c_views_pad]
// / H [.., W] in shared memory as AT (pitches ldx / ldv / ldh, row 0 = the
// warpgroup's first row), written before the call and visible to the
// warpgroup (kCols: to both); `bias` every bias of the stream order as
// float32 (rounded to CT), `wh` the float32 heads [Wa (W x 8), ba (8), Wr
// (W/2 x 8), br (8)]. Consumer threads (< CH_CONSUMERS) call it while the
// producer warp runs produce_pass.
template <typename CT, int W, bool kCols, bool kSums>
__device__ HeadOut chain_forward(const MlpDesc& md,
                                 const float* __restrict__ bias,
                                 const float* __restrict__ wh,
                                 const typename Fam<CT>::AT* xs, int ldx,
                                 const typename Fam<CT>::AT* vs, int ldv,
                                 typename Fam<CT>::AT* H, int ldh,
                                 const Ring& r, RingPos& pos) {
  constexpr int W2 = W / 2;
  constexpr int NC = kCols ? W / 2 : W;
  constexpr int NV = kCols ? W2 / 2 : W2;
  const int wg = threadIdx.x >> 7;
  const int col0 = kCols ? wg * NC : 0;
  const int colv0 = kCols ? wg * NV : 0;
  const int cin = md.c_in_pad;
  auto reads_done = [&] {
    if (kCols) consumers_sync();
    else __syncwarp();
  };
  HeadOut out;
  float hs[2][3];
  float acc[NC / 2];
  chain_gemm<CT, NC, kSums>(acc, xs, ldx, cin, W, col0, false, r, pos);
  using AT = typename Fam<CT>::AT;
  reads_done();
  if (md.D == 1) {  // layer 0 is the last trunk layer
    epilogue<AT, NC, 1>(acc, bias, col0, true, true, H, ldh, wh, 3, hs);
    out.alpha[0] = hs[0][0];
    out.alpha[1] = hs[1][0];
  } else {
    epilogue<AT, NC, 0>(acc, bias, col0, true, true, H, ldh, nullptr, 0, hs);
  }
  reads_done();
  const float* b = bias + W;
  for (int i = 1; i < md.D; ++i) {
    if (i == md.skip + 1) {
      chain_gemm<CT, NC, kSums>(acc, xs, ldx, cin, W, col0, false, r, pos);
      chain_gemm<CT, NC, kSums>(acc, H, ldh, W, W, col0, true, r, pos);
    } else {
      chain_gemm<CT, NC, kSums>(acc, H, ldh, W, W, col0, false, r, pos);
    }
    reads_done();
    if (i == md.D - 1) {  // the last trunk output feeds the alpha head
      epilogue<AT, NC, 1>(acc, b, col0, true, true, H, ldh, wh, 3, hs);
      out.alpha[0] = hs[0][0];
      out.alpha[1] = hs[1][0];
    } else {
      epilogue<AT, NC, 0>(acc, b, col0, true, true, H, ldh, nullptr, 0, hs);
    }
    b += W;
    reads_done();
  }
  // the feature (no activation), in place
  chain_gemm<CT, NC, kSums>(acc, H, ldh, W, W, col0, false, r, pos);
  reads_done();
  epilogue<AT, NC, 0>(acc, b, col0, false, true, H, ldh, nullptr, 0, hs);
  b += W;
  reads_done();
  // the views: relu(f @ Wvf + v @ Wvv + bv), into the rgb head only
  float accv[NV / 2];
  chain_gemm<CT, NV, kSums>(accv, H, ldh, W, W2, colv0, false, r, pos);
  chain_gemm<CT, NV, kSums>(accv, vs, ldv, md.c_views_pad, W2, colv0, true,
                            r, pos);
  epilogue<AT, NV, 3>(accv, b, colv0, true, false, H, ldh, wh + W * 8 + 8,
                      0, out.rgb);
  return out;
}

// shared bytes of the activation buffers of `rows` rows: H, xs, vs
template <typename CT>
__host__ __device__ inline size_t act_bytes(const MlpDesc& md, int rows) {
  constexpr int pad = Fam<CT>::kPad;
  return static_cast<size_t>(rows) * sizeof(typename Fam<CT>::AT) *
         ((md.W + pad) + (md.c_in_pad + pad) + (md.c_views_pad + pad));
}

// the chain's shapes: W a multiple of 64 up to 256, c_in_pad <= 64 and
// c_views_pad <= 32 in multiples of 16 (a bf16 k-step), 1 <= D <= 24, a
// skip that feeds a later trunk layer (or none)
inline bool chain_shape_ok(const MlpDesc& md) {
  return md.D >= 1 && md.D <= 24 && md.W % 64 == 0 && md.W >= 64 &&
         md.W <= 256 && md.c_in_pad % 16 == 0 && md.c_in_pad > 0 &&
         md.c_in_pad <= 64 && md.c_views_pad % 16 == 0 &&
         md.c_views_pad > 0 && md.c_views_pad <= 32 && md.skip < md.D - 1;
}

// -- the backward's pieces (K2a, fused_mlp_bwd.cu) ----------------------------
//
// K2a recomputes the forward through the chain (chain_gemm for float32,
// bwd_gemm<false> for bf16: its activations stay float32 in shared memory
// for the scratch, rounded to bf16 as each A fragment is loaded, where K1
// rounds them as it stores them) and then runs the dX chain: dz @ w^T for
// the weights of the forward in reverse, in 3xTF32 (bwd_gemm<true>). The
// dX chain's weights are one more image (ops/fused_mlp.pack_for_dx_chain):
// for every product of for_each_product, in that order, w^T (K = the
// product's N, N = its K) in the float32 layout above, split truncating
// (hi = w with its low 13 mantissa bits cleared, lo = w - hi) as K2's
// products always split; the producer streams the forward's image, then
// this one's products in the dX chain's order (for_each_dx_product). A
// bf16 weight is a TF32 value: its lo is zero, so the bf16 family's image
// holds the hi parts alone and the products read lo from one zero part in
// shared memory (the three products stay; half the bytes stream from L2).

// x = hi + lo: hi is x truncated to TF32 (its low 13 mantissa bits
// cleared), lo = x - hi exactly (|lo| < 2^-10 |x|), read by the tensor core
// as TF32: ~21 bits of x, K2's split (measured against float64 as close as
// the plain version).
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi,
                                            uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// what a product of the dX chain writes
enum DxKind { kDz, kDx, kDv };

// The dX chain's products in stream order, f(j, kind): j indexes the
// forward product (for_each_product's order) whose weight it transposes.
// The views' v product (dv), the views' f product, the feature, then the
// trunk from its last layer down (the skip layer's x product, for dx,
// before its h product), then layer 0 (dx).
template <class F>
__device__ __forceinline__ void for_each_dx_product(const MlpDesc& md,
                                                    F&& f) {
  const int n = md.D + (md.skip >= 0 ? 1 : 0) + 3;  // forward products
  f(n - 1, kDv);
  f(n - 2, kDz);
  f(n - 3, kDz);
  int j = n - 4;  // the last trunk layer's (h) product
  for (int i = md.D - 1; i >= 1; --i) {
    if (i == md.skip + 1) {
      f(j - 1, kDx);
      f(j, kDz);
      j -= 2;
    } else {
      f(j, kDz);
      j -= 1;
    }
  }
  f(0, kDx);
}

// float32 parts a k-step of the dX chain's image: the bf16 family's holds
// the hi parts alone
template <typename CT>
constexpr int kDxParts = std::is_same<CT, float>::value ? 2 : 1;
// k-steps of the dX chain's products between two waits (bwd_gemm)
constexpr int kDxGroup = 4;

// K2a's producer: the forward's image `wf` (pack_for_chain), then the dX
// chain's (`wb`, pack_for_dx_chain) in for_each_dx_product's order, the dx
// and dv products only when asked for.
template <typename CT>
__device__ void produce_backward(const MlpDesc& md, const unsigned char* wf,
                                 const unsigned char* wb, bool want_dx,
                                 bool want_dv, const Ring& r, RingPos& pos) {
  produce_pass<CT>(md, wf, r, pos);
  // each forward product's (K, N) and the offset of its w^T in wb
  int fk[32], fn[32];
  long long off[32];
  int n = 0;
  long long o = 0;
  for_each_product(md, [&](int K, int N) {
    fk[n] = K;
    fn[n] = N;
    off[n++] = o;
    o += 4LL * kDxParts<CT> * K * N;
  });
  for_each_dx_product(md, [&](int j, DxKind kind) {
    if ((kind == kDx && !want_dx) || (kind == kDv && !want_dv)) return;
    produce_product(kDxParts<CT> * fn[j] / 8, fk[j], wb + off[j], r, pos);
  });
}

// acc (+)= A[rows of this warpgroup, 0:K] @ B[0:K, col0:col0 + NC] for the
// next product of the stream (K x N), A float32 in shared memory (row pitch
// lda). kTf32: 3xTF32 with the truncating split (split_trunc; B's parts
// from the host), a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first,
// into one accumulator (K2a's dX chain); B's lo from the stream, or with
// `zero_lo` (the shared address of 32 N zero bytes) from there; else bf16
// (m64nNk16), A rounded to bf16 to nearest as its fragment is loaded (K2a's
// bf16 recompute). kG k-steps go out between two waits, their A fragments
// all loaded before the first product (chain_gemm's kGroup): K % (kG
// k-steps) == 0.
template <bool kTf32, int NC>
__device__ __forceinline__ void bwd_gemm(float (&acc)[NC / 2], const float* A,
                                         int lda, int K, int N, int col0,
                                         bool accumulate, uint32_t zero_lo,
                                         const Ring& r, RingPos& pos) {
  constexpr int kStep = kTf32 ? 8 : 16, kParts = kTf32 ? 2 : 1;
  constexpr int kG = kTf32 ? kDxGroup : 2;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int per = CH_STAGE_BYTES / (32 * N);
  const float* row0 = A + (16 * warp + g) * lda;
  const float* row1 = row0 + 8 * lda;
  int part_i = 0;
  uint32_t stage = 0;
  auto next_part = [&]() {  // as chain_gemm's
    if (part_i % per == 0) {
      const int slot = pos.q % r.ns;
      mbar_wait(&r.full[slot], (pos.q / r.ns) & 1);
      stage = r.base + slot * CH_STAGE_BYTES;
      ++pos.q;
    }
    const uint32_t addr = stage + (part_i % per) * 32 * N + 16 * col0;
    ++part_i;
    return addr;
  };
  auto bf2 = [](const float* p) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    const __nv_bfloat162 h = __floats2bfloat162_rn(f.x, f.y);  // .x low
    return *reinterpret_cast<const uint32_t*>(&h);
  };
  for (int k0 = 0; k0 < K; k0 += kG * kStep) {
    uint32_t a[kG][kParts][4];
    uint64_t d[kG][kParts];
#pragma unroll
    for (int gi = 0; gi < kG; ++gi) {
      const int k = k0 + gi * kStep;
      if constexpr (kTf32) {
        split_trunc(row0[k + t], a[gi][0][0], a[gi][1][0]);
        split_trunc(row1[k + t], a[gi][0][1], a[gi][1][1]);
        split_trunc(row0[k + t + 4], a[gi][0][2], a[gi][1][2]);
        split_trunc(row1[k + t + 4], a[gi][0][3], a[gi][1][3]);
      } else {
        a[gi][0][0] = bf2(row0 + k + 2 * t);
        a[gi][0][1] = bf2(row1 + k + 2 * t);
        a[gi][0][2] = bf2(row0 + k + 8 + 2 * t);
        a[gi][0][3] = bf2(row1 + k + 8 + 2 * t);
      }
      d[gi][0] = b_desc(next_part(), N);
      if constexpr (kTf32)
        d[gi][1] = b_desc(zero_lo ? zero_lo + 16 * col0 : next_part(), N);
    }
    wgmma_fence();
#pragma unroll
    for (int gi = 0; gi < kG; ++gi) {
      const int scale = (accumulate || k0 > 0 || gi > 0) ? 1 : 0;
      if constexpr (kTf32) {  // small terms first
        wgmma_tf32<NC>(acc, a[gi][1], d[gi][0], scale);
        wgmma_tf32<NC>(acc, a[gi][0], d[gi][1], 1);
        wgmma_tf32<NC>(acc, a[gi][0], d[gi][0], 1);
      } else {
        wgmma_bf16<NC>(acc, a[gi][0], d[gi][0], scale);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();  // retire before the next group's A registers
    release_upto(r, pos, part_i % per == 0 ? pos.q : pos.q - 1);
  }
  fence_regs<NC / 2>(acc);
  release_upto(r, pos, pos.q);
}

}  // namespace chain
