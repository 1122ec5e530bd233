// K5: the whole fused ray march in one kernel (`march_fused: full`).
//
// Replaces the TPU kernel `_full_kernel` (nerf_replication_tpu/ops/
// fused_march.py:514, launched by `_full_pallas` :532, body `_full_block`
// :431). On the TPU it never lowered (Mosaic rejects the DDA's in-kernel
// gathers); production ran the body through lax.map.
//
// One CTA of CH_THREADS threads owns FM_RAYS rays end to end:
//   1. traversal: the whole CTA runs K4's function as the CTA traversal
//      dda_cta (dda.cuh; K4 itself runs a warp a ray, fused_dda.cu) and
//      keeps only the valid slots (t, slot index) in shared memory, plus
//      each ray's encoded view direction;
//   2. rounds of at most CH_M = 64 samples: every ray that is alive and has
//      samples left takes up to 64 / (#such rays) of its next samples, the
//      rows are frequency-encoded in shared memory (rounded to the compute
//      type) and run through the Hopper MLP chain (mlp_chain_sm90.cuh) in
//      its column-split mode: both consumer warpgroups take the round's 64
//      rows, each half of every layer's columns, with wgmma products (bf16,
//      or 3xTF32 for float32) while a ninth warp streams the weights
//      through the TMA ring; the two halves of each head are summed;
//   3. compositing: one thread per ray folds its rows into log-space
//      transmittance in slot order, with the JAX package's tile structure
//      (cumsum within a tile of k_tile slots, carry between tiles), and
//      stops the ray once exp(-carry) < threshold at a tile edge.
// Skipping invalid slots and dead rays is exact: an invalid slot has tau = 0
// (weight 0), and since tau >= 0 a ray whose transmittance fell below the
// threshold at a tile edge gets weight 0 from every later sample. The TPU
// kernel skips a whole tile only once every ray of its block is dead; per
// ray is finer and gives the same maps.
//
// Bound on the card: operations. At lego width the MLP costs ~1.19 MFLOP
// per sample: three TF32 products (495 TFLOP/s) for the f32 family, bf16
// tensor-core products (989 TFLOP/s dense peak) for the bf16 family; the
// ~4.8 MB (f32, split into TF32 high and low parts on the host) / ~1.2 MB
// (bf16) of weights per 64-row round come from L2. The TPU's 256-ray x
// 2-slot block (a 512 x 256 f32 tile, 512 KB) does not fit a CTA's 227 KB,
// hence 64-row rounds and 8 rays per CTA of 256 threads (+ the producer
// warp); the rays of a CTA are neighbouring pixels, and the few CTAs that
// cover the hit-heavy image region set the end of the kernel, so a small
// ray count spreads their work over more SMs.
#include "dda.cuh"
#include "mlp_chain_sm90.cuh"

namespace {

using namespace chain;

constexpr int FM_RAYS = 8;  // rays per CTA
constexpr int FM_STAGES = 8;  // ring stages (what the shared memory leaves)

#ifdef NRT_PHASE_TIMING
// Phase-timing build (scripts/profile_fused_march.py compiles this file with
// -DNRT_PHASE_TIMING; the serving build has none of it). Thread 0 of every
// CTA sums the SM clock cycles between the CTA-wide barriers that separate
// the phases, and adds them to these counters when the CTA ends.
enum Phase {
  kDda, kSchedule, kEncode, kMlp, kComposite, kFinalize,  // cycles
  kRounds, kRows, kBusyCtas, kMaxCtaCycles, kCtas, kPhaseCount
};
__device__ unsigned long long g_phase[kPhaseCount];
#define NRT_MARK(ph)                                          \
  do {                                                        \
    if (tid == 0) {                                           \
      const long long now = clock64();                        \
      prof[ph] += static_cast<unsigned long long>(now - t_mark); \
      t_mark = now;                                           \
    }                                                         \
  } while (0)
#else
#define NRT_MARK(ph) \
  do {               \
  } while (0)
#endif

struct RayState {
  float o[3], d[3];
  float dist;
  float c_prev;             // sum of tau over the flushed tiles
  float cj;                 // in-tile cumsum of tau
  float trgb[3], tdepth, tacc;  // current tile sums
  float rgb[3], depth, acc;     // sums over the flushed tiles
  int nvalid, pos, alive, tile, take, off, n_occ, n_blk;
};

template <typename AT>
__device__ __forceinline__ AT to_at(float v);
template <>
__device__ __forceinline__ float to_at<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_at<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct ListSink {
  float* t;
  int16_t* slot;
  int count;
  __device__ __forceinline__ void emit(int s, float tt) {
    t[count] = tt;
    slot[count] = static_cast<int16_t>(s);
    ++count;
  }
};

// shared memory: the activation buffers of CH_M rows, the ring and its
// barriers, the heads' halves and raw, then the rays' lists and state
template <typename CT>
size_t smem_bytes(const MlpDesc& md, const MarchStatics& st) {
  const int K = st.k_sel;
  const size_t act = (act_bytes<CT>(md, CH_M) + 127) / 128 * 128;
  const size_t floats = 2 * CH_M * 4 + CH_M * 4 +
                        FM_RAYS * md.c_views_pad +
                        static_cast<size_t>(FM_RAYS) * K;
  const size_t head = act + FM_STAGES * (CH_STAGE_BYTES + 16) +
                      floats * sizeof(float) + FM_RAYS * sizeof(RayState) +
                      (2 * CH_M + 4) * sizeof(int) +
                      static_cast<size_t>(FM_RAYS) * K * sizeof(int16_t);
  return (head + 15) / 16 * 16 + dda_smem_bytes(FM_RAYS, st);
}

// feature c of the frequency encoding [p, sin(p 2^0), cos(p 2^0), ...] with
// L bands; 0 past the encoding's width (padding columns)
__device__ __forceinline__ float enc_feature(const float p[3], int c, int L) {
  if (c < 3) return p[c];
  const int idx = c - 3;
  const int band = idx / 6;
  if (band >= L) return 0.0f;
  const int w = idx - band * 6;
  const float x = __fmul_rn(p[w % 3], static_cast<float>(1 << band));
  return w < 3 ? sinf(x) : cosf(x);
}

__device__ __forceinline__ void flush_tile(RayState& s) {
  s.c_prev = s.c_prev + s.cj;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.rgb[c] = s.rgb[c] + s.trgb[c];
    s.trgb[c] = 0.0f;
  }
  s.depth = s.depth + s.tdepth;
  s.acc = s.acc + s.tacc;
  s.cj = 0.0f;
  s.tdepth = 0.0f;
  s.tacc = 0.0f;
}

template <typename CT, int W>
__global__ void __launch_bounds__(CH_THREADS, 1)
fused_march_full_kernel(const float* __restrict__ rays, int n,
                        const int8_t* __restrict__ grid,
                        const int8_t* __restrict__ coarse,
                        const float* __restrict__ bbox, MarchStatics st,
                        MlpDesc md, const unsigned char* __restrict__ wmat,
                        const float* __restrict__ bias,
                        const float* __restrict__ wh,
                        float* __restrict__ rgb_out,
                        float* __restrict__ depth_out,
                        float* __restrict__ acc_out,
                        uint8_t* __restrict__ alive_out,
                        int* __restrict__ nocc_out,
                        int* __restrict__ nblk_out) {
  using AT = typename Fam<CT>::AT;
  constexpr int pad = Fam<CT>::kPad;
  extern __shared__ __align__(128) unsigned char smem[];
  const int cin = md.c_in_pad, cvp = md.c_views_pad, K = st.k_sel;
  const int ldh = W + pad, ldx = cin + pad, ldv = cvp + pad;
  AT* H = reinterpret_cast<AT*>(smem);
  AT* xs = H + CH_M * ldh;
  AT* vs = xs + CH_M * ldx;
  unsigned char* ring_mem =
      smem + (act_bytes<CT>(md, CH_M) + 127) / 128 * 128;
  Ring ring{reinterpret_cast<uint64_t*>(ring_mem + FM_STAGES * CH_STAGE_BYTES),
            nullptr, smem_u32(ring_mem), FM_STAGES};
  ring.empty = ring.full + FM_STAGES;
  float* hp = reinterpret_cast<float*>(ring.empty + FM_STAGES);  // [2][64][4]
  float* raw = hp + 2 * CH_M * 4;
  float* denc = raw + CH_M * 4;
  float* list_t = denc + FM_RAYS * cvp;
  RayState* rs = reinterpret_cast<RayState*>(list_t + FM_RAYS * K);
  int* row_ray = reinterpret_cast<int*>(rs + FM_RAYS);
  int* row_idx = row_ray + CH_M;
  int* ctrl = row_idx + CH_M;
  int16_t* list_slot = reinterpret_cast<int16_t*>(ctrl + 4);
  const size_t dda_off =
      (reinterpret_cast<unsigned char*>(list_slot + FM_RAYS * K) - smem + 15) /
      16 * 16;
  const DdaShared sh = dda_carve(smem + dda_off, FM_RAYS, st);

  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * FM_RAYS;
  const bool producer = tid >= CH_CONSUMERS;  // the ninth warp
  RingPos pos;
  if (tid == 0) ring_init(ring);  // dda_cta's first barrier publishes it
#ifdef NRT_PHASE_TIMING
  unsigned long long prof[kPhaseCount] = {};
  const long long t_begin = clock64();
  long long t_mark = t_begin;
  bool first_round = true;
#endif
  float bb[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) bb[c] = bbox[c];

  // 1. traversal (the whole CTA), then per-ray set-up on threads < FM_RAYS
  const int nrays = min(FM_RAYS, n - ray0);
  ListSink sink{list_t + (tid < FM_RAYS ? tid : 0) * K,
                list_slot + (tid < FM_RAYS ? tid : 0) * K, 0};
  int n_occ_r = 0, n_blk_r = 0;
  dda_cta(rays + 6 * static_cast<size_t>(ray0), nrays, bb, grid, coarse, st,
          sh, n_occ_r, n_blk_r, sink);
  if (tid < FM_RAYS) {
    RayState& s = rs[tid];
    s.c_prev = s.cj = s.tdepth = s.tacc = s.depth = s.acc = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) s.trgb[c] = s.rgb[c] = 0.0f;
    s.pos = s.take = s.off = 0;
    s.tile = -1;
    s.alive = tid < nrays ? 1 : 0;
    s.nvalid = tid < nrays ? sink.count : 0;
    s.n_occ = n_occ_r;
    s.n_blk = n_blk_r;
    if (tid < nrays) {
      const RayGeom& g = sh.geo[tid];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        s.o[c] = g.o[c];
        s.d[c] = g.d[c];
      }
      s.dist = ray_dist(g);
      // viewdirs = d / max(|d|, 1e-12), encoded once per ray
      const float den = fmaxf(__fsqrt_rn(g.dd), 1e-12f);
      float vd[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) vd[c] = __fdiv_rn(g.d[c], den);
      for (int c = 0; c < cvp; ++c)
        denc[tid * cvp + c] = enc_feature(vd, c, md.n_freq_dir);
    } else {
      for (int c = 0; c < cvp; ++c) denc[tid * cvp + c] = 0.0f;
    }
  }

  for (;;) {
    __syncthreads();
#ifdef NRT_PHASE_TIMING
    NRT_MARK(first_round ? kDda : kComposite);
    first_round = false;
#endif
    // 2a. schedule this round's rows
    if (tid == 0) {
      int active = 0;
      for (int r = 0; r < FM_RAYS; ++r)
        active += (rs[r].alive && rs[r].pos < rs[r].nvalid) ? 1 : 0;
      const int q = active ? max(1, CH_M / active) : 0;
      int off = 0;
      for (int r = 0; r < FM_RAYS; ++r) {
        RayState& s = rs[r];
        s.take = 0;
        if (!(s.alive && s.pos < s.nvalid)) continue;
        s.take = min(q, s.nvalid - s.pos);
        s.off = off;
        for (int j = 0; j < s.take; ++j) {
          row_ray[off + j] = r;
          row_idx[off + j] = s.pos + j;
        }
        off += s.take;
      }
      ctrl[0] = off;
    }
    __syncthreads();
    const int used = ctrl[0];
    NRT_MARK(kSchedule);
    if (used == 0) break;
#ifdef NRT_PHASE_TIMING
    if (tid == 0) {
      prof[kRounds] += 1;
      prof[kRows] += used;
    }
#endif

    // 2b. encode the rows (the consumers), rounded to the compute type
    if (!producer) {
      for (int e = tid; e < CH_M * cin; e += CH_CONSUMERS) {
        const int row = e / cin, c = e - row * cin;
        float v = 0.0f;
        if (row < used) {
          const RayState& s = rs[row_ray[row]];
          const float t = list_t[row_ray[row] * K + row_idx[row]];
          float p[3];
#pragma unroll
          for (int a = 0; a < 3; ++a)
            p[a] = __fadd_rn(s.o[a], __fmul_rn(s.d[a], t));
          v = enc_feature(p, c, md.n_freq_xyz);
        }
        xs[row * ldx + c] = to_at<AT>(v);
      }
      for (int e = tid; e < CH_M * cvp; e += CH_CONSUMERS) {
        const int row = e / cvp, c = e - row * cvp;
        vs[row * ldv + c] =
            to_at<AT>(row < used ? denc[row_ray[row] * cvp + c] : 0.0f);
      }
    }

#ifdef NRT_PHASE_TIMING
    __syncthreads();
    NRT_MARK(kEncode);
#endif
    // 2c. the MLP chain: the producer warp streams one pass of the weights,
    // the consumers run the products, then raw = the heads' two column
    // halves + their biases
    if (producer) {
      if (tid == CH_CONSUMERS) produce_pass<CT>(md, wmat, ring, pos);
    } else {
      consumers_sync();  // the encoded rows
      const HeadOut ho = chain_forward<CT, W, true, false>(
          md, bias, wh, xs, ldx, vs, ldv, H, ldh, ring, pos);
      const int lane = tid & 31;
      if ((lane & 3) == 0) {
        float* part = hp + (tid >> 7) * CH_M * 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * ((tid >> 5) & 3) + (lane >> 2) + 8 * h;
          *reinterpret_cast<float4*>(part + row * 4) = make_float4(
              ho.rgb[h][0], ho.rgb[h][1], ho.rgb[h][2], ho.alpha[h]);
        }
      }
      consumers_sync();
      if (tid < CH_M * 4) {
        const int c = tid & 3;
        const float hb = c < 3 ? __ldg(wh + W * 8 + 8 + (W / 2) * 8 + c)
                               : __ldg(wh + W * 8 + 3);
        raw[tid] = (hp[tid] + hp[CH_M * 4 + tid]) + hb;
      }
      consumers_sync();
    }
    NRT_MARK(kMlp);

    // 3. composite, one thread per ray, in slot order
    if (tid < FM_RAYS && rs[tid].take > 0) {
      RayState& s = rs[tid];
      for (int j = 0; j < s.take; ++j) {
        const int li = s.pos + j;
        const int row = s.off + j;
        const int tile = list_slot[tid * K + li] / st.k_tile;
        if (tile != s.tile) {
          if (s.tile >= 0) {
            flush_tile(s);
            if (expf(-s.c_prev) < st.threshold) {
              s.alive = 0;
              break;
            }
          }
          s.tile = tile;
        }
        const float t = list_t[tid * K + li];
        const float tau = fmaxf(raw[row * 4 + 3], 0.0f) * s.dist;
        const float cj = s.cj + tau;
        const float trans = expf(-(s.c_prev + (cj - tau)));
        const float alpha = 1.0f - expf(-tau);
        const float w = trans * alpha * (trans >= st.threshold ? 1.0f : 0.0f);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float rgb = 1.0f / (1.0f + expf(-raw[row * 4 + c]));
          s.trgb[c] = s.trgb[c] + w * rgb;
        }
        s.tdepth = s.tdepth + w * t;
        s.tacc = s.tacc + w;
        s.cj = cj;
      }
      s.pos += s.take;
    }
  }

  // finalize
  if (tid < FM_RAYS && ray0 + tid < n) {
    RayState& s = rs[tid];
    const int i = ray0 + tid;
    if (s.tile >= 0 && s.alive) flush_tile(s);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rgb_out[3 * i + c] = st.white_bkgd ? s.rgb[c] + (1.0f - s.acc) : s.rgb[c];
    depth_out[i] = s.depth;
    acc_out[i] = s.acc;
    alive_out[i] = expf(-s.c_prev) >= st.threshold ? 1 : 0;
    nocc_out[i] = s.n_occ;
    nblk_out[i] = s.n_blk;
  }
#ifdef NRT_PHASE_TIMING
  NRT_MARK(kFinalize);
  if (tid == 0) {
    for (int ph = 0; ph < kFinalize + 1; ++ph) atomicAdd(&g_phase[ph], prof[ph]);
    atomicAdd(&g_phase[kRounds], prof[kRounds]);
    atomicAdd(&g_phase[kRows], prof[kRows]);
    atomicAdd(&g_phase[kBusyCtas], prof[kRounds] > 0 ? 1ull : 0ull);
    atomicAdd(&g_phase[kCtas], 1ull);
    atomicMax(&g_phase[kMaxCtaCycles],
              static_cast<unsigned long long>(clock64() - t_begin));
  }
#endif
}

template <typename CT, int W>
int launch(const float* rays, int n, const int8_t* grid, const int8_t* coarse,
           const float* bbox, const MarchStatics& st, const MlpDesc& md,
           const void* wmat, const float* bias, const float* wh, float* rgb,
           float* depth, float* acc, uint8_t* alive, int* n_occ, int* n_blk,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<CT>(md, st);
  auto kernel = fused_march_full_kernel<CT, W>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (n + FM_RAYS - 1) / FM_RAYS;
  kernel<<<blocks, CH_THREADS, smem, stream>>>(
      rays, n, grid, coarse, bbox, st, md,
      static_cast<const unsigned char*>(wmat), bias, wh, rgb, depth, acc,
      alive, n_occ, n_blk);
  return static_cast<int>(cudaGetLastError());
}

template <typename CT>
int launch_width(const float* rays, int n, const int8_t* grid,
                 const int8_t* coarse, const float* bbox,
                 const MarchStatics& st, const MlpDesc& md, const void* wmat,
                 const float* bias, const float* wh, float* rgb, float* depth,
                 float* acc, uint8_t* alive, int* n_occ, int* n_blk,
                 cudaStream_t s) {
#define NRT_K5_WIDTH(w)                                                   \
  case w:                                                                 \
    return launch<CT, w>(rays, n, grid, coarse, bbox, st, md, wmat, bias, \
                         wh, rgb, depth, acc, alive, n_occ, n_blk, s);
  switch (md.W) {
    NRT_K5_WIDTH(64)
    NRT_K5_WIDTH(128)
    NRT_K5_WIDTH(192)
    NRT_K5_WIDTH(256)
  }
#undef NRT_K5_WIDTH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

NRT_DEFINE_ERROR_STRING

#ifdef NRT_PHASE_TIMING
// copy the phase counters to `host` (kPhaseCount values) and zero them
extern "C" int nrt_phase_read(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[kPhaseCount] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase, zero, sizeof(zero)));
}
#endif

// `wmat` is pack_for_chain's weight image, `bias` its float32 biases, `wh`
// the float32 heads
extern "C" int nrt_fused_march_full(const float* rays, int n,
                                    const int8_t* grid, const int8_t* coarse,
                                    const float* bbox, const MarchStatics* st,
                                    const MlpDesc* md, const void* wmat,
                                    const float* bias, int bf16,
                                    const float* wh, float* rgb, float* depth,
                                    float* acc, uint8_t* alive, int* n_occ,
                                    int* n_blk, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = bf16 ? smem_bytes<__nv_bfloat16>(*md, *st)
                           : smem_bytes<float>(*md, *st);
  const bool shape_ok = chain_shape_ok(*md) && st->k_tile > 0 &&
                        st->k_sel > 0 && st->k_sel <= 32767 &&
                        st->s_c <= 32767 && smem <= 232448;
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_width<__nv_bfloat16>(rays, n, grid, coarse, bbox, *st, *md,
                                       wmat, bias, wh, rgb, depth, acc, alive,
                                       n_occ, n_blk, s);
  return launch_width<float>(rays, n, grid, coarse, bbox, *st, *md, wmat,
                             bias, wh, rgb, depth, acc, alive, n_occ, n_blk,
                             s);
}
