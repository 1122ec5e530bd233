// K5: the whole fused ray march in one kernel (`march_fused: full`).
//
// Replaces the TPU kernel `_full_kernel` (nerf_replication_tpu/ops/
// fused_march.py:514, launched by `_full_pallas` :532, body `_full_block`
// :431). On the TPU it never lowered (Mosaic rejects the DDA's in-kernel
// gathers); production ran the body through lax.map.
//
// One CTA of MLP_THREADS threads owns FM_RAYS rays end to end:
//   1. traversal: the whole CTA runs the K4 body (dda.cuh, dda_cta) and
//      keeps only the valid slots (t, slot index) in shared memory, plus
//      each ray's encoded view direction;
//   2. rounds of at most MLP_M = 64 samples: every ray that is alive and has
//      samples left takes up to 64 / (#such rays) of its next samples, the
//      rows are frequency-encoded in shared memory and run through the MLP
//      tile chain (mlp_tile.cuh);
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
// per sample: float32 on the CUDA cores for the f32 family (67 TFLOP/s
// peak), bf16 tensor-core products for the bf16 family (989 TFLOP/s dense
// peak); the ~2.4 MB (f32) / ~1.2 MB (bf16) of weights per 64-row tile
// come from L2. The TPU's 256-ray x 2-slot block (a 512 x 256
// f32 tile, 512 KB) does not fit a CTA's 227 KB, hence 64-row tiles and
// 8 rays per CTA of 256 threads; the rays of a CTA are neighbouring
// pixels, and the few CTAs that cover the hit-heavy image region set the end
// of the kernel, so a small ray count spreads their work over more SMs.
#include "dda.cuh"
#include "mlp_tile.cuh"

namespace {

constexpr int FM_RAYS = 8;  // rays per CTA

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

struct ListSink {
  static constexpr bool kWantsInvalid = false;
  float* t;
  int16_t* slot;
  int count;
  __device__ __forceinline__ void emit(int s, float tt, int, bool v) {
    if (v) {
      t[count] = tt;
      slot[count] = static_cast<int16_t>(s);
      ++count;
    }
  }
};

size_t smem_bytes(const MlpDesc& md, const MarchStatics& st) {
  const int K = st.k_sel;
  const size_t floats = 2 * static_cast<size_t>(MLP_M) * (md.W + MLP_PAD) +
                        static_cast<size_t>(MLP_M) * (md.c_in_pad + MLP_PAD) +
                        static_cast<size_t>(MLP_M) * (md.c_views_pad + MLP_PAD) +
                        static_cast<size_t>(mlp_stage_floats(md.W)) + MLP_M * 4 +
                        FM_RAYS * md.c_views_pad +
                        static_cast<size_t>(FM_RAYS) * K;
  const size_t head = floats * sizeof(float) + FM_RAYS * sizeof(RayState) +
                      (2 * MLP_M + 4) * sizeof(int) +
                      static_cast<size_t>(FM_RAYS) * K * sizeof(int16_t);
  return (head + 15) / 16 * 16 + dda_smem_bytes(FM_RAYS, st, false);
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

template <typename CT>
__global__ void __launch_bounds__(MLP_THREADS, 1)
fused_march_full_kernel(const float* __restrict__ rays, int n,
                        const int8_t* __restrict__ grid,
                        const int8_t* __restrict__ coarse,
                        const float* __restrict__ bbox, MarchStatics st,
                        MlpDesc md, const CT* __restrict__ ws,
                        const float* __restrict__ wh,
                        float* __restrict__ rgb_out,
                        float* __restrict__ depth_out,
                        float* __restrict__ acc_out,
                        uint8_t* __restrict__ alive_out,
                        int* __restrict__ nocc_out,
                        int* __restrict__ nblk_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = md.W, cin = md.c_in_pad, cvp = md.c_views_pad, K = st.k_sel;
  const int ldx = cin + MLP_PAD, ldv = cvp + MLP_PAD;
  float* hA = reinterpret_cast<float*>(smem);
  float* hB = hA + MLP_M * (W + MLP_PAD);
  float* xs = hB + MLP_M * (W + MLP_PAD);
  float* vs = xs + MLP_M * ldx;
  float* wst = vs + MLP_M * ldv;
  float* raw = wst + mlp_stage_floats(W);
  float* denc = raw + MLP_M * 4;
  float* list_t = denc + FM_RAYS * cvp;
  RayState* rs = reinterpret_cast<RayState*>(list_t + FM_RAYS * K);
  int* row_ray = reinterpret_cast<int*>(rs + FM_RAYS);
  int* row_idx = row_ray + MLP_M;
  int* ctrl = row_idx + MLP_M;
  int16_t* list_slot = reinterpret_cast<int16_t*>(ctrl + 4);
  const size_t dda_off =
      (reinterpret_cast<unsigned char*>(list_slot + FM_RAYS * K) - smem + 15) /
      16 * 16;
  const DdaShared sh = dda_carve(smem + dda_off, FM_RAYS, st, false);

  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * FM_RAYS;
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
          sh, false, n_occ_r, n_blk_r, sink);
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
      const int q = active ? max(1, MLP_M / active) : 0;
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

    // 2b. encode the rows
    for (int e = tid; e < MLP_M * cin; e += MLP_THREADS) {
      const int row = e / cin, c = e - row * cin;
      float v = 0.0f;
      if (row < used) {
        const RayState& s = rs[row_ray[row]];
        const float t = list_t[row_ray[row] * K + row_idx[row]];
        float p[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) p[a] = __fadd_rn(s.o[a], __fmul_rn(s.d[a], t));
        v = enc_feature(p, c, md.n_freq_xyz);
      }
      xs[row * ldx + c] = v;
    }
    for (int e = tid; e < MLP_M * cvp; e += MLP_THREADS) {
      const int row = e / cvp, c = e - row * cvp;
      vs[row * ldv + c] = row < used ? denc[row_ray[row] * cvp + c] : 0.0f;
    }

#ifdef NRT_PHASE_TIMING
    __syncthreads();
    NRT_MARK(kEncode);
#endif
    // 2c. the MLP tile chain (starts and ends with a barrier)
    mlp_tile_forward<CT>(md, ws, wh, xs, vs, hA, hB, wst, raw);
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

template <typename CT>
int launch(const float* rays, int n, const int8_t* grid, const int8_t* coarse,
           const float* bbox, const MarchStatics& st, const MlpDesc& md,
           const void* ws, const float* wh, float* rgb, float* depth,
           float* acc, uint8_t* alive, int* n_occ, int* n_blk,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(md, st);
  cudaError_t e = cudaFuncSetAttribute(
      fused_march_full_kernel<CT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (n + FM_RAYS - 1) / FM_RAYS;
  fused_march_full_kernel<CT><<<blocks, MLP_THREADS, smem, stream>>>(
      rays, n, grid, coarse, bbox, st, md, static_cast<const CT*>(ws), wh,
      rgb, depth, acc, alive, n_occ, n_blk);
  return static_cast<int>(cudaGetLastError());
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

extern "C" int nrt_fused_march_full(const float* rays, int n,
                                    const int8_t* grid, const int8_t* coarse,
                                    const float* bbox, const MarchStatics* st,
                                    const MlpDesc* md, const void* ws,
                                    int bf16, const float* wh, float* rgb,
                                    float* depth, float* acc, uint8_t* alive,
                                    int* n_occ, int* n_blk, void* stream) {
  if (n <= 0) return 0;
  const bool shape_ok = md->W % 64 == 0 && md->W <= 256 &&
                        md->c_in_pad % MMA_KS == 0 && md->c_in_pad <= 64 &&
                        md->c_views_pad % MMA_KS == 0 &&
                        md->c_views_pad <= 32 && st->k_tile > 0 &&
                        st->k_sel > 0 && st->k_sel <= 32767 &&
                        st->s_c <= 32767 && smem_bytes(*md, *st) <= 232448;
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(rays, n, grid, coarse, bbox, *st, *md, ws,
                                 wh, rgb, depth, acc, alive, n_occ, n_blk, s);
  return launch<float>(rays, n, grid, coarse, bbox, *st, *md, ws, wh, rgb,
                       depth, acc, alive, n_occ, n_blk, s);
}
