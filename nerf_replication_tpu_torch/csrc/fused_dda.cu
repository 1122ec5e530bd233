// K4: fused DDA + fine gather (the `march_fused: gather` traversal).
//
// Replaces the TPU kernel `_dda_kernel` (nerf_replication_tpu/ops/
// fused_march.py:241, launched by `_dda_pallas` :255). On the TPU it never
// lowered (Mosaic rejects in-kernel gathers), so production ran its body
// through lax.map; gathers are native here.
//
// A CTA of 256 threads runs the shared traversal of dda.cuh (dda_cta) for 32
// rays, keeping every candidate's voxel id in shared memory, and one thread
// per ray writes its K slots to the [N, K] outputs. Bound on the card:
// bytes. The outputs are N * K * 9 B (t f32, valid u8, voxel i32) plus 12 B
// per ray; at 16384 rays and K = 192 that is ~28 MB, ~8.5 us at 3.35 TB/s,
// against ~0.4 GFLOP of traversal arithmetic (~6 us at 67 TFLOP/s). The
// grids (2 MiB + 32 KiB int8) stay in L2. Each ray's slots are written by
// one thread (strided stores); staging them for coalesced stores is later
// work.
#include "dda.cuh"

namespace {

constexpr int K4_RAYS = 32;     // rays per CTA
constexpr int K4_THREADS = 256;

struct GatherSink {
  static constexpr bool kWantsInvalid = true;
  float* t;
  uint8_t* valid;
  int* flat;
  __device__ __forceinline__ void emit(int slot, float tt, int f, bool v) {
    t[slot] = tt;
    valid[slot] = v ? 1 : 0;
    flat[slot] = f;
  }
};

__global__ void __launch_bounds__(K4_THREADS)
fused_dda_kernel(const float* __restrict__ rays, int n,
                 const int8_t* __restrict__ grid,
                 const int8_t* __restrict__ coarse,
                 const float* __restrict__ bbox, MarchStatics st,
                 float* __restrict__ t_sel, uint8_t* __restrict__ valid,
                 int* __restrict__ flat_sel, int* __restrict__ n_occ,
                 int* __restrict__ n_blk, float* __restrict__ dist) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ray0 = blockIdx.x * K4_RAYS;
  const int nrays = min(K4_RAYS, n - ray0);
  float bb[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) bb[c] = bbox[c];
  const DdaShared sh = dda_carve(smem, K4_RAYS, st, true);
  const int i = ray0 + static_cast<int>(threadIdx.x);
  const size_t off =
      static_cast<size_t>(static_cast<int>(threadIdx.x) < nrays ? i : 0) * st.k_sel;
  GatherSink sink{t_sel + off, valid + off, flat_sel + off};
  int no = 0, nb = 0;
  dda_cta(rays + 6 * static_cast<size_t>(ray0), nrays, bb, grid, coarse, st,
          sh, true, no, nb, sink);
  if (static_cast<int>(threadIdx.x) < nrays) {
    n_occ[i] = no;
    n_blk[i] = nb;
    dist[i] = ray_dist(sh.geo[threadIdx.x]);
  }
}

}  // namespace

NRT_DEFINE_ERROR_STRING

extern "C" int nrt_fused_dda(const float* rays, int n, const int8_t* grid,
                             const int8_t* coarse, const float* bbox,
                             const MarchStatics* st, float* t_sel,
                             uint8_t* valid, int* flat_sel, int* n_occ,
                             int* n_blk, float* dist, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = dda_smem_bytes(K4_RAYS, *st, true);
  if (smem > 232448 || st->s_c > 32767)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      fused_dda_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (n + K4_RAYS - 1) / K4_RAYS;
  fused_dda_kernel<<<blocks, K4_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      rays, n, grid, coarse, bbox, *st, t_sel, valid, flat_sel, n_occ, n_blk,
      dist);
  return static_cast<int>(cudaGetLastError());
}
