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
// caller slices off). Tiles are MLP_M = 64 rows; a ragged last tile reads
// zeros and writes only its real rows.
//
// K1 is one CTA per tile running mlp_tile_forward (mlp_tile.cuh): float32
// products on the CUDA cores for the f32 family, bf16 mma.sync for the bf16
// family, each with the rounding points of `_forward_tile`.
//
// Bound on the card: operations. Forward 1.19 MFLOP per row at lego width
// (f32 CUDA cores: 67 TFLOP/s; bf16 tensor cores: 989 TFLOP/s).
//
// K3a is the same body with the compile-time flag MASKED (K1 is the
// MASKED = false instantiation). K3a replaces `_fwd_kernel_masked`
// (fused_mlp.py:370, launched :528): the packed march's per-row occupancy
// bit `valid` [M] (float32 0/1) streams in, a 64-row tile with no valid row
// writes exact zeros and skips its chain (one block-uniform
// __syncthreads_or over the tile's bits), and every other tile stores
// raw8 * valid. The packed stream is sorted valid-first, so at ~5%
// occupancy ~95% of its tiles skip: K3a's bound is then the bytes of x, v
// and the bit of all M rows plus raw8, or the operations of the valid rows
// — whichever is larger. Skipping at 64 rows (512 on the TPU) changes no
// row's result.
#include "mlp_rows.cuh"

namespace {

// K1 (MASKED = false, valid unused) and K3a (MASKED = true)
template <typename CT, bool MASKED>
__global__ void __launch_bounds__(MLP_THREADS, 1)
    fused_mlp_fwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ v,
                         const float* __restrict__ valid, int m, MlpDesc md,
                         const CT* __restrict__ ws,
                         const float* __restrict__ wh, float* __restrict__ raw8) {
  extern __shared__ __align__(16) float smem[];
  const TileSmem s = carve(smem, md);
  const int row0 = blockIdx.x * MLP_M;
  if (MASKED && !tile_has_valid(valid, row0, m)) {
    zero_rows(raw8, 8, row0, m);  // the whole block leaves together
    return;
  }
  load_rows(s.xs, x, md.c_in_pad, row0, m);
  load_rows(s.vs, v, md.c_views_pad, row0, m);
  // the first GEMM's barrier makes the rows visible
  mlp_tile_forward<CT>(md, ws, wh, s.xs, s.vs, s.b1, s.b2, s.wst, s.raw);
  for (int e = threadIdx.x; e < MLP_M * 8; e += MLP_THREADS) {
    const int r = e >> 3, c = e & 7;
    if (row0 + r < m) {
      float val = c < 4 ? s.raw[r * 4 + c] : 0.0f;
      if (MASKED) val = val * valid[row0 + r];  // raw8 * valid
      raw8[static_cast<size_t>(row0 + r) * 8 + c] = val;
    }
  }
}

template <typename CT, bool MASKED>
int launch_fwd(const float* x, const float* v, const float* valid, int m,
               const MlpDesc& md, const void* ws, const float* wh,
               float* raw8, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(md);
  cudaError_t e = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel<CT, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (m + MLP_M - 1) / MLP_M;
  fused_mlp_fwd_kernel<CT, MASKED><<<blocks, MLP_THREADS, smem, stream>>>(
      x, v, valid, m, md, static_cast<const CT*>(ws), wh, raw8);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NRT_DEFINE_ERROR_STRING

// K1 when `valid` is null; K3a with `valid` [M] float32 0/1
extern "C" int nrt_fused_mlp_fwd(const float* x, const float* v,
                                 const float* valid, int m,
                                 const MlpDesc* md, const void* ws, int bf16,
                                 const float* wh, float* raw8, void* stream) {
  if (m <= 0) return 0;
  if (!shape_ok(*md)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return valid ? launch_fwd<__nv_bfloat16, true>(x, v, valid, m, *md, ws,
                                                   wh, raw8, s)
                 : launch_fwd<__nv_bfloat16, false>(x, v, valid, m, *md, ws,
                                                    wh, raw8, s);
  return valid ? launch_fwd<float, true>(x, v, valid, m, *md, ws, wh, raw8, s)
               : launch_fwd<float, false>(x, v, valid, m, *md, ws, wh, raw8,
                                          s);
}
