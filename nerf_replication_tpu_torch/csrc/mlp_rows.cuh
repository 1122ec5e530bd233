// Row-tile helpers of the fused-MLP backward K2/K3b (fused_mlp_bwd.cu). A
// tile is MLP_M rows of x [M, c_in_pad] and v [M, c_views_pad] read from
// global memory into shared memory beside the two activation buffers of
// K2a's forward recompute (mlp_tile.cuh).
#pragma once

#include "mlp_tile.cuh"

namespace {

__host__ __device__ inline size_t tile_smem_bytes(const MlpDesc& md) {
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

// true for every thread of the block when any real row of the tile at row0
// has a non-zero valid bit (block-uniform: all threads must call it)
__device__ __forceinline__ bool tile_has_valid(const float* __restrict__ valid,
                                               int row0, int m) {
  const int r = threadIdx.x;
  const bool mine = r < MLP_M && row0 + r < m && valid[row0 + r] != 0.0f;
  return __syncthreads_or(mine) != 0;
}

// zero rows row0 .. row0 + MLP_M (those below m) of a global [M, C] array
__device__ __forceinline__ void zero_rows(float* __restrict__ out, int C,
                                          int row0, int m) {
  for (int e = threadIdx.x; e < MLP_M * C; e += MLP_THREADS) {
    const int r = e / C;
    if (row0 + r < m) out[static_cast<size_t>(row0) * C + e] = 0.0f;
  }
}

bool shape_ok(const MlpDesc& md) {
  // D <= 24 keeps the 2D + 10 tensors of the flatten order in ParamOffsets
  return md.D >= 2 && md.D <= 24 && md.W % 64 == 0 && md.W <= 256 &&
         md.c_in_pad % MMA_KS == 0 && md.c_in_pad <= 64 &&
         md.c_views_pad % MMA_KS == 0 && md.c_views_pad <= 32 &&
         md.skip < md.D - 1 && tile_smem_bytes(md) <= 232448;
}

}  // namespace
