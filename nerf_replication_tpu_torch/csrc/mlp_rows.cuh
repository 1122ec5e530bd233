// Row-tile constants and copy helpers of the fused-MLP backward K2/K3b
// (fused_mlp_bwd.cu): the 64-row tile of a GradScratch block, the padding
// of its rows, and the cp.async staging of K2b.
#pragma once

#include "common.cuh"

constexpr int MLP_M = 64;   // rows per tile (one GradScratch block)
constexpr int MLP_PAD = 8;  // floats of padding per scratch row

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
