// Shared declarations of the port's CUDA kernels (compiled for sm_90a).
//
// Each kernel source includes this header once and becomes its own shared
// library with a plain C interface (ops/kernels.py builds and loads them
// through ctypes). Structs passed from Python mirror ctypes.Structure
// definitions in ops/fused_march.py field for field: keep them in sync.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

// Constants of one fused-march configuration (ops/fused_march.FusedStatics).
struct MarchStatics {
  int resolution;  // fine grid R
  int rc;          // coarse grid R_c
  int factor;      // fine -> coarse index divisor
  int r;           // fine steps per coarse block
  int s_c;         // coarse blocks per ray
  int k_c;         // kept-interval budget per ray
  int n_steps;     // fine march steps S
  int k_sel;       // sample-slot budget K
  int compact;     // K < K_c * r: the second compaction runs
  int clip;        // per-ray bbox-span quadrature
  float step;
  float t_near;
  float t_far;
  float threshold;  // transmittance threshold of early ray termination
  int white_bkgd;
  int k_tile;      // compositing tile (slots) of the JAX package
};

// Geometry of the fused NeRF MLP (ops/fused_mlp.FusedSpec) plus the band
// counts of its two frequency encoders.
struct MlpDesc {
  int D;
  int W;
  int skip;         // the trunk layer skip + 1 takes [x_enc, h]; -1 = none
  int c_in_pad;     // padded xyz-encoding width (<= 64)
  int c_views_pad;  // padded dir-encoding width (<= 32)
  int n_freq_xyz;
  int n_freq_dir;
};

#define NRT_DEFINE_ERROR_STRING                                   \
  extern "C" const char* nrt_error_string(int err) {              \
    return cudaGetErrorString(static_cast<cudaError_t>(err));     \
  }
