// Device code shared by the kernels: the small helpers every kernel uses
// (round4, warp_sum, sign_of). The view kernels (view_features.cu,
// view_pitch.cu) read a frame's 2 * hop samples straight from the
// (n_frames + 1, hop) rows view, where frame i is rows[i] || rows[i + 1] and
// its samples lie side by side; the 2x-overlapping frame matrix is never
// formed anywhere.
#pragma once

#include <cuda_runtime.h>

namespace sspv {

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// NumPy/JAX sign: sign(0) == 0.
__device__ __forceinline__ int sign_of(float x) { return (x > 0.f) - (x < 0.f); }

}  // namespace sspv
