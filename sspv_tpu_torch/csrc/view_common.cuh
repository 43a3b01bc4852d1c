// Device code shared by the two signal-view kernels (view_features.cu,
// view_pitch.cu).
//
// The input of both is the (n_frames + 1, hop) rows view of a 16 kHz signal
// with frame_size == 2 * hop: frame i is rows[i] || rows[i + 1]. Because the
// rows are contiguous, the frames of one thread block are one flat run of
// (kBlockFrames + 1) * hop samples, and frame f of the block starts at sample
// f * hop of that run. The run sits in shared memory; the 2x-overlapping
// frame matrix is never formed anywhere.
#pragma once

#include <cuda_runtime.h>

namespace sspv {

// Frames per thread block. Each thread of the DFT stage keeps a cos and a sin
// accumulator for every frame of the block in registers (2 * 32 of them).
constexpr int kBlockFrames = 32;

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Floats of the shared-memory sample run of one block (hop % 4 == 0, so this
// is a multiple of 4 and what follows it stays 16-byte aligned).
__host__ __device__ constexpr int tile_floats(int hop) {
  return (kBlockFrames + 1) * hop;
}

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

// Rows [i0, i0 + nb + 1) into `tile`, zero-filled past the last live row so
// the frames of a partial last block read zeros.
__device__ __forceinline__ void load_tile(const float* __restrict__ rows,
                                          int i0, int nb, int hop,
                                          float* tile) {
  const float4* src = reinterpret_cast<const float4*>(rows + (size_t)i0 * hop);
  float4* dst = reinterpret_cast<float4*>(tile);
  const int live = (nb + 1) * hop / 4;
  const int all = tile_floats(hop) / 4;
  for (int i = threadIdx.x; i < all; i += blockDim.x)
    dst[i] = i < live ? __ldg(src + i) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Live-bin power spectrum of every frame of the tile:
//   power[f * pstride + k] = (x_f . basis[:, k])^2 + (x_f . basis[:, half + k])^2
// for k < half, with basis the (2 * hop, 2 * half) merged [cos | sin] DFT basis
// in device memory. One thread per bin; the basis columns are read once per
// block (coalesced across the warp, L2-resident across blocks), the samples
// are shared-memory broadcasts, and the sums are fp32 FMAs in sample order.
__device__ __forceinline__ void dft_power(const float* tile, int hop,
                                          const float* __restrict__ basis,
                                          int half, float* power,
                                          int pstride) {
  const int frame = 2 * hop;
  const size_t width = 2 * (size_t)half;
  for (int k = threadIdx.x; k < half; k += blockDim.x) {
    float re[kBlockFrames], im[kBlockFrames];
#pragma unroll
    for (int f = 0; f < kBlockFrames; ++f) {
      re[f] = 0.f;
      im[f] = 0.f;
    }
    const float* col = basis + k;
    for (int t = 0; t < frame; t += 4) {
      float c[4], s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = __ldg(col + (t + j) * width);
        s[j] = __ldg(col + (t + j) * width + half);
      }
#pragma unroll
      for (int f = 0; f < kBlockFrames; ++f) {
        const float4 x = *reinterpret_cast<const float4*>(tile + f * hop + t);
        re[f] = fmaf(x.x, c[0], re[f]);
        re[f] = fmaf(x.y, c[1], re[f]);
        re[f] = fmaf(x.z, c[2], re[f]);
        re[f] = fmaf(x.w, c[3], re[f]);
        im[f] = fmaf(x.x, s[0], im[f]);
        im[f] = fmaf(x.y, s[1], im[f]);
        im[f] = fmaf(x.z, s[2], im[f]);
        im[f] = fmaf(x.w, s[3], im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kBlockFrames; ++f)
      power[f * pstride + k] = re[f] * re[f] + im[f] * im[f];
  }
}

}  // namespace sspv
