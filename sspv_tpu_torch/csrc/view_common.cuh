// Device code shared by the kernels: the small helpers every kernel uses
// (round4, warp_sum, sign_of), and the rows-view tile and the dense DFT of
// view_features.cu (K1). K2 (view_pitch.cu) and K3's main route compute
// their spectra with fft.cuh instead and read a frame's 2 * hop samples
// straight from the rows view, where they lie side by side.
//
// K1's input is the (n_frames + 1, hop) rows view of a 16 kHz signal
// with frame_size == 2 * hop: frame i is rows[i] || rows[i + 1]. The rows of
// one thread block sit in shared memory, row r at r * row_stride(hop), and
// frame f of the block is rows f and f + 1 of that tile; the 2x-overlapping
// frame matrix is never formed anywhere. With hop % 4 == 0 the stride is hop
// and the tile is one flat run of (kBlockFrames + 1) * hop samples, frame f
// starting at sample f * hop. Otherwise each row is padded with zeros to a
// multiple of 4 floats, so every row starts 16-byte aligned and the DFT still
// reads float4s (with a scalar tail of hop % 4 samples per row).
#pragma once

#include <cuda_runtime.h>

namespace sspv {

// Frames per thread block. Each thread of the DFT stage keeps a cos and a sin
// accumulator for every frame of the block in registers (2 * 32 of them).
constexpr int kBlockFrames = 32;

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Floats between the starts of two rows of the tile.
__host__ __device__ constexpr int row_stride(int hop) { return round4(hop); }

// Floats of the shared-memory tile of one block: a multiple of 4, so what
// follows it stays 16-byte aligned.
__host__ __device__ constexpr int tile_floats(int hop) {
  return (kBlockFrames + 1) * row_stride(hop);
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
// the frames of a partial last block read zeros. With hop % 4 == 0 (and
// `rows` 16-byte aligned) it copies float4s; otherwise one float at a time
// into the padded rows, zeros in the padding.
__device__ __forceinline__ void load_tile(const float* __restrict__ rows,
                                          int i0, int nb, int hop,
                                          float* tile) {
  if (hop % 4 == 0) {
    const float4* src =
        reinterpret_cast<const float4*>(rows + (size_t)i0 * hop);
    float4* dst = reinterpret_cast<float4*>(tile);
    const int live = (nb + 1) * hop / 4;
    const int all = tile_floats(hop) / 4;
    for (int i = threadIdx.x; i < all; i += blockDim.x)
      dst[i] = i < live ? __ldg(src + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    const float* src = rows + (size_t)i0 * hop;
    const int stride = row_stride(hop);
    const int all = tile_floats(hop);
    for (int i = threadIdx.x; i < all; i += blockDim.x) {
      const int r = i / stride, j = i - r * stride;
      tile[i] = r <= nb && j < hop ? __ldg(src + r * hop + j) : 0.f;
    }
  }
}

// re/im[f] += the products of samples [0, n) of row f of `rows` (rows
// `stride` floats apart, 16-byte aligned) with basis rows t0 .. t0 + n - 1:
// float4s up to the last multiple of 4, then one at a time, all in sample
// order.
__device__ __forceinline__ void dft_rows(const float* rows, int stride, int n,
                                         const float* __restrict__ col,
                                         int t0, size_t width, int half,
                                         float (&re)[kBlockFrames],
                                         float (&im)[kBlockFrames]) {
  int j = 0;
  for (; j + 4 <= n; j += 4) {
    float c[4], s[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      c[q] = __ldg(col + (t0 + j + q) * width);
      s[q] = __ldg(col + (t0 + j + q) * width + half);
    }
#pragma unroll
    for (int f = 0; f < kBlockFrames; ++f) {
      const float4 x = *reinterpret_cast<const float4*>(rows + f * stride + j);
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
  for (; j < n; ++j) {
    const float c = __ldg(col + (t0 + j) * width);
    const float s = __ldg(col + (t0 + j) * width + half);
#pragma unroll
    for (int f = 0; f < kBlockFrames; ++f) {
      const float x = rows[f * stride + j];
      re[f] = fmaf(x, c, re[f]);
      im[f] = fmaf(x, s, im[f]);
    }
  }
}

// Live-bin power spectrum of every frame of the tile:
//   power[f * pstride + k] = (x_f . basis[:, k])^2 + (x_f . basis[:, half + k])^2
// for k < half, with basis the (2 * hop, 2 * half) merged [cos | sin] DFT basis
// in device memory. One thread per bin; the basis columns are read once per
// block (coalesced across the warp, L2-resident across blocks), the samples
// are shared-memory broadcasts, and the sums are fp32 FMAs in sample order:
// the frame's first row, then its second.
__device__ __forceinline__ void dft_power(const float* tile, int hop,
                                          const float* __restrict__ basis,
                                          int half, float* power,
                                          int pstride) {
  const int stride = row_stride(hop);
  const size_t width = 2 * (size_t)half;
  for (int k = threadIdx.x; k < half; k += blockDim.x) {
    float re[kBlockFrames], im[kBlockFrames];
#pragma unroll
    for (int f = 0; f < kBlockFrames; ++f) {
      re[f] = 0.f;
      im[f] = 0.f;
    }
    const float* col = basis + k;
    dft_rows(tile, stride, hop, col, 0, width, half, re, im);
    dft_rows(tile + stride, stride, hop, col, hop, width, half, re, im);
#pragma unroll
    for (int f = 0; f < kBlockFrames; ++f)
      power[f * pstride + k] = re[f] * re[f] + im[f] * im[f];
  }
}

}  // namespace sspv
