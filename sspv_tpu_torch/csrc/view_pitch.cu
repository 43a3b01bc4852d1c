// K2: fused banded-ACF pitch for one (n_frames + 1, hop) rows view.
//
// Replaces: sspv_tpu/ops/pallas_view.py:476 `_pitch_kernel` (and its
// transposed twin `_pitch_kernel_t`, :587).
//
// Per frame (Wiener-Khinchin): power of the nfft//2 live bins from the merged
// ACF-DFT basis plus the Nyquist column (nfft = frame + lag_max rounded up to
// a multiple of 128, 640 at the defaults); the inverse GEMM back to lags
// 0..n_lags-1 plus the rank-1 Nyquist term; r0 = max(acf[0], 1e-10); the
// first maximum of acf / r0 over lags [lag_min, lag_max] (lowest lag on ties,
// like argmax); f0 = sample_rate / lag and conf = that maximum. The output is
// ungated: the caller applies the VAD and confidence gate.
//
// What bounds it on the H100: the two GEMMs, 2 * 320 * 640 + 2 * 320 * 320
// flop per frame, run as fp32 FMAs outside the tensor cores, and each block
// reads the 800 KiB forward and 400 KiB inverse bases once, from L2.
// What the design does about it: 32 frames per block, so each basis element
// read feeds 32 FMAs; the power rows (321 floats) and the ACF rows (320) stay
// in shared memory between the two GEMMs and the peak pick, so nothing but
// f0 and conf reaches device memory. All arithmetic is IEEE fp32.

#include <math.h>

#include <climits>

#include "view_common.cuh"

namespace {

constexpr int kThreads = 320;
using sspv::kBlockFrames;

__global__ void __launch_bounds__(kThreads) view_pitch_kernel(
    const float* __restrict__ rows, int n_frames, int hop,
    const float* __restrict__ merged, const float* __restrict__ nyq_b,
    int nfft, const float* __restrict__ inv_live,
    const float* __restrict__ inv_nyq, int n_lags, int lag_min, int lag_max,
    float sample_rate, float* __restrict__ f0, float* __restrict__ conf) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  const int half = nfft / 2;
  const int frame = 2 * hop;
  const int pstride = sspv::round4(half + 1);
  const int astride = sspv::round4(n_lags);
  float* power = tile + sspv::tile_floats(hop);   // (kBlockFrames, pstride)
  float* acf = power + kBlockFrames * pstride;    // (kBlockFrames, astride)

  const int i0 = blockIdx.x * kBlockFrames;
  const int nb = min(kBlockFrames, n_frames - i0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  sspv::load_tile(rows, i0, nb, hop, tile);
  __syncthreads();

  sspv::dft_power(tile, hop, merged, half, power, pstride);

  // Nyquist bin of every frame of the block (the inverse GEMM reads all of
  // them; frames past nb are zeros).
  for (int f = warp; f < kBlockFrames; f += nwarps) {
    const float* x = tile + f * hop;
    float q = 0.f;
    for (int t = lane; t < frame; t += 32) q = fmaf(x[t], __ldg(nyq_b + t), q);
    q = sspv::warp_sum(q);
    if (lane == 0) power[f * pstride + half] = q * q;
  }
  __syncthreads();

  // Inverse GEMM to the lag domain, one thread per lag.
  for (int l = threadIdx.x; l < n_lags; l += blockDim.x) {
    float a[kBlockFrames];
#pragma unroll
    for (int f = 0; f < kBlockFrames; ++f) a[f] = 0.f;
    const float* col = inv_live + l;
    for (int k = 0; k < half; k += 4) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = __ldg(col + (size_t)(k + j) * n_lags);
#pragma unroll
      for (int f = 0; f < kBlockFrames; ++f) {
        const float4 p =
            *reinterpret_cast<const float4*>(power + f * pstride + k);
        a[f] = fmaf(p.x, v[0], a[f]);
        a[f] = fmaf(p.y, v[1], a[f]);
        a[f] = fmaf(p.z, v[2], a[f]);
        a[f] = fmaf(p.w, v[3], a[f]);
      }
    }
    const float vn = __ldg(inv_nyq + l);
#pragma unroll
    for (int f = 0; f < kBlockFrames; ++f)
      acf[f * astride + l] = a[f] + power[f * pstride + half] * vn;
  }
  __syncthreads();

  // Normalized band peak, one warp per frame: each lane keeps the first
  // maximum of its strided lags, then the warp keeps the lowest lag among
  // equal maxima.
  for (int f = warp; f < nb; f += nwarps) {
    const float* r = acf + f * astride;
    const float r0 = fmaxf(r[0], 1e-10f);
    float best = -INFINITY;
    int best_lag = INT_MAX;
    for (int l = lag_min + lane; l <= lag_max; l += 32) {
      const float v = r[l] / r0;
      if (v > best) {
        best = v;
        best_lag = l;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int ol = __shfl_xor_sync(0xffffffffu, best_lag, o);
      if (ov > best || (ov == best && ol < best_lag)) {
        best = ov;
        best_lag = ol;
      }
    }
    if (lane == 0) {
      f0[i0 + f] = sample_rate / (float)best_lag;
      conf[i0 + f] = best;
    }
  }
}

}  // namespace

static size_t view_pitch_smem(int hop, int nfft, int n_lags) {
  return sizeof(float) * ((size_t)sspv::tile_floats(hop) +
                          (size_t)kBlockFrames * sspv::round4(nfft / 2 + 1) +
                          (size_t)kBlockFrames * sspv::round4(n_lags));
}

// Returns the CUDA error of the launch (0 on success).
extern "C" int sspv_view_pitch(const float* rows, int n_frames, int hop,
                               const float* merged, const float* nyq_b,
                               int nfft, const float* inv_live,
                               const float* inv_nyq, int n_lags, int lag_min,
                               int lag_max, float sample_rate, float* f0,
                               float* conf, void* stream) {
  const size_t smem = view_pitch_smem(hop, nfft, n_lags);
  cudaError_t err = cudaFuncSetAttribute(
      view_pitch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_frames + kBlockFrames - 1) / kBlockFrames;
  view_pitch_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      rows, n_frames, hop, merged, nyq_b, nfft, inv_live, inv_nyq, n_lags,
      lag_min, lag_max, sample_rate, f0, conf);
  return (int)cudaGetLastError();
}
