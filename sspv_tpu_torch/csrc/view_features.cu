// K1: fused signal-view features for one (n_frames + 1, hop) rows view.
//
// Replaces: sspv_tpu/ops/pallas_view.py:169 `_view_kernel` (and its
// transposed twin `_view_kernel_t`, :252, which computes the same function
// for the TPU's parameter layout).
//
// Per frame: energy sum(x^2 w^2); ZCR = sign changes of the raw samples times
// the f32 reciprocal of frame_size, as the JAX package's compiled programs
// compute it (the window is strictly positive, so sign(x w) == sign(x));
// power of the n_fft//2 + 1 bins from the merged windowed DFT basis plus the
// Nyquist column; mel (clamped at 1e-10) -> log -> ortho DCT -> lifter; and
// the normalized-PSD entropy (clamped at 1e-12) / log(n_bins). Only energy,
// zcr, entropy (F,) and mfcc (F, num_ceps) reach device memory.
//
// What bounds it on the H100: the DFT, 2 * 320 * 512 flop per frame, runs as
// fp32 FMAs outside the tensor cores (67 TFLOP/s peak), and each block reads
// the whole 640 KiB basis once, from L2. The TPU kernel held the basis in
// VMEM; here it does not fit in a block's 227 KB of shared memory.
// What the design does about it: 32 frames per block, so each basis element
// read from L2 feeds 32 FMAs; the samples are 16-byte shared-memory
// broadcasts; the 257-float power rows stay in shared memory for the mel and
// entropy stages. Everything is IEEE fp32 (no fast-math): logf, the divisions
// and the entropy's x log x match the PyTorch version to rounding.

#include "view_common.cuh"

namespace {

constexpr int kThreads = 256;
using sspv::kBlockFrames;

__global__ void __launch_bounds__(kThreads) view_features_kernel(
    const float* __restrict__ rows, int n_frames, int hop,
    const float* __restrict__ w2, const float* __restrict__ wm,
    const float* __restrict__ wnyq, int n_fft,
    const float* __restrict__ fb_t, int num_filters,
    const float* __restrict__ dct, const float* __restrict__ lifter,
    int num_ceps, float log_bins, float* __restrict__ energy,
    float* __restrict__ zcr, float* __restrict__ entropy,
    float* __restrict__ mfcc) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  const int half = n_fft / 2;
  const int frame = 2 * hop;
  const int pstride = sspv::round4(half + 1);
  float* power = tile + sspv::tile_floats(hop);    // (kBlockFrames, pstride)
  float* logmel = power + kBlockFrames * pstride;  // (kBlockFrames, filters)

  const int i0 = blockIdx.x * kBlockFrames;
  const int nb = min(kBlockFrames, n_frames - i0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  sspv::load_tile(rows, i0, nb, hop, tile);
  __syncthreads();

  sspv::dft_power(tile, hop, wm, half, power, pstride);

  // Energy, ZCR and the Nyquist bin: one warp per frame.
  for (int f = warp; f < nb; f += nwarps) {
    const float* x = tile + f * hop;
    float e = 0.f, q = 0.f;
    int changes = 0;
    for (int t = lane; t < frame; t += 32) {
      const float v = x[t];
      e = fmaf(v * v, __ldg(w2 + t), e);
      q = fmaf(v, __ldg(wnyq + t), q);
      if (t + 1 < frame) changes += sspv::sign_of(v) != sspv::sign_of(x[t + 1]);
    }
    e = sspv::warp_sum(e);
    q = sspv::warp_sum(q);
    changes = sspv::warp_sum(changes);
    if (lane == 0) {
      energy[i0 + f] = e;
      zcr[i0 + f] = (float)changes * (1.f / (float)frame);
      power[f * pstride + half] = q * q;
    }
  }
  __syncthreads();

  // Mel filterbank -> clamp -> log, one thread per (frame, filter).
  for (int o = threadIdx.x; o < nb * num_filters; o += blockDim.x) {
    const int f = o / num_filters;
    const int m = o - f * num_filters;
    const float* p = power + f * pstride;
    float acc = 0.f;
    for (int k = 0; k <= half; ++k)
      acc = fmaf(p[k], __ldg(fb_t + k * num_filters + m), acc);
    logmel[o] = logf(fmaxf(acc, 1e-10f));
  }

  // Spectral entropy over the half + 1 bins, one warp per frame.
  for (int f = warp; f < nb; f += nwarps) {
    const float* p = power + f * pstride;
    float s = 0.f;
    for (int k = lane; k <= half; k += 32) s += p[k];
    s = sspv::warp_sum(s);
    float h = 0.f;
    for (int k = lane; k <= half; k += 32) {
      const float pn = fmaxf(s > 0.f ? p[k] / s : 0.f, 1e-12f);
      h += pn * logf(pn);
    }
    h = sspv::warp_sum(h);
    if (lane == 0) entropy[i0 + f] = -h / log_bins;
  }
  __syncthreads();

  // DCT -> lifter, one thread per (frame, coefficient); rows of `mfcc` are
  // contiguous, so output o of the block lands at (i0, 0) + o.
  for (int o = threadIdx.x; o < nb * num_ceps; o += blockDim.x) {
    const int f = o / num_ceps;
    const int c = o - f * num_ceps;
    const float* lm = logmel + f * num_filters;
    float acc = 0.f;
    for (int m = 0; m < num_filters; ++m)
      acc = fmaf(lm[m], __ldg(dct + m * num_ceps + c), acc);
    mfcc[(size_t)i0 * num_ceps + o] = acc * __ldg(lifter + c);
  }
}

}  // namespace

static size_t view_features_smem(int hop, int n_fft, int num_filters) {
  return sizeof(float) * ((size_t)sspv::tile_floats(hop) +
                          (size_t)kBlockFrames * sspv::round4(n_fft / 2 + 1) +
                          (size_t)kBlockFrames * num_filters);
}

// Returns the CUDA error of the launch (0 on success).
extern "C" int sspv_view_features(
    const float* rows, int n_frames, int hop, const float* w2, const float* wm,
    const float* wnyq, int n_fft, const float* fb_t, int num_filters,
    const float* dct, const float* lifter, int num_ceps, float log_bins,
    float* energy, float* zcr, float* entropy, float* mfcc, void* stream) {
  const size_t smem = view_features_smem(hop, n_fft, num_filters);
  cudaError_t err = cudaFuncSetAttribute(
      view_features_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_frames + kBlockFrames - 1) / kBlockFrames;
  view_features_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      rows, n_frames, hop, w2, wm, wnyq, n_fft, fb_t, num_filters, dct, lifter,
      num_ceps, log_bins, energy, zcr, entropy, mfcc);
  return (int)cudaGetLastError();
}

extern "C" const char* sspv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
