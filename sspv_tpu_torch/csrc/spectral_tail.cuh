// What follows the power spectrum in view_features.cu (K1) and in both kernels
// of frame_features.cu (K3): mel -> log -> DCT -> lifter and the spectral
// entropy of one frame, by the one warp that holds the frame's power row in
// its shared memory. K1 and both of K3's kernels call this one function, so a
// frame's MFCC and entropy have the same bits whichever kernel computed its
// spectrum.
#pragma once

#include <cuda_runtime.h>

#include "view_common.cuh"

namespace sspv {

// `power`: the n_bins power bins, `logmel`: `num_filters` floats of
// scratch, both in the warp's shared memory and visible to all its lanes
// (the caller synchronizes the warp after writing `power`). `fb_t` is the
// (n_bins, num_filters) filterbank and `mel_ranges` (num_filters, 2) the
// [start, end) bins of each filter's nonzeros: the mel stage sums each filter
// over those bins only, about 2 n_bins multiply-adds per frame instead of
// n_bins * num_filters. Mel is clamped at 1e-10 before the log; the entropy
// is that of the normalized power row, each term clamped at 1e-12, over
// `log_bins` (zero if `compute_entropy` is 0). Writes `*entropy_out` and the
// `num_ceps` floats at `mfcc_row`. All 32 lanes must call it; on return the
// warp is synchronized and `power` and `logmel` are free.
__device__ __forceinline__ void spectral_tail(
    int n_bins, const float* power, float* logmel,
    const float* __restrict__ fb_t, const int* __restrict__ mel_ranges,
    int num_filters, const float* __restrict__ dct,
    const float* __restrict__ lifter, int num_ceps, float log_bins,
    int compute_entropy, int lane, float* __restrict__ entropy_out,
    float* __restrict__ mfcc_row) {
  // Mel filterbank over each filter's nonzero bins -> clamp -> log.
  for (int m = lane; m < num_filters; m += 32) {
    const int lo = __ldg(mel_ranges + 2 * m);
    const int hi = __ldg(mel_ranges + 2 * m + 1);
    float acc = 0.f;
    for (int k = lo; k < hi; ++k)
      acc = fmaf(power[k], __ldg(fb_t + k * num_filters + m), acc);
    logmel[m] = logf(fmaxf(acc, 1e-10f));
  }

  // Spectral entropy over the n_bins bins.
  float h = 0.f;
  if (compute_entropy) {
    float s = 0.f;
    for (int k = lane; k < n_bins; k += 32) s += power[k];
    s = warp_sum(s);
    for (int k = lane; k < n_bins; k += 32) {
      const float pn = fmaxf(s > 0.f ? power[k] / s : 0.f, 1e-12f);
      h += pn * logf(pn);
    }
    h = warp_sum(h);
  }
  if (lane == 0) *entropy_out = compute_entropy ? -h / log_bins : 0.f;
  __syncwarp();

  // DCT -> lifter, one lane per coefficient.
  for (int c = lane; c < num_ceps; c += 32) {
    float acc = 0.f;
    for (int m = 0; m < num_filters; ++m)
      acc = fmaf(logmel[m], __ldg(dct + m * num_ceps + c), acc);
    mfcc_row[c] = acc * __ldg(lifter + c);
  }
  __syncwarp();  // the next frame overwrites the buffers and the log-mel row
}

// The same for the N / 2 + 1 bins of an N-point transform (K1 and K3's FFT
// route).
template <int N>
__device__ __forceinline__ void spectral_tail(
    const float* power, float* logmel, const float* __restrict__ fb_t,
    const int* __restrict__ mel_ranges, int num_filters,
    const float* __restrict__ dct, const float* __restrict__ lifter,
    int num_ceps, float log_bins, int compute_entropy, int lane,
    float* __restrict__ entropy_out, float* __restrict__ mfcc_row) {
  spectral_tail(N / 2 + 1, power, logmel, fb_t, mel_ranges, num_filters, dct,
                lifter, num_ceps, log_bins, compute_entropy, lane,
                entropy_out, mfcc_row);
}

}  // namespace sspv
