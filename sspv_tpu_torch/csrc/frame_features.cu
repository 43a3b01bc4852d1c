// K3: fused frames-path features for raw (n_frames, frame) frames.
//
// Replaces: sspv_tpu/ops/pallas_kernels.py:43 `_feature_kernel` (launcher
// `_fused_call` :120, `pallas_call` :150, wrapper `fused_features` :174).
//
// Per frame, from the raw samples x and the window w: energy sum((x w)^2);
// ZCR = sign changes of the WINDOWED samples x w (a window with zeros, such as
// Hann, changes the count) times the f32 reciprocal of the frame size, as the
// JAX package's compiled programs compute `count / frame_size`; the power of
// the n_bins bins from the windowed DFT pair re = x . wc[:, k],
// im = x . ws[:, k]; mel (clamped at 1e-10) -> log -> ortho DCT -> lifter;
// and, unless the entropy spectrum is a separate one (the wrapper then
// computes it and the kernel writes zeros), the normalized-PSD entropy
// (clamped at 1e-12) / log(n_bins). Frames are independent rows here, not the
// overlapping rows view of K1. Only energy, zcr, entropy (F,) and mfcc
// (F, num_ceps) reach device memory.
//
// What bounds it on the H100: the DFT pair, 2 * 2 * frame * n_bins flop per
// frame (0.41 MFLOP at 400 x 257), runs as fp32 FMAs outside the tensor cores
// (67 TFLOP/s peak); the frames are read once (0.6 GB per hour of audio at
// 400/160, 0.18 ms of HBM), so it is FMA-bound. The TPU kernel held both
// 400 x 257 bases in VMEM; here they do not fit in a block's shared memory
// beside the frames.
// What the design does about it: 32 frames per block and one thread per bin
// for the bins that fill whole warps (256 of 257 at n_fft = 512), each
// thread with re/im accumulators for all 32 frames in registers: every basis
// element read (coalesced across the warp, L2 resident across blocks) feeds
// 32 FMAs, and the samples are 16-byte shared-memory broadcasts. The bins
// past the last whole warp (the Nyquist bin at n_fft = 512) are warp dot
// products, so no warp runs the DFT loop for one live lane. 256 threads and
// at most 128 registers a thread keep two blocks on every SM. Frames are
// staged in chunks of at most kChunk samples, so any frame size fits in
// shared memory (a frame that is not a multiple of 4 is zero-padded in the
// tile and its basis reads are guarded). The power rows stay in shared memory
// for the mel and entropy stages.
// Everything is IEEE fp32 (no fast-math): logf, the divisions and the
// entropy's x log x match the PyTorch version to rounding.

#include "view_common.cuh"

namespace {

constexpr int kThreads = 256;
// Samples of every frame staged in shared memory at a time: 32 x 512 floats
// (64 KiB) at most, whatever the frame size.
constexpr int kChunk = 512;
using sspv::kBlockFrames;

__global__ void __launch_bounds__(kThreads, 2) frame_features_kernel(
    const float* __restrict__ frames, int n_frames, int frame,
    const float* __restrict__ window, const float* __restrict__ wc,
    const float* __restrict__ ws, int n_bins,
    const float* __restrict__ fb_t, int num_filters,
    const float* __restrict__ dct, const float* __restrict__ lifter,
    int num_ceps, float log_bins, int compute_entropy,
    float* __restrict__ energy, float* __restrict__ zcr,
    float* __restrict__ entropy, float* __restrict__ mfcc) {
  extern __shared__ float4 smem4[];
  const int chunk = min(frame, kChunk);
  const int tstride = sspv::round4(chunk);
  const int pstride = sspv::round4(n_bins);
  const int n_main = n_bins & ~31;  // bins of the thread-per-bin passes
  const int n_tail = n_bins - n_main;  // < 32 bins: warp dot products
  float* tile = reinterpret_cast<float*>(smem4);      // (kBlockFrames, tstride)
  float* power = tile + kBlockFrames * tstride;        // (kBlockFrames, pstride)
  float* logmel = power + kBlockFrames * pstride;      // (kBlockFrames, filters)
  float* tail_re = logmel + kBlockFrames * num_filters;  // (kBlockFrames, 32)
  float* tail_im = tail_re + kBlockFrames * 32;           // (kBlockFrames, 32)
  float* e_acc = tail_im + kBlockFrames * 32;             // (kBlockFrames,)
  int* z_acc = reinterpret_cast<int*>(e_acc + kBlockFrames);

  const int i0 = blockIdx.x * kBlockFrames;
  const int nb = min(kBlockFrames, n_frames - i0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* block_frames = frames + (size_t)i0 * frame;

  for (int i = threadIdx.x; i < kBlockFrames * 32; i += blockDim.x) {
    tail_re[i] = 0.f;
    tail_im[i] = 0.f;
  }
  for (int f = threadIdx.x; f < kBlockFrames; f += blockDim.x) {
    e_acc[f] = 0.f;
    z_acc[f] = 0;
  }

  // One pass per blockDim whole-warp bins (one pass unless n_bins > 256 + 31);
  // the loop bounds are uniform across the block, so every thread meets every
  // barrier. The first pass also sums energy, ZCR and the tail bins.
  const int passes = max(1, (n_main + (int)blockDim.x - 1) / (int)blockDim.x);
  for (int pass = 0; pass < passes; ++pass) {
    const int k = pass * blockDim.x + threadIdx.x;
    const bool live = k < n_main;
    float re[kBlockFrames], im[kBlockFrames];
#pragma unroll
    for (int f = 0; f < kBlockFrames; ++f) {
      re[f] = 0.f;
      im[f] = 0.f;
    }
    for (int t0 = 0; t0 < frame; t0 += chunk) {
      const int len = min(chunk, frame - t0);
      __syncthreads();  // the previous chunk's readers are done with the tile
      for (int i = threadIdx.x; i < kBlockFrames * tstride; i += blockDim.x) {
        const int f = i / tstride;
        const int t = i - f * tstride;
        tile[i] = (f < nb && t < len)
                      ? __ldg(block_frames + (size_t)f * frame + t0 + t)
                      : 0.f;
      }
      __syncthreads();

      if (pass == 0) {
        // Energy and ZCR of this chunk, one warp per frame. The sign change
        // across the chunk boundary reads the previous sample from memory.
        for (int f = warp; f < nb; f += nwarps) {
          const float* x = tile + f * tstride;
          float e = 0.f;
          int changes = 0;
          for (int t = lane; t < len; t += 32) {
            const float v = x[t] * __ldg(window + t0 + t);
            e = fmaf(v, v, e);
            if (t > 0) {
              const float p = x[t - 1] * __ldg(window + t0 + t - 1);
              changes += sspv::sign_of(v) != sspv::sign_of(p);
            } else if (t0 > 0) {
              const float p = __ldg(block_frames + (size_t)f * frame + t0 - 1) *
                              __ldg(window + t0 - 1);
              changes += sspv::sign_of(v) != sspv::sign_of(p);
            }
          }
          e = sspv::warp_sum(e);
          changes = sspv::warp_sum(changes);
          if (lane == 0) {
            e_acc[f] += e;
            z_acc[f] += changes;
          }
        }
        // The tail bins of this chunk, one warp per (frame, bin).
        for (int p = warp; p < nb * n_tail; p += nwarps) {
          const int f = p / n_tail;
          const int j = p - f * n_tail;
          const float* x = tile + f * tstride;
          float r = 0.f, q = 0.f;
          for (int t = lane; t < len; t += 32) {
            const size_t row = (size_t)(t0 + t) * n_bins + n_main + j;
            r = fmaf(x[t], __ldg(wc + row), r);
            q = fmaf(x[t], __ldg(ws + row), q);
          }
          r = sspv::warp_sum(r);
          q = sspv::warp_sum(q);
          if (lane == 0) {
            tail_re[f * 32 + j] += r;
            tail_im[f * 32 + j] += q;
          }
        }
      }

      if (live) {
        const float* c_col = wc + k;
        const float* s_col = ws + k;
        for (int t = 0; t < len; t += 4) {
          float c[4], s[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool in = t + j < len;  // the tile is zero past len
            const size_t row = (size_t)(t0 + t + j) * n_bins;
            c[j] = in ? __ldg(c_col + row) : 0.f;
            s[j] = in ? __ldg(s_col + row) : 0.f;
          }
#pragma unroll
          for (int f = 0; f < kBlockFrames; ++f) {
            const float4 x =
                *reinterpret_cast<const float4*>(tile + f * tstride + t);
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
      }
    }
    if (live) {
#pragma unroll
      for (int f = 0; f < kBlockFrames; ++f)
        power[f * pstride + k] = re[f] * re[f] + im[f] * im[f];
    }
  }
  __syncthreads();

  for (int p = threadIdx.x; p < nb * n_tail; p += blockDim.x) {
    const int f = p / n_tail;
    const int j = p - f * n_tail;
    const float r = tail_re[f * 32 + j];
    const float q = tail_im[f * 32 + j];
    power[f * pstride + n_main + j] = r * r + q * q;
  }
  for (int f = threadIdx.x; f < nb; f += blockDim.x) {
    energy[i0 + f] = e_acc[f];
    zcr[i0 + f] = (float)z_acc[f] * (1.f / (float)frame);
  }
  __syncthreads();

  // Mel filterbank -> clamp -> log, one thread per (frame, filter).
  for (int o = threadIdx.x; o < nb * num_filters; o += blockDim.x) {
    const int f = o / num_filters;
    const int m = o - f * num_filters;
    const float* p = power + f * pstride;
    float acc = 0.f;
    for (int k = 0; k < n_bins; ++k)
      acc = fmaf(p[k], __ldg(fb_t + k * num_filters + m), acc);
    logmel[o] = logf(fmaxf(acc, 1e-10f));
  }

  // Spectral entropy over the n_bins bins, one warp per frame (zeros when
  // the wrapper computes it from a separate spectrum).
  for (int f = warp; f < nb; f += nwarps) {
    const float* p = power + f * pstride;
    float h = 0.f;
    if (compute_entropy) {
      float s = 0.f;
      for (int k = lane; k < n_bins; k += 32) s += p[k];
      s = sspv::warp_sum(s);
      for (int k = lane; k < n_bins; k += 32) {
        const float pn = fmaxf(s > 0.f ? p[k] / s : 0.f, 1e-12f);
        h += pn * logf(pn);
      }
      h = sspv::warp_sum(h);
    }
    if (lane == 0) entropy[i0 + f] = compute_entropy ? -h / log_bins : 0.f;
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

static size_t frame_features_smem(int frame, int n_bins, int num_filters) {
  const int chunk = frame < kChunk ? frame : kChunk;
  return sizeof(float) * ((size_t)kBlockFrames * sspv::round4(chunk) +
                          (size_t)kBlockFrames * sspv::round4(n_bins) +
                          (size_t)kBlockFrames * num_filters +
                          2 * (size_t)kBlockFrames * 32 +
                          2 * (size_t)kBlockFrames);
}

// Returns the CUDA error of the launch (0 on success).
extern "C" int sspv_frame_features(
    const float* frames, int n_frames, int frame, const float* window,
    const float* wc, const float* ws, int n_bins, const float* fb_t,
    int num_filters, const float* dct, const float* lifter, int num_ceps,
    float log_bins, int compute_entropy, float* energy, float* zcr,
    float* entropy, float* mfcc, void* stream) {
  const size_t smem = frame_features_smem(frame, n_bins, num_filters);
  cudaError_t err = cudaFuncSetAttribute(
      frame_features_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_frames + kBlockFrames - 1) / kBlockFrames;
  frame_features_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      frames, n_frames, frame, window, wc, ws, n_bins, fb_t, num_filters, dct,
      lifter, num_ceps, log_bins, compute_entropy, energy, zcr, entropy, mfcc);
  return (int)cudaGetLastError();
}
