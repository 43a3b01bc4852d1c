// K3: fused frames-path features for raw (n_frames, frame) frames.
//
// Replaces: sspv_tpu/ops/pallas_kernels.py:43 `_feature_kernel` (launcher
// `_fused_call` :120, `pallas_call` :150, wrapper `fused_features` :174).
//
// Per frame, from the raw samples x and the window w: energy sum((x w)^2);
// ZCR = sign changes of the WINDOWED samples x w (a window with zeros, such as
// Hann, changes the count) times the f32 reciprocal of the frame size, as the
// JAX package's compiled programs compute `count / frame_size`; the power of
// the n_bins bins of the windowed frame's spectrum; mel (clamped at 1e-10) ->
// log -> ortho DCT -> lifter; and, unless the entropy spectrum is a separate
// one (the wrapper then computes it and the kernel writes zeros), the
// normalized-PSD entropy (clamped at 1e-12) / log(n_bins). Frames are
// independent rows here, not the overlapping rows view of K1. Only energy,
// zcr, entropy (F,) and mfcc (F, num_ceps) reach device memory.
//
// Two kernels, chosen by the wrapper from the geometry alone
// (`frame_kernels.kernel_route`):
//
// 1. `sspv_frame_features_fft`, the main route: the spectrum is the real FFT
//    (fft.cuh) of the windowed frame at N = n_fft, a power of two in
//    256..2048 that is no shorter than the frame.
//    What bounds it on the H100: the frames are read once (0.6 GB per hour of
//    audio at 400/160, 0.18 ms of HBM) and the FFT needs 11.5 kFLOP per
//    frame at N = 512, so device memory bounds the function; what bounds this
//    design is the shared-memory traffic of the FFT's three stages (about
//    12 KB read and written per frame) and the instruction count of the
//    tail, far below the 0.41 MFLOP per frame of the dense product.
//    What the design does about it: one frame per warp, eight warps per
//    block and a grid-stride loop over frames, so a frame's arithmetic never
//    depends on where it sits; the windowed samples go from device memory
//    (16 bytes a lane where the frame allows) through registers, where the
//    energy and the sign changes are taken, into the packed FFT buffer; the
//    power row replaces the FFT's free buffer; the tail (spectral_tail.cuh,
//    shared with K1) sums each mel filter over its nonzero bins only (ranges
//    from the host), about 2 * n_bins multiply-adds per frame instead of
//    n_bins * num_filters.
// 2. `sspv_frame_features_dense`, the dense route for every other geometry
//    (bases the pipeline did not build, an odd or non-power-of-two n_fft,
//    n_fft outside 256..2048, a frame longer than n_fft): the DFT pair as one
//    tensor-core product, frames (F, frame) x bases (frame, 2 n_bins), whose
//    columns interleave (wc_k, ws_k), in 3xTF32: a_lo b_hi + a_hi b_lo +
//    a_hi b_hi into fp32 accumulators, hi = tf32(v), lo = tf32(v - hi): each
//    product to within 3 * 2^-22 of it (two roundings of lo and the dropped
//    a_lo b_lo) where fp32 rounds to 2^-24, so about fp32's accuracy; no
//    single-pass TF32, no bf16. The frames are split here as they are
//    read; the bases once, on the host, and packed in fragment order
//    (`frame_kernels.pack_dense_bases`).
//    What bounds it on the H100: the product, 2 * frame * 2 n_bins flop per
//    frame three times (1.93 MFLOP at 400 x 201 bins), at the 495 TFLOP/s
//    TF32 peak (0.70 ms per hour of audio at 400/160, n_fft 400), well
//    above the frames' bytes (0.17 ms); mma.sync reaches part of that peak.
//    What the design does about it: blocks of 32 frames (16 for at most 16
//    frames or where 32 power rows do not fit), 8 warps, two blocks an SM,
//    so one block's staging and tail overlap the other's product; each warp
//    computes every frame of the block against 4 of the 32 n8 column tiles
//    of a step (strided, so a short last step spreads over the warps; a
//    warp with none left skips it), with m16n8k8 mma.sync (mma_tf32.cuh).
//    The block's frames sit in shared memory (cp.async, 16 bytes a lane
//    where the frame allows), all of their samples where they fit, else in
//    chunks staged again for each step. The bases (1.6 MB at 400 x 402,
//    resident in L2 across blocks; hi and lo in fragment order, one
//    coalesced 16-byte load a lane per 8 x 8 tile) go straight from L2 into
//    registers two 8-sample steps ahead, with no branch and no block
//    barrier in the product's loop. Within each step the mma's k = t and
//    t + 4 are samples 2t and 2t + 1, one 8-byte load. The accumulator
//    gives each lane re_k and im_k of one bin and frame in (d0, d1) and
//    (d2, d3), so the power is formed in registers and only the power row
//    reaches shared memory.
//    Energy and ZCR come from the staged samples; the tail is
//    spectral_tail.cuh's, over the mel ranges from the host, which cover
//    every nonzero weight of any filterbank. On the card (PERF.md) the
//    loop's loads, splits and addressing and mma.sync's rate, not the bytes,
//    hold it at 5x the TF32 bound: a wgmma design is the next step.
// Everything is IEEE fp32 (no fast-math): logf, the divisions and the
// entropy's x log x match the PyTorch version to rounding.

#include <type_traits>

#include "fft.cuh"
#include "mma_tf32.cuh"
#include "spectral_tail.cuh"
#include "view_common.cuh"

// -- the dense route ----------------------------------------------------------

namespace {

constexpr int kDenseWarps = 8;
constexpr int kTilesPerWarp = 4;  // n8 tiles a warp computes in a full step
constexpr int kStepTiles = kDenseWarps * kTilesPerWarp;  // 256 columns
constexpr int kMaxFilters = 256;  // the tail's log-mel rows: 8 KiB
constexpr int kDenseSmemBytes = 232448;  // what a block may use

// Floats between two frames' rows of the staged samples (8-byte fragment
// loads of 16 lanes hit 32 distinct banks: a stride of 8 or 24 mod 32) and
// of the power rows.
__host__ __device__ constexpr int dense_sample_stride(int chunk) {
  return ((chunk + 15) & ~15) + 8;
}
__host__ __device__ constexpr int dense_power_stride(int n_bins) {
  return (sspv::round4(n_bins) & 7) ? sspv::round4(n_bins)
                                    : sspv::round4(n_bins) + 4;
}
// Per frame its power row, its staged samples, 32 lanes' energy sums and
// its sign-change count; then each warp's log-mel row.
__host__ __device__ constexpr size_t dense_smem_bytes(int block_frames,
                                                      int n_bins, int chunk) {
  return sizeof(float) *
         ((size_t)block_frames * (dense_power_stride(n_bins) +
                                  dense_sample_stride(chunk) + 32 + 1) +
          (size_t)kDenseWarps * kMaxFilters);
}

// Two adjacent staged samples, one 8-byte shared-memory load.
struct alignas(8) SamplePair {
  float even, odd;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#elif !defined(__CUDACC__)
  std::memcpy(dst, src, 16);
#endif
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#elif !defined(__CUDACC__)
  *dst = *src;
#endif
}

// Wait for this thread's copies (done at once in the CPU emulation).
__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// Samples [k0, k0 + klen) of the block's frames into `tile` (rows of
// `stride` floats), zeros past the frame and for rows past `nb`.
__device__ __forceinline__ void stage_frames(float* tile, int stride,
                                             const float* block_frames,
                                             int frame, int nb, int rows,
                                             int k0, int klen, bool vec) {
  if (vec) {
    const int quads = klen / 4;
    for (int i = threadIdx.x; i < rows * quads; i += blockDim.x) {
      const int f = i / quads;
      const int s = 4 * (i - f * quads);
      float* dst = tile + f * stride + s;
      if (f < nb && k0 + s < frame)
        cp_async16(dst, block_frames + (size_t)f * frame + k0 + s);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < rows * klen; i += blockDim.x) {
      const int f = i / klen;
      const int s = i - f * klen;
      float* dst = tile + f * stride + s;
      if (f < nb && k0 + s < frame)
        cp_async4(dst, block_frames + (size_t)f * frame + k0 + s);
      else
        *dst = 0.f;
    }
  }
}

// Two blocks an SM (at most 128 registers a thread): one block's tail and
// staging overlap the other's product.
template <int MT>
__global__ void __launch_bounds__(kDenseWarps * 32, 2)
    frame_features_dense_kernel(
        const float* __restrict__ frames, int n_frames, int frame,
        const float* __restrict__ window, const float4* __restrict__ bases,
        int n_bins, int chunk, int vec, const float* __restrict__ fb_t,
        const int* __restrict__ mel_ranges, int num_filters,
        const float* __restrict__ dct, const float* __restrict__ lifter,
        int num_ceps, float log_bins, int compute_entropy,
        float* __restrict__ energy, float* __restrict__ zcr,
        float* __restrict__ entropy, float* __restrict__ mfcc) {
  constexpr int BM = 16 * MT;  // frames of the block
  extern __shared__ float4 smem4[];
  const int pstride = dense_power_stride(n_bins);
  const int astride = dense_sample_stride(chunk);
  float* power = reinterpret_cast<float*>(smem4);  // (BM, pstride)
  float* tile = power + BM * pstride;              // (BM, astride)
  float* e_lane = tile + BM * astride;             // (BM, 32)
  int* z_acc = reinterpret_cast<int*>(e_lane + BM * 32);  // (BM,)
  float* logmel = e_lane + BM * 33 + (threadIdx.x >> 5) * kMaxFilters;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int i0 = blockIdx.x * BM;
  const int nb = min(BM, n_frames - i0);
  const float* block_frames = frames + (size_t)i0 * frame;
  const int kp = (frame + 15) & ~15;  // the product's depth, zero-padded
  const int n_tiles = (2 * n_bins + 7) / 8;
  const int n_steps = (n_tiles + kStepTiles - 1) / kStepTiles;
  const int tiles_padded = n_steps * kStepTiles;
  const int n_chunks = (kp + chunk - 1) / chunk;

  for (int i = threadIdx.x; i < BM * 32; i += blockDim.x) e_lane[i] = 0.f;
  for (int f = threadIdx.x; f < BM; f += blockDim.x) z_acc[f] = 0;

  // One column step with NT tiles a warp (4, or fewer in a last step that
  // fills fewer: no warp computes more padded tiles than a short step
  // leaves it).
  auto run_step = [&](int step, auto nt) {
    constexpr int NT = decltype(nt)::value;
    // this warp's NT tiles of the step, strided so that a short last step
    // spreads over the warps; a warp with no live tile skips the step
    // (warp-uniform), the padded tiles beside a live one are zeros
    int tile_of[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      tile_of[n] = step * kStepTiles + warp + kDenseWarps * n;
    const bool live = tile_of[0] < n_tiles;
    float acc[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[m][n][r] = 0.f;

    for (int c = 0; c < n_chunks; ++c) {
      const int k0 = c * chunk;
      const int klen = min(chunk, kp - k0);  // a multiple of 16
      if (step == 0 || n_chunks > 1) {
        __syncthreads();  // the previous chunk's readers are done
        stage_frames(tile, astride, block_frames, frame, nb, BM, k0, klen,
                     vec);
        cp_async_wait_all();
        __syncthreads();
      }
      if (step == 0) {
        // Energy and ZCR of this chunk's samples, one warp per frame. A
        // lane sums the samples of its residue mod 32 whatever the chunks
        // (a multiple of 32 where there are several), so a frame's energy
        // does not depend on the plan; the sign change across a chunk
        // boundary reads the sample before it from memory.
        const int len = min(chunk, frame - k0);
        for (int f = warp; f < nb; f += kDenseWarps) {
          const float* x = tile + f * astride;
          float e = e_lane[f * 32 + lane];
          int changes = 0;
          for (int s = lane; s < len; s += 32) {
            const float v = x[s] * __ldg(window + k0 + s);
            e = fmaf(v, v, e);
            if (s > 0) {
              const float p = x[s - 1] * __ldg(window + k0 + s - 1);
              changes += sspv::sign_of(v) != sspv::sign_of(p);
            } else if (k0 > 0) {
              const float p = __ldg(block_frames + (size_t)f * frame + k0 - 1) *
                              __ldg(window + k0 - 1);
              changes += sspv::sign_of(v) != sspv::sign_of(p);
            }
          }
          e_lane[f * 32 + lane] = e;
          changes = sspv::warp_sum(changes);
          if (lane == 0) z_acc[f] += changes;
        }
      }
      if (!live) continue;

      // The bases' fragments go from L2 to registers two 8-sample steps
      // ahead, one coalesced 16-byte load a lane and tile, hi and lo
      // together (the last loads repeat the last step's); no branch and no
      // block barrier in the loop.
      const int n_k8 = klen / 8;  // even
      const size_t kb_stride = (size_t)tiles_padded * 32;
      const float4* b_at[NT];
      float4 ahead0[NT], ahead1[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        b_at[n] = bases + (size_t)(k0 / 8) * kb_stride +
                  (size_t)tile_of[n] * 32 + lane;
        ahead0[n] = __ldg(b_at[n]);
        ahead1[n] = __ldg(b_at[n] + kb_stride);
      }
      const float* x_at = tile + g * astride + 2 * t;
      for (int j = 0; j < n_k8; j += 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t b_hi[NT][2], b_lo[NT][2];
          const size_t next = (size_t)min(j + 2 + h, n_k8 - 1) * kb_stride;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float4 v = h ? ahead1[n] : ahead0[n];
            b_hi[n][0] = sspv::float_bits(v.x);  // B[t][g]
            b_hi[n][1] = sspv::float_bits(v.y);  // B[t + 4][g]
            b_lo[n][0] = sspv::float_bits(v.z);
            b_lo[n][1] = sspv::float_bits(v.w);
            (h ? ahead1[n] : ahead0[n]) = __ldg(b_at[n] + next);
          }
          // the mma's k = t and t + 4 are samples 2t and 2t + 1 of the
          // 8-sample step (the bases are packed in the same order)
          const float* x0 = x_at + 8 * (j + h);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const SamplePair u = *reinterpret_cast<const SamplePair*>(
                x0 + 16 * m * astride);
            const SamplePair w = *reinterpret_cast<const SamplePair*>(
                x0 + (16 * m + 8) * astride);
            uint32_t a_hi[4], a_lo[4];
            sspv::split_tf32(u.even, a_hi[0], a_lo[0]);  // A[g][t]
            sspv::split_tf32(w.even, a_hi[1], a_lo[1]);  // A[g + 8][t]
            sspv::split_tf32(u.odd, a_hi[2], a_lo[2]);   // A[g][t + 4]
            sspv::split_tf32(w.odd, a_hi[3], a_lo[3]);   // A[g + 8][t + 4]
#pragma unroll
            for (int n = 0; n < NT; ++n)
              sspv::mma_3xtf32_m16n8k8(acc[m][n], a_hi, a_lo, b_hi[n],
                                       b_lo[n]);
          }
        }
      }
    }

    // (d0, d1) = (re, im) of bin 4 tile + t for frame g, (d2, d3) for g + 8
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int bin = 4 * tile_of[n] + t;
      if (bin >= n_bins) continue;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* d = acc[m][n];
        float* p = power + (16 * m + g) * pstride + bin;
        p[0] = d[0] * d[0] + d[1] * d[1];
        p[8 * pstride] = d[2] * d[2] + d[3] * d[3];
      }
    }
  };
  for (int step = 0; step < n_steps; ++step) {
    const int rest = n_tiles - step * kStepTiles;
    switch (min(kTilesPerWarp, (rest + kDenseWarps - 1) / kDenseWarps)) {
      case 4: run_step(step, std::integral_constant<int, 4>{}); break;
      case 3: run_step(step, std::integral_constant<int, 3>{}); break;
      case 2: run_step(step, std::integral_constant<int, 2>{}); break;
      default: run_step(step, std::integral_constant<int, 1>{});
    }
  }
  __syncthreads();

  for (int f = warp; f < nb; f += kDenseWarps) {
    const float e = sspv::warp_sum(e_lane[f * 32 + lane]);
    if (lane == 0) {
      energy[i0 + f] = e;
      zcr[i0 + f] = (float)z_acc[f] * (1.f / (float)frame);
    }
  }
  // The tail, one warp per frame.
  for (int f = warp; f < nb; f += kDenseWarps)
    sspv::spectral_tail(n_bins, power + f * pstride, logmel, fb_t, mel_ranges,
                        num_filters, dct, lifter, num_ceps, log_bins,
                        compute_entropy, lane, entropy + i0 + f,
                        mfcc + (size_t)(i0 + f) * num_ceps);
}

template <int MT>
int launch_dense_route(const float* frames, int n_frames, int frame,
                       const float* window, const float* bases, int n_bins,
                       int chunk, const float* fb_t, const int* mel_ranges,
                       int num_filters, const float* dct, const float* lifter,
                       int num_ceps, float log_bins, int compute_entropy,
                       float* energy, float* zcr, float* entropy, float* mfcc,
                       cudaStream_t stream) {
  const size_t smem = dense_smem_bytes(16 * MT, n_bins, chunk);
  auto kernel = frame_features_dense_kernel<MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = frame % 4 == 0 && sspv::fft::aligned16(frames);
  const int blocks = (n_frames + 16 * MT - 1) / (16 * MT);
  kernel<<<blocks, kDenseWarps * 32, smem, stream>>>(
      frames, n_frames, frame, window,
      reinterpret_cast<const float4*>(bases), n_bins, chunk, vec, fb_t,
      mel_ranges, num_filters, dct, lifter, num_ceps, log_bins,
      compute_entropy, energy, zcr, entropy, mfcc);
  return (int)cudaGetLastError();
}

}  // namespace

// The dense route. `bases` is `frame_kernels.pack_dense_bases(wc, ws)` for
// this frame size and n_bins; `block_frames` (32 or 16) and `chunk`
// (samples staged at a time, a multiple of 16) are
// `frame_kernels.dense_plan`'s; `mel_ranges` as for the FFT route. Returns
// the CUDA error of the launch (0 on success, cudaErrorInvalidValue for a
// plan that does not fit a block's shared memory or more than 256 mel
// bands).
extern "C" int sspv_frame_features_dense(
    const float* frames, int n_frames, int frame, const float* window,
    const float* bases, int n_bins, int block_frames, int chunk,
    const float* fb_t, const int* mel_ranges, int num_filters,
    const float* dct, const float* lifter, int num_ceps, float log_bins,
    int compute_entropy, float* energy, float* zcr, float* entropy,
    float* mfcc, void* stream) {
  if (chunk <= 0 || chunk % 16 != 0 || n_bins <= 0 ||
      num_filters > kMaxFilters ||
      dense_smem_bytes(block_frames, n_bins, chunk) > kDenseSmemBytes)
    return (int)cudaErrorInvalidValue;
#define SSPV_DENSE_ROUTE(MT)                                                 \
  case 16 * MT:                                                              \
    return launch_dense_route<MT>(                                           \
        frames, n_frames, frame, window, bases, n_bins, chunk, fb_t,         \
        mel_ranges, num_filters, dct, lifter, num_ceps, log_bins,            \
        compute_entropy, energy, zcr, entropy, mfcc, (cudaStream_t)stream);
  switch (block_frames) {
    SSPV_DENSE_ROUTE(1)
    SSPV_DENSE_ROUTE(2)
  }
#undef SSPV_DENSE_ROUTE
  return (int)cudaErrorInvalidValue;
}

// -- the FFT route ------------------------------------------------------------

namespace {

constexpr int kFftWarps = 8;

// Floats of a block's shared memory: the table, then per warp the two FFT
// buffers and the log-mel row.
template <int N>
constexpr size_t fft_route_floats(int num_filters) {
  return (size_t)sspv::round4(sspv::fft::table_floats(N)) +
         (size_t)kFftWarps *
             (sspv::fft::work_floats(N) + sspv::round4(num_filters));
}

template <int N, bool VEC>
__global__ void __launch_bounds__(kFftWarps * 32) frame_features_fft_kernel(
    const float* __restrict__ frames, int n_frames, int frame,
    const float* __restrict__ window, const float* __restrict__ table,
    const float* __restrict__ fb_t, const int* __restrict__ mel_ranges,
    int num_filters, const float* __restrict__ dct,
    const float* __restrict__ lifter, int num_ceps, float log_bins,
    int compute_entropy, float* __restrict__ energy, float* __restrict__ zcr,
    float* __restrict__ entropy, float* __restrict__ mfcc) {
  namespace fft = sspv::fft;
  extern __shared__ float4 smem4[];
  float* tw = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* buf_a = tw + sspv::round4(fft::table_floats(N)) +
                 warp * (fft::work_floats(N) + sspv::round4(num_filters));
  float* buf_b = buf_a + N;
  float* logmel = buf_b + N;

  fft::load_table<N>(table, tw);
  __syncthreads();

  for (int f = blockIdx.x * kFftWarps + warp; f < n_frames;
       f += gridDim.x * kFftWarps) {
    float e = 0.f;
    int changes = 0;
    fft::pack_frame<N, true, VEC>(frames + (size_t)f * frame, frame, window,
                                  buf_a, lane, e, changes);
    e = sspv::warp_sum(e);
    changes = sspv::warp_sum(changes);
    __syncwarp();
    float* cur = buf_a;
    float* other = buf_b;
    fft::fft_stages<N>(cur, other, tw + fft::untangle_floats(N), lane);
    float* power = other;  // n_bins floats over the free buffer
    fft::untangle<N>(cur, tw, lane, [power](int k, float re, float im) {
      power[k] = re * re + im * im;
    });
    __syncwarp();

    if (lane == 0) {
      energy[f] = e;
      zcr[f] = (float)changes * (1.f / (float)frame);
    }
    // The entropy is 0 here when the wrapper computes it from a separate
    // spectrum (compute_entropy == 0).
    sspv::spectral_tail<N>(power, logmel, fb_t, mel_ranges, num_filters, dct,
                           lifter, num_ceps, log_bins, compute_entropy, lane,
                           entropy + f, mfcc + (size_t)f * num_ceps);
  }
}

template <int N, bool VEC>
int launch_fft_route(const float* frames, int n_frames, int frame,
                     const float* window, const float* table,
                     const float* fb_t, const int* mel_ranges, int num_filters,
                     const float* dct, const float* lifter, int num_ceps,
                     float log_bins, int compute_entropy, float* energy,
                     float* zcr, float* entropy, float* mfcc,
                     cudaStream_t stream) {
  const size_t smem = sizeof(float) * fft_route_floats<N>(num_filters);
  auto kernel = frame_features_fft_kernel<N, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = sspv::fft::grid_blocks(n_frames, kFftWarps);
  kernel<<<blocks, kFftWarps * 32, smem, stream>>>(
      frames, n_frames, frame, window, table, fb_t, mel_ranges, num_filters,
      dct, lifter, num_ceps, log_bins, compute_entropy, energy, zcr, entropy,
      mfcc);
  return (int)cudaGetLastError();
}

}  // namespace

// The FFT route: `n_fft` in {256, 512, 1024, 2048}, frame <= n_fft, `table`
// the twiddle table of n_fft, `fb_t` (n_fft / 2 + 1, num_filters) and
// `mel_ranges` (num_filters, 2) the [start, end) bins of each filter's
// nonzeros. Returns the CUDA error of the launch (0 on success,
// cudaErrorInvalidValue for a geometry it does not take).
extern "C" int sspv_frame_features_fft(
    const float* frames, int n_frames, int frame, const float* window,
    const float* table, int n_fft, const float* fb_t, const int* mel_ranges,
    int num_filters, const float* dct, const float* lifter, int num_ceps,
    float log_bins, int compute_entropy, float* energy, float* zcr,
    float* entropy, float* mfcc, void* stream) {
  if (frame > n_fft) return (int)cudaErrorInvalidValue;
  const bool vec = frame % 4 == 0 && sspv::fft::aligned16(frames) &&
                   sspv::fft::aligned16(window);
#define SSPV_FFT_ROUTE(N)                                                     \
  case N:                                                                     \
    return (vec ? launch_fft_route<N, true> : launch_fft_route<N, false>)(    \
        frames, n_frames, frame, window, table, fb_t, mel_ranges,             \
        num_filters, dct, lifter, num_ceps, log_bins, compute_entropy,        \
        energy, zcr, entropy, mfcc, (cudaStream_t)stream);
  switch (n_fft) {
    SSPV_FFT_ROUTE(256)
    SSPV_FFT_ROUTE(512)
    SSPV_FFT_ROUTE(1024)
    SSPV_FFT_ROUTE(2048)
  }
#undef SSPV_FFT_ROUTE
  return (int)cudaErrorInvalidValue;
}
