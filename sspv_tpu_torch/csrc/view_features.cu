// K1: fused signal-view features for one (n_frames + 1, hop) rows view.
//
// Replaces: sspv_tpu/ops/pallas_view.py:169 `_view_kernel` (and its
// transposed twin `_view_kernel_t`, :252, which computes the same function
// for the TPU's parameter layout).
//
// Per frame (frame f is rows f and f + 1, 2 * hop samples that lie side by
// side in the rows view), from the raw samples x and the window w: energy
// sum((x w)^2), the windowed samples squared and summed (the plain version
// sums x^2 * w^2 with a separately rounded w^2; the two agree to rounding);
// ZCR = sign changes of the RAW samples x times the f32 reciprocal of the
// frame size, as the JAX package's compiled programs compute `count /
// frame_size` (the view path serves strictly positive windows, where
// sign(x w) == sign(x) unless the product underflows to zero; K3 counts the
// windowed signs instead); the power of the n_fft / 2 + 1 bins of the
// windowed frame's spectrum, the Nyquist bin included; mel (clamped at
// 1e-10) -> log -> ortho DCT -> lifter; and the normalized-PSD entropy
// (clamped at 1e-12) / log(n_bins). Only energy, zcr, entropy (F,) and mfcc
// (F, num_ceps) reach device memory.
//
// What bounds it on the H100: the rows are read once (0.23 GB per hour of
// audio at 320/160, 0.07 ms of HBM) and the function needs one real FFT of
// n_fft = 512 points per frame (11.5 kFLOP, 4 GFLOP per hour, 0.09 ms at
// the fp32 peak): operations bound the function, barely ahead of the bytes.
// What bounds this design is the shared-memory traffic of the FFT's three
// stages (about 12 KB read and written per frame) and the instruction count
// of the tail (the entropy's IEEE divisions and logf above all), far below
// the 0.33 MFLOP per frame of the dense fp32 DFT product it replaces.
// What the design does about it: one frame per warp (fft.cuh), eight warps
// per block and a grid-stride loop over frames, so a frame's bits depend on
// its samples alone, not on block, launch or shard; the frame goes from the
// rows view (16 bytes a lane where hop % 4 == 0 and the view is 16-byte
// aligned, one float a lane otherwise, chosen per launch: one kernel for
// every hop, no tile, no seam row and no zero fill, since the last frame
// ends where the view ends) through registers, where the window is applied
// and the energy and the raw sign changes are taken, into the packed FFT
// buffer; the power row replaces the FFT's free buffer; the tail
// (spectral_tail.cuh) is the one K3 runs. Each sample is read by the two
// frames that share it; the second read comes from L2. Twiddles come from
// the host-built table; everything is IEEE fp32 (no fast-math): logf, the
// divisions and the entropy's x log x match the PyTorch version to rounding.
// A transform size outside {256, 512, 1024, 2048} or shorter than the frame
// is refused; the pipeline routes such geometries to K3.

#include "fft.cuh"
#include "spectral_tail.cuh"
#include "view_common.cuh"

namespace {

constexpr int kWarps = 8;

// Floats of a block's shared memory: the table, then per warp the two FFT
// buffers and the log-mel row.
template <int N>
constexpr size_t view_features_floats(int num_filters) {
  return (size_t)sspv::round4(sspv::fft::table_floats(N)) +
         (size_t)kWarps *
             (sspv::fft::work_floats(N) + sspv::round4(num_filters));
}

template <int N, bool VEC>
__global__ void __launch_bounds__(kWarps * 32) view_features_fft_kernel(
    const float* __restrict__ rows, int n_frames, int hop,
    const float* __restrict__ window, const float* __restrict__ table,
    const float* __restrict__ fb_t, const int* __restrict__ mel_ranges,
    int num_filters, const float* __restrict__ dct,
    const float* __restrict__ lifter, int num_ceps, float log_bins,
    float* __restrict__ energy, float* __restrict__ zcr,
    float* __restrict__ entropy, float* __restrict__ mfcc) {
  namespace fft = sspv::fft;
  extern __shared__ float4 smem4[];
  float* tw = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int frame = 2 * hop;
  float* buf_a = tw + sspv::round4(fft::table_floats(N)) +
                 warp * (fft::work_floats(N) + sspv::round4(num_filters));
  float* buf_b = buf_a + N;
  float* logmel = buf_b + N;

  fft::load_table<N>(table, tw);
  __syncthreads();

  for (int f = blockIdx.x * kWarps + warp; f < n_frames;
       f += gridDim.x * kWarps) {
    float e = 0.f;
    int changes = 0;
    fft::pack_frame<N, true, VEC, true>(rows + (size_t)f * hop, frame, window,
                                        buf_a, lane, e, changes);
    e = sspv::warp_sum(e);
    changes = sspv::warp_sum(changes);
    __syncwarp();
    float* cur = buf_a;
    float* other = buf_b;
    fft::fft_stages<N>(cur, other, tw + fft::untangle_floats(N), lane);
    float* power = other;  // bins 0..N/2 over the free buffer
    fft::untangle<N>(cur, tw, lane, [power](int k, float re, float im) {
      power[k] = re * re + im * im;
    });
    __syncwarp();

    if (lane == 0) {
      energy[f] = e;
      zcr[f] = (float)changes * (1.f / (float)frame);
    }
    sspv::spectral_tail<N>(power, logmel, fb_t, mel_ranges, num_filters, dct,
                           lifter, num_ceps, log_bins, 1, lane, entropy + f,
                           mfcc + (size_t)f * num_ceps);
  }
}

template <int N, bool VEC>
int launch_view_features(const float* rows, int n_frames, int hop,
                         const float* window, const float* table,
                         const float* fb_t, const int* mel_ranges,
                         int num_filters, const float* dct,
                         const float* lifter, int num_ceps, float log_bins,
                         float* energy, float* zcr, float* entropy,
                         float* mfcc, cudaStream_t stream) {
  const size_t smem = sizeof(float) * view_features_floats<N>(num_filters);
  auto kernel = view_features_fft_kernel<N, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = sspv::fft::grid_blocks(n_frames, kWarps);
  kernel<<<blocks, kWarps * 32, smem, stream>>>(
      rows, n_frames, hop, window, table, fb_t, mel_ranges, num_filters, dct,
      lifter, num_ceps, log_bins, energy, zcr, entropy, mfcc);
  return (int)cudaGetLastError();
}

}  // namespace

// `n_fft` in {256, 512, 1024, 2048} with 2 * hop <= n_fft, `window` the
// (2 * hop,) analysis window, `table` the twiddle table of n_fft, `fb_t`
// (n_fft / 2 + 1, num_filters) and `mel_ranges` (num_filters, 2) the
// [start, end) bins of each filter's nonzeros. Returns the CUDA error of the
// launch (0 on success, cudaErrorInvalidValue for a geometry it does not
// take).
extern "C" int sspv_view_features(
    const float* rows, int n_frames, int hop, const float* window,
    const float* table, int n_fft, const float* fb_t, const int* mel_ranges,
    int num_filters, const float* dct, const float* lifter, int num_ceps,
    float log_bins, float* energy, float* zcr, float* entropy, float* mfcc,
    void* stream) {
  if (hop < 1 || 2 * hop > n_fft) return (int)cudaErrorInvalidValue;
  const bool vec = hop % 4 == 0 && sspv::fft::aligned16(rows) &&
                   sspv::fft::aligned16(window);
#define SSPV_VIEW_FEATURES(N)                                                 \
  case N:                                                                     \
    return (vec ? launch_view_features<N, true>                               \
                : launch_view_features<N, false>)(                            \
        rows, n_frames, hop, window, table, fb_t, mel_ranges, num_filters,    \
        dct, lifter, num_ceps, log_bins, energy, zcr, entropy, mfcc,          \
        (cudaStream_t)stream);
  switch (n_fft) {
    SSPV_VIEW_FEATURES(256)
    SSPV_VIEW_FEATURES(512)
    SSPV_VIEW_FEATURES(1024)
    SSPV_VIEW_FEATURES(2048)
  }
#undef SSPV_VIEW_FEATURES
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sspv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
