// K2: fused banded-ACF pitch for one (n_frames + 1, hop) rows view.
//
// Replaces: sspv_tpu/ops/pallas_view.py:476 `_pitch_kernel` (and its
// transposed twin `_pitch_kernel_t`, :587).
//
// Per frame (Wiener-Khinchin; frame f is rows f and f + 1, 2 * hop samples
// that lie side by side in the rows view): the power spectrum of the frame
// zero-padded to N, the least power of two >= frame + n_lags - 1 (1024 at
// 320/160 and at 322/161), so that no lag 0..n_lags-1 of the circular
// correlation wraps around; the ACF as the real part of the transform of the
// real, even power sequence over N, times 1/N; r0 = max(acf[0], 1e-10); the
// first maximum of acf / r0 over lags [lag_min, lag_max] (lowest lag on ties,
// like argmax); f0 = sample_rate / lag and conf = that maximum. The output is
// ungated: the caller applies the VAD and confidence gate. The JAX kernel's
// transform length (frame + lag_max rounded up to a multiple of 128) is its
// lane tiling, not part of the function: any N past frame + lag_max - 1
// gives the same linear ACF.
//
// What bounds it on the H100: two real FFTs of N = 1024 points per frame
// (2 * 25.6 kFLOP, 9 GFLOP per hour of audio, 0.14 ms at the fp32 peak)
// against 0.23 GB of rows read once (0.07 ms of HBM): operations bound the
// function. What bounds this design is the shared-memory traffic of the two
// FFTs' stages (about 50 KB read and written per frame) and their
// instruction count, far below the 0.61 MFLOP per frame of the dense
// forward and inverse products it replaces.
// What the design does about it: one frame per warp (fft.cuh), eight warps
// per block and a grid-stride loop over frames; the frame goes from device
// memory (16 bytes a lane where hop % 4 == 0, one float a lane otherwise:
// one kernel for every hop) into the packed FFT buffer; the power row, its
// even extension, the second transform and the ACF row all stay in the
// warp's two shared-memory buffers, so nothing but f0 and conf reaches
// device memory. Twiddles come from the host-built table; all arithmetic is
// IEEE fp32. A geometry whose N would pass 2048 is refused by the wrapper
// (the dense kernel this one replaces stopped earlier, at a frame of about
// 1250 samples, for its shared memory).

#include <math.h>

#include <climits>

#include "fft.cuh"

namespace {

constexpr int kWarps = 8;

template <int N>
constexpr size_t pitch_floats() {
  return (size_t)sspv::round4(sspv::fft::table_floats(N)) +
         (size_t)kWarps * sspv::fft::work_floats(N);
}

template <int N, bool VEC>
__global__ void __launch_bounds__(kWarps * 32) view_pitch_kernel(
    const float* __restrict__ rows, int n_frames, int hop,
    const float* __restrict__ table, int lag_min, int lag_max,
    float sample_rate, float* __restrict__ f0, float* __restrict__ conf) {
  namespace fft = sspv::fft;
  constexpr int M = N / 2;
  extern __shared__ float4 smem4[];
  float* tw = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* buf_a =
      tw + sspv::round4(fft::table_floats(N)) + warp * fft::work_floats(N);
  float* buf_b = buf_a + N;
  const float* stage_tw = tw + fft::untangle_floats(N);

  fft::load_table<N>(table, tw);
  __syncthreads();

  for (int f = blockIdx.x * kWarps + warp; f < n_frames;
       f += gridDim.x * kWarps) {
    float unused_e = 0.f;
    int unused_c = 0;
    fft::pack_frame<N, false, VEC>(rows + (size_t)f * hop, 2 * hop, nullptr,
                                   buf_a, lane, unused_e, unused_c);
    __syncwarp();
    float* cur = buf_a;
    float* other = buf_b;
    fft::fft_stages<N>(cur, other, stage_tw, lane);
    float* power = other;  // bins 0..M over the free buffer
    fft::untangle<N>(cur, tw, lane, [power](int k, float re, float im) {
      power[k] = re * re + im * im;
    });
    __syncwarp();

    // The even extension p[n] = power[min(n, N - n)], n < N, packed as
    // z[n] = p[2n] + i p[2n + 1] over the spent complex bins.
    for (int n = lane; n < M; n += 32) {
      const int k0 = 2 * n, k1 = 2 * n + 1;
      const int i = fft::phys(n);
      cur[i] = power[k0 <= M ? k0 : N - k0];
      cur[M + i] = power[k1 <= M ? k1 : N - k1];
    }
    __syncwarp();
    fft::fft_stages<N>(cur, other, stage_tw, lane);
    float* acf = other;  // lags 0..lag_max over the free buffer
    fft::untangle<N>(cur, tw, lane, [acf, lag_max](int k, float re, float) {
      if (k <= lag_max) acf[k] = re * (1.f / (float)N);
    });
    __syncwarp();

    // Normalized band peak: each lane keeps the first maximum of its strided
    // lags, then the warp keeps the lowest lag among equal maxima.
    const float r0 = fmaxf(acf[0], 1e-10f);
    float best = -INFINITY;
    int best_lag = INT_MAX;
    for (int l = lag_min + lane; l <= lag_max; l += 32) {
      const float v = acf[l] / r0;
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
      f0[f] = sample_rate / (float)best_lag;
      conf[f] = best;
    }
    __syncwarp();  // the next frame overwrites the buffers
  }
}

template <int N, bool VEC>
int launch_pitch(const float* rows, int n_frames, int hop, const float* table,
                 int lag_min, int lag_max, float sample_rate, float* f0,
                 float* conf, cudaStream_t stream) {
  const size_t smem = sizeof(float) * pitch_floats<N>();
  auto kernel = view_pitch_kernel<N, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = sspv::fft::grid_blocks(n_frames, kWarps);
  kernel<<<blocks, kWarps * 32, smem, stream>>>(
      rows, n_frames, hop, table, lag_min, lag_max, sample_rate, f0, conf);
  return (int)cudaGetLastError();
}

}  // namespace

// `table` is the twiddle table of `n_fft`, a power of two in
// {256, 512, 1024, 2048} with n_fft >= 2 * hop + lag_max. Returns the CUDA
// error of the launch (0 on success, cudaErrorInvalidValue for a geometry it
// does not take).
extern "C" int sspv_view_pitch(const float* rows, int n_frames, int hop,
                               const float* table, int n_fft, int lag_min,
                               int lag_max, float sample_rate, float* f0,
                               float* conf, void* stream) {
  if (2 * hop + lag_max > n_fft || lag_min < 0 || lag_min > lag_max)
    return (int)cudaErrorInvalidValue;
  const bool vec = hop % 4 == 0 && sspv::fft::aligned16(rows);
#define SSPV_PITCH(N)                                                     \
  case N:                                                                 \
    return (vec ? launch_pitch<N, true> : launch_pitch<N, false>)(        \
        rows, n_frames, hop, table, lag_min, lag_max, sample_rate, f0,    \
        conf, (cudaStream_t)stream);
  switch (n_fft) {
    SSPV_PITCH(256)
    SSPV_PITCH(512)
    SSPV_PITCH(1024)
    SSPV_PITCH(2048)
  }
#undef SSPV_PITCH
  return (int)cudaErrorInvalidValue;
}
