// K5: polyphase resampling of B int16 rows by a coprime up / down, each row
// at its own length, summed in float64, written as int16.
//
// Replaces no pl.pallas_call. The JAX package resamples on the device in
// sspv_tpu/ops/resample.py (`resample_poly_device`: the same polyphase sum
// regrouped into shifted products under lax.scan, in float32), and only
// ahead of its programs: its batch programs take rows at the pipeline's
// rate. This kernel lets the port's batch programs (parallel/mesh.py
// `_rows`) take rows at a source rate, Whisper's front end fed 48 kHz audio,
// and resample them on the card inside the call.
//
// The function (ops/resample.py `plain_resample_rows_int16`): with h the
// n_taps float32 taps of resample_poly's filter (firwin(2 * 10 * max(up,
// down) + 1, 1 / max(up, down), kaiser 5.0), cast to float32, times up) and
// n_pre_pad, n_pre_remove its alignment, output k of row b is, for k below
// the row's own output length ceil(len_b * up / down),
//   y[k] = trunc(clip(sum_s x_b[s] * h[J - s * up], -32768, 32767)),
//   J = (k + n_pre_remove) * down - n_pre_pad,
// over the s with 0 <= J - s * up < n_taps, the row zero outside
// [0, len_b); past its own output length the row is 0. An int16 times a
// float32 is exact in float64, so each fused multiply-add rounds the sum
// alone, and the sums are float64, as the configuration states.
//
// What bounds it on the H100: at 48 -> 16 kHz (up 1, down 3, 61 taps) a
// batch of 64 rows of 30 s reads 184 MB and writes 61 MB, 73 us at
// 3.35 TB/s, and sums 61 products an output, 1.87e9 float64 multiply-adds,
// 110 us at the card's 34 TFLOP/s of float64 outside the tensor cores. The
// float64 sums first, then the bytes.
// What the design does about it:
//   - Each block walks over tiles of one row's outputs (grid-stride over
//     rows x tiles). Once, it lays the filter's own taps out in shared
//     memory as doubles by (phase, residue) class (below; 8,821 taps at
//     44.1 -> 16 kHz: 70 KB; never the (W, up) matrix of the plain
//     version). For each tile it stages the source samples it needs as
//     doubles, 16-byte loads of 8 samples where the rows are aligned, kLoads
//     of them in flight a thread: each sample is read from device memory
//     once, the halo of n_taps / up samples between two tiles twice. Four
//     blocks share an SM, so one block's staging overlaps others' sums.
//   - Output k's taps are h[p + up * m] (p = J mod up) at the samples
//     s_hi - m (s_hi = (J - p) / up); outputs k and k + up share p, and
//     their samples lie down apart. A thread sums kR outputs of one phase,
//     k + up * q for q < kR. With m = rho + down * j the sample of output q
//     and tap j is a_{q - j}, a_v = x[s_hi - rho + down * v]: for each
//     residue rho, j runs over the class's taps with one new sample and one
//     tap a step into kR sums, the samples held in a ring of kR registers
//     whose slots the unrolled step names at compile time. The staged
//     samples are stored by residue mod down, and each class's taps
//     contiguous and zero-padded to a multiple of kR, so every load of the
//     loop is a constant offset from one pointer and no step tests a bound:
//     two shared loads feed kR multiply-adds.
//   - kR is 7 where a class has two taps or more (48 -> 16 kHz: 21 a
//     class), 1 where none does (44.1 -> 16 kHz: down 441 exceeds the 56
//     taps of a phase, so no sample serves two outputs of one phase). At
//     down = 3 the lanes of a warp read samples 7 apart in their residue's
//     row: distinct pairs of banks (two wavefronts); the tap is the same
//     address for the warp where up is 1 (a broadcast).
//   - The tile's outputs go to shared memory as int16, then out in
//     consecutive order, 16 bytes a store where aligned.
// One launch on the caller's stream, no atomics: each output is one
// thread's own sum in a fixed order.

#include <cuda_runtime.h>

// The sums' type. chip_smoke.py builds this file alone once more with
// -DSSPV_K5_ACC=float, a control that shows what float32 sums change.
#ifndef SSPV_K5_ACC
#define SSPV_K5_ACC double
#endif

namespace {

typedef SSPV_K5_ACC acc_t;

constexpr int kThreads = 256;
// Blocks an SM holds: 64 registers a thread, and the 48 KB of shared memory
// a block takes at 48 -> 16 kHz fits four times.
constexpr int kBlocksPerSm = 4;
// 16-byte loads of 8 samples a thread has in flight while staging.
constexpr int kLoads = 2;
constexpr int kMaxUp = 1 << 16;

struct Plan {
  int rows, n_in, n_out, n_taps, up, down, n_pre_pad, n_pre_remove;
  int groups;   // a tile's items of each output residue mod up
  int tile;     // outputs a tile: up * groups * kR
  int tiles;    // tiles a row
  int classes;  // residues rho a phase has taps in: min(down, taps a phase)
  int j_pad;    // taps a class, zero-padded to a multiple of kR
  int table;    // up * classes * j_pad
  int res_len;  // staged samples a residue mod down, at most
  int vec_in;   // the rows' samples can be read 16 bytes at a time
  int vec_out;  // the outputs can be written 16 bytes at a time
};

__host__ __device__ inline long long floor_div(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

template <int kR>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    resample_rows_kernel(const short* __restrict__ x,
                         const int* __restrict__ lengths,
                         const float* __restrict__ taps, const Plan p,
                         short* __restrict__ y) {
  extern __shared__ float4 smem4[];
  // tab[(phase * classes + rho) * j_pad + j] = h[phase + up * (rho + down j)]
  acc_t* tab = reinterpret_cast<acc_t*>(smem4);
  // xs[c * res_len + u]: the staged sample lo + c + down * u
  acc_t* xs = tab + p.table;
  short* ys = reinterpret_cast<short*>(
      xs + ((p.table + p.down * p.res_len + 1) & ~1) - p.table);
  for (int i = threadIdx.x; i < p.table; i += kThreads) {
    const int j = i % p.j_pad, cls = i / p.j_pad;
    const int t = cls / p.classes + p.up * (cls % p.classes + p.down * j);
    tab[i] = t < p.n_taps ? (acc_t)taps[t] : (acc_t)0;
  }
  const long long work = (long long)p.rows * p.tiles;
  for (long long w = blockIdx.x; w < work; w += gridDim.x) {
    const int b = (int)(w / p.tiles);
    const int k0 = (int)(w % p.tiles) * p.tile;
    const int len = min(max(lengths[b], 0), p.n_in);
    const long long own = ((long long)len * p.up + p.down - 1) / p.down;
    // J of output k0 (>= 0: J of output 0 is the filter's half length)
    const long long j0 =
        (long long)(k0 + p.n_pre_remove) * p.down - p.n_pre_pad;
    // the first sample a sum reads, less the padded steps' reach, to 8
    const long long lo =
        floor_div(floor_div(j0 - p.n_taps + 1, p.up) -
                      (long long)p.down * p.j_pad, 8) * 8;
    const long long hi = floor_div(j0 + (long long)(p.tile - 1) * p.down, p.up);
    const int staged = (int)(hi - lo + 1);
    const short* row = x + (size_t)b * p.n_in;
    __syncthreads();  // the last tile's reads of xs and ys are done
    for (int i0 = 8 * threadIdx.x; i0 < staged; i0 += 8 * kThreads * kLoads) {
      int4 raw[kLoads];  // kLoads loads in flight before the first store
#pragma unroll
      for (int l = 0; l < kLoads; ++l) {
        const int i = i0 + 8 * kThreads * l;
        const long long s = lo + i;
        short* v = reinterpret_cast<short*>(&raw[l]);
        if (p.vec_in && s >= 0 && s + 8 <= len) {
          raw[l] = *reinterpret_cast<const int4*>(row + s);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = i + e < staged && s + e >= 0 && s + e < len ? row[s + e]
                                                               : (short)0;
        }
      }
#pragma unroll
      for (int l = 0; l < kLoads; ++l) {
        const int i = i0 + 8 * kThreads * l;
        if (i >= staged) break;
        const short* v = reinterpret_cast<const short*>(&raw[l]);
        int u = i / p.down, c = i - u * p.down;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (i + e < staged) xs[c * p.res_len + u] = (acc_t)v[e];
          if (++c == p.down) c = 0, ++u;
        }
      }
    }
    __syncthreads();
    for (int item = threadIdx.x; item < p.up * p.groups; item += kThreads) {
      const int r = item % p.up;
      const int first = r + p.up * kR * (item / p.up);  // from k0
      const long long j = j0 + (long long)first * p.down;
      const int phase = (int)(j % p.up);
      const int s_hi = (int)((j - phase) / p.up - lo);  // from lo
      const int m_taps = (p.n_taps - phase + p.up - 1) / p.up;
      const int n_rho = min(p.down, m_taps);
      acc_t acc[kR];
#pragma unroll
      for (int q = 0; q < kR; ++q) acc[q] = (acc_t)0;
      for (int rho = 0; rho < n_rho; ++rho) {
        const int at = s_hi - rho;  // a_0, at least down * j_pad from lo
        const acc_t* a = xs + (at % p.down) * p.res_len + at / p.down;
        const acc_t* g = tab + (phase * p.classes + rho) * p.j_pad;
        acc_t ring[kR];  // slot v % kR holds a_v (a_v = a[v])
#pragma unroll
        for (int v = 0; v < kR; ++v) ring[v] = a[v];
        for (int base = 0; base < p.j_pad; base += kR, a -= kR, g += kR) {
#pragma unroll
          for (int jj = 0; jj < kR; ++jj) {
            // a_{-j} replaces a_{kR - j}, which no later step reads (at
            // j = 0 it loads a_0 again)
            ring[(kR - jj) % kR] = a[-jj];
            const acc_t tap = g[jj];
#pragma unroll
            for (int q = 0; q < kR; ++q)
              acc[q] += ring[(q - jj + kR) % kR] * tap;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        const int k = first + p.up * q;
        const acc_t v = acc[q] < (acc_t)-32768 ? (acc_t)-32768
                        : acc[q] > (acc_t)32767 ? (acc_t)32767
                                                : acc[q];
        ys[k] = k0 + k < own ? (short)(int)v : (short)0;  // (int) truncates
      }
    }
    __syncthreads();
    const int n = min(p.tile, p.n_out - k0);
    short* out = y + (size_t)b * p.n_out + k0;
    if (p.vec_out) {  // n is a multiple of 8 then
      for (int i = 8 * threadIdx.x; i < n; i += 8 * kThreads)
        *reinterpret_cast<int4*>(out + i) =
            *reinterpret_cast<const int4*>(ys + i);
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) out[i] = ys[i];
    }
  }
}

template <int kR>
int launch(const short* x, const int* lengths, const float* taps, Plan p,
           short* y, cudaStream_t stream) {
  p.groups = p.up < kThreads ? kThreads / p.up : 1;
  p.tile = p.up * p.groups * kR;
  p.tiles = (p.n_out + p.tile - 1) / p.tile;
  p.j_pad = ((p.n_taps + p.up - 1) / p.up + p.down - 1) / p.down;
  p.j_pad = (p.j_pad + kR - 1) / kR * kR;
  p.table = p.up * p.classes * p.j_pad;
  // the most samples a tile stages: its sums' reach, the padded steps'
  // reach and the alignment to 8
  const long long span = ((long long)(p.tile - 1) * p.down + p.n_taps - 1) /
                             p.up + 2 + (long long)p.down * p.j_pad + 8;
  p.res_len = (int)((span + p.down - 1) / p.down);
  p.vec_out = p.vec_out && p.n_out % 8 == 0 && p.tile % 8 == 0;
  const size_t smem =
      sizeof(acc_t) * ((((size_t)p.table + (size_t)p.down * p.res_len) + 1) & ~(size_t)1) +
      sizeof(short) * (size_t)p.tile;
  if ((long long)p.table + (long long)p.down * p.res_len > (1 << 26) ||
      smem > 232448)
    return (int)cudaErrorInvalidValue;
  auto kernel = resample_rows_kernel<kR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long work = (long long)p.rows * p.tiles;
  const long long cap =
      (long long)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  const int blocks = (int)(work < cap ? work : cap);
  kernel<<<blocks, kThreads, smem, stream>>>(x, lengths, taps, p, y);
  return (int)cudaGetLastError();
}

}  // namespace

// Resample `rows` int16 rows of `n_in` samples (row-major), row b valid
// below lengths[b] (int32 on the device, clamped to [0, n_in]), by the
// coprime up / down with the n_taps float32 taps (on the device) and the
// alignment n_pre_pad, n_pre_remove of ops/resample.py `_filter`, into
// `rows` int16 rows of n_out = ceil(n_in * up / down). Returns the CUDA
// error of the launch (0 on success, cudaErrorInvalidValue for what it does
// not take).
extern "C" int sspv_resample_rows(const short* x, const int* lengths,
                                  int rows, int n_in, int n_out,
                                  const float* taps, int n_taps, int up,
                                  int down, int n_pre_pad, int n_pre_remove,
                                  short* y, void* stream) {
  if (rows < 1 || n_in < 1 || n_taps < 1 || up < 1 || up > kMaxUp ||
      down < 1 || down > kMaxUp || n_pre_pad < 0 || n_pre_remove < 0 ||
      (long long)n_out != ((long long)n_in * up + down - 1) / down)
    return (int)cudaErrorInvalidValue;
  Plan p{};
  p.rows = rows;
  p.n_in = n_in;
  p.n_out = n_out;
  p.n_taps = n_taps;
  p.up = up;
  p.down = down;
  p.n_pre_pad = n_pre_pad;
  p.n_pre_remove = n_pre_remove;
  const int per_phase = (n_taps + up - 1) / up;  // phase 0's, the most
  p.classes = down < per_phase ? down : per_phase;
  p.vec_in = reinterpret_cast<size_t>(x) % 16 == 0 && n_in % 8 == 0;
  p.vec_out = reinterpret_cast<size_t>(y) % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  // a sample serves two outputs of one phase only where a class has two
  // taps or more
  return per_phase > down ? launch<7>(x, lengths, taps, p, y, s)
                          : launch<1>(x, lengths, taps, p, y, s);
}
