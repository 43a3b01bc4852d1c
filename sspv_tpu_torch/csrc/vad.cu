// K4: the streaming composite VAD of B rows of f frames, each row with its
// own carried state.
//
// Replaces: sspv_tpu/ops/vad.py:401 `streaming_vad`, which the JAX package
// runs inside one jit program (XLA fuses its elementwise work; its hangover
// scan is the blocked `_cummax`, :304-333) and vmaps over the rows of the
// batch programs (sspv_tpu/parallel/mesh.py:140-151). There is no
// pl.pallas_call behind it: this kernel takes the place of XLA's fusion.
//
// Per row b and frame t < f, with H = history_len and ext = [the state's
// buffer (H values), the inputs masked by `valid` (f values)]:
//   sum_t    = ext[t] + ... + ext[t + H - 1] in float64: left to right
//              (direct), or, where the caller asks for the blocked form
//              (f % H == 0), the suffix of block q = t / H summed from its
//              end plus the prefix of block q + 1 summed from its start, the
//              order of the plain version's two sequential cumsums;
//   mean_t   = sum_t / min(count + t, H), or ext[t + H] where that is 0;
//   th_e     = max(a * mean_e + (1 - a) * e, min_e) (times the margin where
//              it is not 1), th_z = min(a * mean_z + (1 - a) * z, max_z):
//              each product and the sum rounded on its own (__dmul_rn,
//              __dadd_rn are never contracted into an FMA), 1 - a from the
//              host as Python computes it;
//   adaptive = f32(e) > f32_rn(th_e) && f32(z) < f32_rn(th_z);
//   initial  = e > T_E && (z < T_Z || h < H_max) in float64, or'ed (and'ed
//              in the opt-in mode) with `adaptive`, and'ed with `valid`;
//   vad_t    = t - max(cummax_{s<=t}(initial_s ? s : -2^30), last_voiced)
//              < on + max(off, 1).
// The new state: buffers ext[n_valid .. n_valid + H), count' = min(count +
// n_valid, H), last' = max(max_t seed_t, last_voiced) - n_valid.
//
// What bounds it on the H100: bytes. It reads e, z, h (12 bytes a frame) and
// writes two int32 decisions (8 bytes): 7.2 MB for the hour's 360,192 frames,
// 2.2 us at 3.35 TB/s. Its design adds 2 * H float64 additions a frame (the
// window sums, 184 M at the hour: 5.5 us at the card's 33.5 TFLOP/s of
// float64) and reads each staged value H times from shared memory.
// What the design does about it: three launches on the caller's stream, no
// host round trip, no atomics and no wait between blocks, so no result
// depends on the order in which blocks run.
//   A (gates): one frame a thread, 256 frames a block, grid (f / 256) x B.
//     The block stages its 256 + H - 1 window values of e and z into shared
//     memory (the state's buffer for the first blocks), each thread sums its
//     windows in a fixed order, decides, writes vad_adaptive and its seed
//     (into the vad output, which C overwrites), and the block writes the
//     max of its seeds.
//   B (carries and state): one block per row. An exclusive max-scan of the
//     row's block maxima (1,407 blocks at the hour, 5,625 at 14,400 s), in
//     place, then the row's new state. A separate launch rather than each
//     block of C reducing the maxima before it: O(blocks) work, not
//     O(blocks^2), and the state is written once, in one place.
//   C (hangover): one frame a thread; an inclusive cummax of the block's
//     seeds through warp shuffles and the warps' totals in shared memory,
//     then the max with the block's carry and the state's last_voiced.

#include <climits>

#include "view_common.cuh"

namespace {

constexpr int kThreads = 256;  // frames per block of launches A and C
constexpr int kWarps = kThreads / 32;
constexpr int kNeg = -(1 << 30);  // the seed of a frame that is not voiced

enum : int { kAdaptive = 1, kAndComposite = 2, kBlocked = 4, kMargin = 8 };

struct Gates {
  double energy, zcr, entropy;  // the fixed gates
  double alpha, one_minus_alpha, min_energy, max_zcr, margin;
  int flags, hang;  // hang = on + max(off, 1)
};

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The inclusive running max of `v` over the block's threads in thread order;
// `total` gets the block's max. `warp_tot` is kWarps ints of shared memory.
// Every thread of the block must call it.
__device__ __forceinline__ int block_cummax(int v, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = max(v, up);
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  int before = INT_MIN;
  total = INT_MIN;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before = max(before, warp_tot[w]);
    total = max(total, warp_tot[w]);
  }
  __syncthreads();  // warp_tot may be written again
  return max(v, before);
}

// Window sums of e and z over w[0 .. H): direct, or the blocked suffix +
// prefix of a frame at offset r = t % H in its block.
__device__ __forceinline__ void window_sums(const float* we, const float* wz,
                                           int H, bool blocked, int r,
                                           double& sum_e, double& sum_z) {
  double se = 0.0, sz = 0.0;
  if (!blocked) {
    for (int k = 0; k < H; ++k) {
      se += (double)we[k];
      sz += (double)wz[k];
    }
  } else {
    for (int k = H - r - 1; k >= 0; --k) {  // the suffix, from its end
      se += (double)we[k];
      sz += (double)wz[k];
    }
    double pe = 0.0, pz = 0.0;
    for (int k = H - r; k < H; ++k) {  // the next block's prefix
      pe += (double)we[k];
      pz += (double)wz[k];
    }
    se += pe;
    sz += pz;
  }
  sum_e = se;
  sum_z = sz;
}

__global__ void __launch_bounds__(kThreads) vad_gates_kernel(
    const float* __restrict__ energy, const float* __restrict__ zcr,
    const float* __restrict__ entropy, const unsigned char* __restrict__ valid,
    const float* __restrict__ energy_buf, const float* __restrict__ zcr_buf,
    const int* __restrict__ count, int n_frames, int history_len,
    int n_blocks, Gates g, int* __restrict__ seeds,
    int* __restrict__ vad_adaptive, int* __restrict__ block_max) {
  extern __shared__ float4 smem4[];
  const int H = history_len;
  const int span = kThreads + H - 1;
  float* se = reinterpret_cast<float*>(smem4);
  float* sz = se + span;
  int* warp_tot = reinterpret_cast<int*>(sz + span);
  const int row = blockIdx.x / n_blocks;
  const int t0 = (blockIdx.x % n_blocks) * kThreads;
  const size_t base = (size_t)row * n_frames;
  const int ext_len = H + n_frames;

  for (int j = threadIdx.x; j < span; j += kThreads) {
    const int x = t0 + j;  // index into ext
    float e = 0.f, z = 0.f;
    if (x < H) {
      e = energy_buf[(size_t)row * H + x];
      z = zcr_buf[(size_t)row * H + x];
    } else if (x < ext_len) {
      const size_t i = base + (x - H);
      if (valid == nullptr || valid[i]) {
        e = energy[i];
        z = zcr[i];
      }
    }
    se[j] = e;
    sz[j] = z;
  }
  __syncthreads();

  const int t = t0 + threadIdx.x;
  int seed = kNeg;
  if (t < n_frames) {
    const size_t i = base + t;
    double sum_e, sum_z;
    window_sums(se + threadIdx.x, sz + threadIdx.x, H,
                (g.flags & kBlocked) != 0, t % H, sum_e, sum_z);
    const int cnt = min(count[row] + t, H);
    // where the history is empty, the mean is the masked current value
    const double mean_e =
        cnt > 0 ? sum_e / (double)cnt : (double)se[threadIdx.x + H];
    const double mean_z =
        cnt > 0 ? sum_z / (double)cnt : (double)sz[threadIdx.x + H];
    const float ef = energy[i], zf = zcr[i];
    const double e64 = ef, z64 = zf, h64 = entropy[i];
    double th_e = __dadd_rn(__dmul_rn(g.alpha, mean_e),
                            __dmul_rn(g.one_minus_alpha, e64));
    double th_z = __dadd_rn(__dmul_rn(g.alpha, mean_z),
                            __dmul_rn(g.one_minus_alpha, z64));
    if (th_e < g.min_energy) th_e = g.min_energy;
    if (th_z > g.max_zcr) th_z = g.max_zcr;
    if (g.flags & kMargin) th_e = __dmul_rn(th_e, g.margin);
    const bool adaptive =
        ef > __double2float_rn(th_e) && zf < __double2float_rn(th_z);
    bool initial = e64 > g.energy && (z64 < g.zcr || h64 < g.entropy);
    if (g.flags & kAdaptive)
      initial = (g.flags & kAndComposite) ? initial && adaptive
                                          : initial || adaptive;
    if (valid != nullptr && !valid[i]) initial = false;
    vad_adaptive[i] = adaptive ? 1 : 0;
    seed = initial ? t : kNeg;
    seeds[i] = seed;
  }
  const int m = warp_max(seed);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    int bm = warp_tot[0];
    for (int w = 1; w < kWarps; ++w) bm = max(bm, warp_tot[w]);
    block_max[blockIdx.x] = bm;
  }
}

__global__ void __launch_bounds__(kThreads) vad_carry_kernel(
    int* __restrict__ block_max, int n_blocks, const float* __restrict__ energy,
    const float* __restrict__ zcr, const unsigned char* __restrict__ valid,
    const int* __restrict__ n_valid, const float* __restrict__ energy_buf,
    const float* __restrict__ zcr_buf, const int* __restrict__ count,
    const int* __restrict__ last_voiced, int n_frames, int history_len,
    float* __restrict__ new_energy_buf, float* __restrict__ new_zcr_buf,
    int* __restrict__ new_count, int* __restrict__ new_last_voiced) {
  extern __shared__ float4 smem4[];
  int* warp_tot = reinterpret_cast<int*>(smem4);
  int* incl_of = warp_tot + kWarps;
  const int H = history_len;
  const int row = blockIdx.x;
  int* m = block_max + (size_t)row * n_blocks;

  // the block maxima become the exclusive running max before each block
  int carry = INT_MIN;
  for (int c0 = 0; c0 < n_blocks; c0 += kThreads) {
    const int j = c0 + threadIdx.x;
    const int v = j < n_blocks ? m[j] : INT_MIN;
    int total;
    const int incl = block_cummax(v, warp_tot, total);
    incl_of[threadIdx.x] = incl;
    __syncthreads();
    const int excl = threadIdx.x ? incl_of[threadIdx.x - 1] : INT_MIN;
    if (j < n_blocks) m[j] = max(carry, excl);
    carry = max(carry, total);
    __syncthreads();  // incl_of is written again
  }

  const int nv = n_valid != nullptr ? n_valid[row] : n_frames;
  if (threadIdx.x == 0) {
    new_count[row] = min(count[row] + nv, H);
    const int last = max(carry, last_voiced[row]);
    // two's-complement wrap, as the plain version's int32 subtraction
    new_last_voiced[row] = (int)((unsigned)last - (unsigned)nv);
  }
  for (int k = threadIdx.x; k < H; k += kThreads) {
    const int x = nv + k;  // index into ext, < H + f
    float e = 0.f, z = 0.f;
    if (x < H) {
      e = energy_buf[(size_t)row * H + x];
      z = zcr_buf[(size_t)row * H + x];
    } else {
      const size_t i = (size_t)row * n_frames + (x - H);
      if (valid == nullptr || valid[i]) {
        e = energy[i];
        z = zcr[i];
      }
    }
    new_energy_buf[(size_t)row * H + k] = e;
    new_zcr_buf[(size_t)row * H + k] = z;
  }
}

__global__ void __launch_bounds__(kThreads) vad_hangover_kernel(
    int* __restrict__ vad, const int* __restrict__ carries,
    const int* __restrict__ last_voiced, int n_frames, int n_blocks,
    int hang) {
  extern __shared__ float4 smem4[];
  int* warp_tot = reinterpret_cast<int*>(smem4);
  const int row = blockIdx.x / n_blocks;
  const int t = (blockIdx.x % n_blocks) * kThreads + threadIdx.x;
  const size_t i = (size_t)row * n_frames + t;
  const int seed = t < n_frames ? vad[i] : kNeg;
  int total;
  int last = block_cummax(seed, warp_tot, total);
  last = max(last, max(carries[blockIdx.x], last_voiced[row]));
  if (t < n_frames) vad[i] = (t - last) < hang ? 1 : 0;
}

}  // namespace

// The VAD of `rows` rows of `n_frames` frames (each array row-major, one row
// after another). `valid` is a (rows, n_frames) uint8 mask or null (every
// frame valid); `n_valid` its per-row count as int32 on the device, or null
// with a null mask. The state is per row: buffers (rows, history_len) float32,
// count and last_voiced (rows,) int32; the new state goes to separate arrays.
// `block_max` is (rows, ceil(n_frames / 256)) int32 scratch. `flags`: 1 the
// adaptive composite, 2 its "and" mode, 4 the blocked window sums (n_frames
// a multiple of history_len), 8 a margin other than 1. Returns the CUDA error
// of the launches (0 on success, cudaErrorInvalidValue for shapes it does
// not take).
extern "C" int sspv_streaming_vad(
    const float* energy, const float* zcr, const float* entropy,
    const unsigned char* valid, const int* n_valid, const float* energy_buf,
    const float* zcr_buf, const int* count, const int* last_voiced, int rows,
    int n_frames, int history_len, double energy_threshold,
    double zcr_threshold, double entropy_voice_max, double alpha,
    double one_minus_alpha, double min_energy, double max_zcr, double margin,
    int flags, int hang, int* block_max, int* vad, int* vad_adaptive,
    float* new_energy_buf, float* new_zcr_buf, int* new_count,
    int* new_last_voiced, void* stream) {
  if (rows < 1 || n_frames < 1 || history_len < 1 ||
      n_frames > (1 << 30) - kThreads ||
      ((flags & kBlocked) && n_frames % history_len) ||
      (valid == nullptr) != (n_valid == nullptr))
    return (int)cudaErrorInvalidValue;
  const int n_blocks = (n_frames + kThreads - 1) / kThreads;
  if ((long long)rows * n_blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const Gates g{energy_threshold, zcr_threshold, entropy_voice_max, alpha,
                one_minus_alpha,  min_energy,    max_zcr,           margin,
                flags,            hang};
  cudaStream_t s = (cudaStream_t)stream;

  const size_t gate_smem = sizeof(float) * 2 * (kThreads + history_len - 1) +
                           sizeof(int) * kWarps;
  cudaError_t err = cudaFuncSetAttribute(
      vad_gates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)gate_smem);
  if (err != cudaSuccess) return (int)err;
  vad_gates_kernel<<<rows * n_blocks, kThreads, gate_smem, s>>>(
      energy, zcr, entropy, valid, energy_buf, zcr_buf, count, n_frames,
      history_len, n_blocks, g, vad, vad_adaptive, block_max);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  vad_carry_kernel<<<rows, kThreads, sizeof(int) * (kWarps + kThreads), s>>>(
      block_max, n_blocks, energy, zcr, valid, n_valid, energy_buf, zcr_buf,
      count, last_voiced, n_frames, history_len, new_energy_buf, new_zcr_buf,
      new_count, new_last_voiced);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  vad_hangover_kernel<<<rows * n_blocks, kThreads, sizeof(int) * kWarps, s>>>(
      vad, block_max, last_voiced, n_frames, n_blocks, hang);
  return (int)cudaGetLastError();
}
