// K4: the streaming composite VAD of B rows of f frames, each row with its
// own carried state and its own length.
//
// Replaces: sspv_tpu/ops/vad.py:401 `streaming_vad`, which the JAX package
// runs inside one jit program (XLA fuses its elementwise work; its hangover
// scan is the blocked `_cummax`, :304-333) and vmaps over the rows of the
// batch programs (sspv_tpu/parallel/mesh.py:140-151). There is no
// pl.pallas_call behind it: this kernel takes the place of XLA's fusion.
//
// Per row b and frame t < f, with H = history_len, the row's frames valid
// where the caller's mask says so or, without a mask, below the row's length
// n_b, and ext = [the state's buffer (H values), the inputs, 0 where not
// valid and past f]:
//   sum_t    = ext[t] + ... + ext[t + H - 1] in float64: left to right
//              (direct), or, where the caller asks for the blocked form, the
//              suffix of ext block q = t / H summed from its end plus the
//              prefix of block q + 1 summed from its start, the order of the
//              plain version's two sequential cumsums (for any f: blocks past
//              the row are zeros, and no window of a frame reaches them);
//   mean_t   = sum_t / min(count + t, H), or ext[t + H] where that is 0;
//   th_e     = max(a * mean_e + (1 - a) * e, min_e) (times the margin where
//              it is not 1), th_z = min(a * mean_z + (1 - a) * z, max_z):
//              each product and the sum rounded on its own (__dmul_rn,
//              __dadd_rn are never contracted into an FMA), 1 - a from the
//              host as Python computes it;
//   adaptive = f32(e) > f32_rn(th_e) && f32(z) < f32_rn(th_z);
//   initial  = e > T_E && (z < T_Z || h < H_max) in float64, or'ed (and'ed
//              in the opt-in mode) with `adaptive`, and'ed with validity;
//   vad_t    = t - max(cummax_{s<=t}(initial_s ? s : -2^30), last_voiced)
//              < on + max(off, 1).
// The new state, with n the row's valid frames: buffers ext[n .. n + H),
// count' = min(count + n, H), last' = max(max_t seed_t, last_voiced) - n.
//
// What bounds it on the H100: bytes. It reads e, z, h (12 bytes a frame) and
// writes two int32 decisions (8 bytes): 7.2 MB for the hour's 359,999
// frames, 2.1 us at 3.35 TB/s. The window sums are the only arithmetic that
// grows with H.
// What the design does about it:
//   A (gates): 256 frames a block of 128 threads, grid (f / 256) x B, two
//     frames a thread for the gates. The block stages its 256 + H - 1
//     window values of e and z into shared memory once (the state's buffer
//     for the first blocks; index x at x + x / 32, so the direct route's
//     strided reads spread over the banks). Blocked route: for each ext
//     block q that holds frames of the tile, one thread runs block q's
//     float64 suffix scan from its end and one block q + 1's prefix scan
//     from its start, once per feature; frame t = qH + r then takes
//     suffix[r] + prefix[r]. Why the bits are the plain version's: its
//     window sum of frame t is exactly these two partial sums (its reverse
//     cumsum of block q at r: ext[qH + H - 1] + ... down to ext[qH + r],
//     added in that order; its forward cumsum of block q + 1 before r),
//     added as suffix + prefix; a scan computes each partial sum by the
//     same chain of adds in the same order, once for all r of the block,
//     where summing each window on its own redid the chain per frame. So
//     each window sum, and every decision and state, is the same double
//     bit for bit: two reads of shared memory a frame and feature, not H.
//     A chain's latency, H dependent adds, is what a block waits for: its
//     loads run 16 values ahead of its adds, and 11 blocks share an SM.
//     Direct route: a thread owns 4 adjacent frames and adds each staged
//     value it loads into every one of its 4 window sums that holds it;
//     each sum still adds its H values left to right, with 4 times fewer
//     shared loads. Each thread then decides, writes vad_adaptive and its
//     seed (into the vad output, which C overwrites), and the block writes
//     the max of its seeds.
//   B (carries and state): one block per row. An exclusive max-scan of the
//     row's block maxima (1,407 blocks at the hour), in place: each thread
//     a run of them, one block-wide scan of the runs; then the row's new
//     state. A separate launch rather than each block of C reducing the
//     maxima before it: O(blocks) work, not O(blocks^2), and the state is
//     written once, in one place.
//   C (hangover): one frame a thread; an inclusive cummax of the block's
//     seeds through warp shuffles and the warps' totals in shared memory,
//     then the max with the block's carry and the state's last_voiced.
// Three launches on the caller's stream, no host round trip, no atomics and
// no wait between blocks, so no result depends on the order in which blocks
// run. The row lengths arrive as numbers (one for every row, or an int32 per
// row on the device): no mask, pad or count is formed around the launch.

#include <climits>

#include "view_common.cuh"

namespace {

constexpr int kThreads = 256;  // threads per block of launches B and C
constexpr int kTile = kThreads;  // frames per block of launches A and C
constexpr int kWarps = kThreads / 32;
// Threads per block of launch A, two frames each, and the blocks an SM must
// hold at once (which caps a thread at 40 registers): 11 x 132 SMs hold the
// hour's 1,407 blocks in one wave. A block waits mostly on its scans' chains
// of dependent adds, so what counts is how many wait side by side.
constexpr int kGateThreads = kTile / 2;
constexpr int kGateBlocksPerSm = 11;
constexpr int kOwn = 4;  // adjacent frames per thread of the direct route
constexpr int kAhead = 16;  // staged values a thread loads before adding them
constexpr int kNeg = -(1 << 30);  // the seed of a frame that is not voiced

enum : int { kAdaptive = 1, kAndComposite = 2, kBlocked = 4, kMargin = 8 };

struct Gates {
  double energy, zcr, entropy;  // the fixed gates
  double alpha, one_minus_alpha, min_energy, max_zcr, margin;
  int flags, hang;  // hang = on + max(off, 1)
};

// The staged value x of a block lives at x + x / 32: the direct route's
// threads read 4 values apart, which would put 4 of them in one bank.
__device__ __forceinline__ int sk(int x) { return x + (x >> 5); }

// The row's valid frame count: its entry of `n_valid`, or `n_len` for every
// row, within [0, n_frames].
__device__ __forceinline__ int row_valid(const int* n_valid, int n_len,
                                         int row, int n_frames) {
  const int n = n_valid != nullptr ? n_valid[row] : n_len;
  return min(max(n, 0), n_frames);
}

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

// One serial chain of float64 adds: the `n` staged values at rd, rd + step,
// ... added to `acc` in that order; with `store`, acc after each add goes to
// dst[wr], dst[wr + step], .... The loads run kAhead values ahead of the
// adds, whose latency is the chain's.
__device__ __forceinline__ double chain(const float* src, int rd, int step,
                                        int n, double acc, double* dst,
                                        int wr, bool store) {
  int m = 0;
  for (; m + kAhead <= n; m += kAhead) {
    float v[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) v[k] = src[sk(rd + k * step)];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      acc += (double)v[k];
      if (store) dst[wr + k * step] = acc;
    }
    rd += kAhead * step;
    wr += kAhead * step;
  }
  for (; m < n; ++m, rd += step, wr += step) {
    acc += (double)src[sk(rd)];
    if (store) dst[wr] = acc;
  }
  return acc;
}

// Value m of a direct-route thread's staged run into each of its kOwn window
// sums that holds it (window j holds values j .. j + H - 1).
__device__ __forceinline__ void add_some(double (&ae)[kOwn],
                                         double (&az)[kOwn], float ve,
                                         float vz, int m, int H) {
#pragma unroll
  for (int j = 0; j < kOwn; ++j) {
    if (m >= j && m - j < H) {
      ae[j] += (double)ve;
      az[j] += (double)vz;
    }
  }
}

// Floats of shared memory that launch A stages per feature (its 256 + H - 1
// window values at their skewed indices) for a history of H.
__host__ __device__ constexpr int gate_span(int H) {
  return ((kTile + H - 2) + ((kTile + H - 2) >> 5)) + 1;  // sk(last) + 1
}

__global__ void __launch_bounds__(kGateThreads, kGateBlocksPerSm)
vad_gates_kernel(
    const float* __restrict__ energy, const float* __restrict__ zcr,
    const float* __restrict__ entropy, const unsigned char* __restrict__ valid,
    const int* __restrict__ n_valid, int n_len,
    const float* __restrict__ energy_buf, const float* __restrict__ zcr_buf,
    const int* __restrict__ count, int n_frames, int history_len,
    int n_blocks, Gates g, int* __restrict__ seeds,
    int* __restrict__ vad_adaptive, int* __restrict__ block_max) {
  extern __shared__ float4 smem4[];
  const int H = history_len;
  const int span = kTile + H - 1;
  // suffix (or direct) sums and prefix sums of the tile's frames
  double* sum_e = reinterpret_cast<double*>(smem4);
  double* sum_z = sum_e + kTile;
  double* pre_e = sum_z + kTile;
  double* pre_z = pre_e + kTile;
  float* se = reinterpret_cast<float*>(pre_z + kTile);
  float* sz = se + gate_span(H);
  int* warp_tot = reinterpret_cast<int*>(sz + gate_span(H));
  const int row = blockIdx.x / n_blocks;
  const int t0 = (blockIdx.x % n_blocks) * kTile;
  const int n_tile = min(kTile, n_frames - t0);
  const size_t base = (size_t)row * n_frames;
  const int nv = row_valid(n_valid, n_len, row, n_frames);
  const bool blocked = (g.flags & kBlocked) != 0;

  // the loads of four values a thread go out before their stores
  for (int j0 = threadIdx.x; j0 < span; j0 += 4 * kGateThreads) {
    float ev[4], zv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * kGateThreads;
      const int x = t0 + j;  // index into ext
      ev[u] = zv[u] = 0.f;
      if (j < span && x < H) {
        ev[u] = energy_buf[(size_t)row * H + x];
        zv[u] = zcr_buf[(size_t)row * H + x];
      } else if (j < span && x - H < n_frames) {
        const int k = x - H;
        const size_t i = base + k;
        if (valid != nullptr ? valid[i] != 0 : k < nv) {
          ev[u] = energy[i];
          zv[u] = zcr[i];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * kGateThreads;
      if (j < span) {
        se[sk(j)] = ev[u];
        sz[sk(j)] = zv[u];
      }
    }
  }
  __syncthreads();

  if (blocked) {
    // Four chains per ext block q with frames in the tile (q0 .. q0 + nq - 1):
    // c & 1 the feature, c & 2 the suffix of block q (0) or the prefix of
    // block q + 1 (2). The same calls for all, so the lanes of a warp agree.
    const int q0 = t0 / H;
    const int nq = (t0 + n_tile - 1) / H - q0 + 1;
    for (int c = threadIdx.x; c < 4 * nq; c += kGateThreads) {
      const int qs = (q0 + (c >> 2)) * H - t0;  // block q's start, > -H
      const float* src = (c & 1) ? sz : se;
      double* dst;
      int rd, wr, step, len, skip;  // the first `skip` sums are not stored
      if ((c & 2) == 0) {  // S[r] = ext[qs + r] + ... from qs + H - 1 down
        dst = (c & 1) ? sum_z : sum_e;
        rd = wr = qs + H - 1;
        step = -1;
        len = qs + H - max(qs, 0);
        skip = max(0, rd - (n_tile - 1));  // frames past the tile
      } else {  // P[r] = ext[qs + H] + ... + ext[qs + H + r - 1], P[0] = 0
        dst = (c & 1) ? pre_z : pre_e;
        if (qs >= 0) dst[qs] = 0.0;
        rd = qs + H;
        wr = qs + 1;
        step = 1;
        len = min(H - 1, n_tile - 1 - qs);
        skip = min(len, max(0, -wr));  // frames before the tile
      }
      const double acc = chain(src, rd, step, skip, 0.0, dst, wr, false);
      chain(src, rd + skip * step, step, len - skip, acc, dst,
            wr + skip * step, true);
    }
  } else if (threadIdx.x < kTile / kOwn) {
    // frames i0 .. i0 + kOwn - 1; frame i0 + j sums values j .. j + H - 1,
    // so value m goes to every window when kOwn - 1 <= m < H (the body),
    // and to some of them before and after it
    const int i0 = threadIdx.x * kOwn;
    const int all = H + kOwn - 1, lo = kOwn - 1, hi = max(lo, H);
    double ae[kOwn], az[kOwn];
#pragma unroll
    for (int j = 0; j < kOwn; ++j) ae[j] = az[j] = 0.0;
    for (int m = 0; m < lo; ++m)
      add_some(ae, az, se[sk(i0 + m)], sz[sk(i0 + m)], m, H);
    int m = lo;
    for (; m + kAhead <= hi; m += kAhead) {
      float ve[kAhead], vz[kAhead];  // loaded ahead of the adds
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        ve[k] = se[sk(i0 + m + k)];
        vz[k] = sz[sk(i0 + m + k)];
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
#pragma unroll
        for (int j = 0; j < kOwn; ++j) {
          ae[j] += (double)ve[k];
          az[j] += (double)vz[k];
        }
      }
    }
    for (; m < hi; ++m) {
      const double ve = se[sk(i0 + m)], vz = sz[sk(i0 + m)];
#pragma unroll
      for (int j = 0; j < kOwn; ++j) {
        ae[j] += ve;
        az[j] += vz;
      }
    }
    for (m = hi; m < all; ++m)
      add_some(ae, az, se[sk(i0 + m)], sz[sk(i0 + m)], m, H);
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      sum_e[i0 + j] = ae[j];
      sum_z[i0 + j] = az[j];
    }
  }
  __syncthreads();

  int seed = kNeg;  // the max of the thread's frames' seeds
  for (int r = threadIdx.x; r < n_tile; r += kGateThreads) {
    const int t = t0 + r;
    const size_t i = base + t;
    // suffix + prefix, one rounding, as the plain version adds them
    const double s_e = blocked ? sum_e[r] + pre_e[r] : sum_e[r];
    const double s_z = blocked ? sum_z[r] + pre_z[r] : sum_z[r];
    const int cnt = min(count[row] + t, H);
    // where the history is empty, the mean is the masked current value
    const double mean_e = cnt > 0 ? s_e / (double)cnt : (double)se[sk(r + H)];
    const double mean_z = cnt > 0 ? s_z / (double)cnt : (double)sz[sk(r + H)];
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
    if (valid != nullptr ? valid[i] == 0 : t >= nv) initial = false;
    vad_adaptive[i] = adaptive ? 1 : 0;
    seeds[i] = initial ? t : kNeg;
    if (initial) seed = t;  // t grows along the loop
  }
  const int m = warp_max(seed);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    int bm = warp_tot[0];
    for (int w = 1; w < kGateThreads / 32; ++w) bm = max(bm, warp_tot[w]);
    block_max[blockIdx.x] = bm;
  }
}

__global__ void __launch_bounds__(kThreads) vad_carry_kernel(
    int* __restrict__ block_max, int n_blocks, const float* __restrict__ energy,
    const float* __restrict__ zcr, const unsigned char* __restrict__ valid,
    const int* __restrict__ n_valid, int n_len,
    const float* __restrict__ energy_buf, const float* __restrict__ zcr_buf,
    const int* __restrict__ count, const int* __restrict__ last_voiced,
    int n_frames, int history_len, float* __restrict__ new_energy_buf,
    float* __restrict__ new_zcr_buf, int* __restrict__ new_count,
    int* __restrict__ new_last_voiced) {
  extern __shared__ float4 smem4[];
  int* warp_tot = reinterpret_cast<int*>(smem4);
  int* incl_of = warp_tot + kWarps;
  const int H = history_len;
  const int row = blockIdx.x;
  int* m = block_max + (size_t)row * n_blocks;

  // the block maxima become the exclusive running max before each block:
  // each thread takes a run of `per` of them (its running max within the
  // run), then one block-wide scan of the runs' maxima
  const int per = (n_blocks + kThreads - 1) / kThreads;
  const int j0 = min((int)threadIdx.x * per, n_blocks);
  const int j1 = min(j0 + per, n_blocks);
  int run = INT_MIN;
  for (int j = j0; j < j1; ++j) run = max(run, m[j]);
  int carry;  // the row's max
  incl_of[threadIdx.x] = block_cummax(run, warp_tot, carry);
  __syncthreads();
  int before = threadIdx.x ? incl_of[threadIdx.x - 1] : INT_MIN;
  for (int j = j0; j < j1; ++j) {
    const int v = m[j];
    m[j] = before;
    before = max(before, v);
  }

  const int nv = row_valid(n_valid, n_len, row, n_frames);
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
      // below the row's length: valid, unless a mask says otherwise
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
  const int t = (blockIdx.x % n_blocks) * kTile + threadIdx.x;
  const size_t i = (size_t)row * n_frames + t;
  const int seed = t < n_frames ? vad[i] : kNeg;
  int total;
  int last = block_cummax(seed, warp_tot, total);
  last = max(last, max(carries[blockIdx.x], last_voiced[row]));
  if (t < n_frames) vad[i] = (t - last) < hang ? 1 : 0;
}

}  // namespace

// The VAD of `rows` rows of `n_frames` frames (each array row-major, one row
// after another). Which frames are valid: `valid`, a (rows, n_frames) uint8
// mask, with `n_valid` its per-row count as int32 on the device; or, with a
// null mask, the first `n_valid[row]` frames of each row (int32 on the
// device), or with that null too, the first `n_len` frames of every row.
// The state is per row: buffers (rows, history_len) float32, count and
// last_voiced (rows,) int32; the new state goes to separate arrays.
// `block_max` is (rows, ceil(n_frames / 256)) int32 scratch. `flags`: 1 the
// adaptive composite, 2 its "and" mode, 4 the blocked window sums (any
// n_frames), 8 a margin other than 1. Returns the CUDA error of the launches
// (0 on success, cudaErrorInvalidValue for shapes it does not take).
extern "C" int sspv_streaming_vad(
    const float* energy, const float* zcr, const float* entropy,
    const unsigned char* valid, const int* n_valid, int n_len,
    const float* energy_buf, const float* zcr_buf, const int* count,
    const int* last_voiced, int rows, int n_frames, int history_len,
    double energy_threshold, double zcr_threshold, double entropy_voice_max,
    double alpha, double one_minus_alpha, double min_energy, double max_zcr,
    double margin, int flags, int hang, int* block_max, int* vad,
    int* vad_adaptive, float* new_energy_buf, float* new_zcr_buf,
    int* new_count, int* new_last_voiced, void* stream) {
  const size_t gate_smem = sizeof(double) * 4 * kTile +
                           sizeof(float) * 2 * (size_t)gate_span(history_len) +
                           sizeof(int) * kWarps;
  if (rows < 1 || n_frames < 1 || history_len < 1 ||
      n_frames > (1 << 30) - kTile || (valid != nullptr && n_valid == nullptr)
      || gate_smem > 232448)
    return (int)cudaErrorInvalidValue;
  const int n_blocks = (n_frames + kTile - 1) / kTile;
  if ((long long)rows * n_blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const Gates g{energy_threshold, zcr_threshold, entropy_voice_max, alpha,
                one_minus_alpha,  min_energy,    max_zcr,           margin,
                flags,            hang};
  cudaStream_t s = (cudaStream_t)stream;

  cudaError_t err = cudaFuncSetAttribute(
      vad_gates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)gate_smem);
  if (err != cudaSuccess) return (int)err;
  vad_gates_kernel<<<rows * n_blocks, kGateThreads, gate_smem, s>>>(
      energy, zcr, entropy, valid, n_valid, n_len, energy_buf, zcr_buf, count,
      n_frames, history_len, n_blocks, g, vad, vad_adaptive, block_max);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  vad_carry_kernel<<<rows, kThreads, sizeof(int) * (kWarps + kThreads), s>>>(
      block_max, n_blocks, energy, zcr, valid, n_valid, n_len, energy_buf,
      zcr_buf, count, last_voiced, n_frames, history_len, new_energy_buf,
      new_zcr_buf, new_count, new_last_voiced);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  vad_hangover_kernel<<<rows * n_blocks, kThreads, sizeof(int) * kWarps, s>>>(
      vad, block_max, last_voiced, n_frames, n_blocks, hang);
  return (int)cudaGetLastError();
}
