// A real-input, power-of-two FFT of ONE frame per warp, in shared memory and
// registers, fp32 and IEEE throughout. Shared by view_features.cu (K1),
// view_pitch.cu (K2) and frame_features.cu (K3).
//
// The N-point real FFT runs as the M = N/2-point complex FFT of the even/odd
// packing z[n] = x[2n] + i x[2n+1], then an untangling step to bins 0..M.
// The complex FFT is a self-sorting (Stockham, decimation in frequency)
// schedule of radix-8 and radix-4 stages: each stage reads the whole sequence
// from one of the warp's two buffers, does its butterflies in registers and
// writes the sequence, already in the order the next stage wants, to the
// other buffer, so the bins come out in natural order with no digit-reversal
// pass. 256 = 8 * 8 * 4 at N = 512, 512 = 8 * 8 * 8 at N = 1024.
//
// Twiddles come from a table the wrapper builds on the host in float64 and
// rounds to float32 (sspv_tpu_torch/ops/fft_tables.py, which also documents
// the layout; tests/test_torch_fft_tables.py runs this schedule from that
// table step by step on the CPU). The kernel copies the table to shared
// memory once per block and computes no sine or cosine.
//
// A buffer holds M real parts, then M imaginary parts, element i at phys(i):
// an XOR swizzle inside every run of 32 floats that makes the 32 lanes of a
// stage's strided writes (stride 8 at the first stage, 64 at the second) hit
// 32 different banks, as its unit-stride reads do.
//
// Every frame's arithmetic depends on its samples alone: not on the frame's
// position in the block, the launch or a shard, and never on another frame
// (two real frames are NOT packed into one complex FFT).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "view_common.cuh"

namespace sspv {
namespace fft {

constexpr unsigned kFull = 0xffffffffu;

// -- the plan: must agree with fft_tables.py ---------------------------------

__host__ __device__ constexpr int radix(int n_left) {
  return (n_left == 4 || n_left == 16) ? 4 : 8;
}

// cos then sin of 2 pi k / N for k = 0..N/4.
__host__ __device__ constexpr int untangle_floats(int n) {
  return 2 * (n / 4 + 1);
}

// cos then sin of 2 pi p j / n_left at [(j - 1) * m + p], j = 1..r-1,
// p < m = n_left / r; nothing for the last stage (every twiddle is 1).
__host__ __device__ constexpr int stage_floats(int n_left, int r) {
  return n_left == r ? 0 : 2 * (r - 1) * (n_left / r);
}

__host__ __device__ constexpr int stages_floats(int n_left) {
  return n_left <= 1 ? 0
                     : stage_floats(n_left, radix(n_left)) +
                           stages_floats(n_left / radix(n_left));
}

__host__ __device__ constexpr int table_floats(int n) {
  return untangle_floats(n) + stages_floats(n / 2);
}

// Floats of one warp's two buffers.
__host__ __device__ constexpr int work_floats(int n) { return 2 * n; }

__device__ __forceinline__ int phys(int i) {
  return i ^ (((i >> 5) & 7) | (((i >> 6) & 3) << 3));
}

// -- complex arithmetic in registers -------------------------------------------

struct cplx {
  float re, im;
};

__device__ __forceinline__ cplx operator+(cplx a, cplx b) {
  return {a.re + b.re, a.im + b.im};
}
__device__ __forceinline__ cplx operator-(cplx a, cplx b) {
  return {a.re - b.re, a.im - b.im};
}
__device__ __forceinline__ cplx mul_neg_i(cplx a) { return {a.im, -a.re}; }

// Forward 4-point DFT, natural order, in place.
__device__ __forceinline__ void dft4(cplx& x0, cplx& x1, cplx& x2, cplx& x3) {
  const cplx s0 = x0 + x2, s1 = x0 - x2;
  const cplx s2 = x1 + x3, s3 = mul_neg_i(x1 - x3);
  x0 = s0 + s2;
  x1 = s1 + s3;
  x2 = s0 - s2;
  x3 = s1 - s3;
}

__device__ __forceinline__ void dft(cplx (&a)[4]) {
  dft4(a[0], a[1], a[2], a[3]);
}

// Forward 8-point DFT, natural order, in place: one radix-2 split (the odd
// half times exp(-2 pi i k / 8)), then two 4-point DFTs.
__device__ __forceinline__ void dft(cplx (&a)[8]) {
  const float h = 0.70710678118654752440f;
  cplx u0 = a[0] + a[4], u1 = a[1] + a[5], u2 = a[2] + a[6], u3 = a[3] + a[7];
  cplx v0 = a[0] - a[4];
  const cplx d1 = a[1] - a[5], d3 = a[3] - a[7];
  cplx v1 = {(d1.re + d1.im) * h, (d1.im - d1.re) * h};
  cplx v2 = mul_neg_i(a[2] - a[6]);
  cplx v3 = {(d3.im - d3.re) * h, -(d3.re + d3.im) * h};
  dft4(u0, u1, u2, u3);
  dft4(v0, v1, v2, v3);
  a[0] = u0;
  a[1] = v0;
  a[2] = u1;
  a[3] = v1;
  a[4] = u2;
  a[5] = v2;
  a[6] = u3;
  a[7] = v3;
}

// -- the stages ---------------------------------------------------------------

// One stage over the M-point sequence in `src`: butterfly t reads elements
// t + (M / R) k, k < R, transforms them, multiplies output j by
// exp(-2 pi i p j / NL) from the stage's table section `tw`, and writes
// element q + S (R p + j) of `dst`, with q = t % S and p = t / S.
template <int M, int NL, int S, int R>
__device__ __forceinline__ void fft_stage(const float* src, float* dst,
                                          const float* tw, int lane) {
  constexpr int B = M / R;   // butterflies of the stage
  constexpr int MM = NL / R;  // twiddle positions
  for (int t = lane; t < B; t += 32) {
    const int q = t & (S - 1), p = t / S;
    cplx a[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = phys(t + B * k);
      a[k] = {src[i], src[M + i]};
    }
    dft(a);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      cplx x = a[j];
      if (MM > 1 && j > 0) {
        const float c = tw[(j - 1) * MM + p];
        const float s = tw[(R - 1) * MM + (j - 1) * MM + p];
        x = {a[j].re * c + a[j].im * s, a[j].im * c - a[j].re * s};
      }
      const int o = phys(q + S * (R * p + j));
      dst[o] = x.re;
      dst[M + o] = x.im;
    }
  }
}

// Every stage of the N/2-point complex FFT of the sequence in `cur`, `tw` at
// the first stage's section of the table. On return `cur` holds the bins in
// natural order and `other` is free.
template <int N, int NL = N / 2, int S = 1>
__device__ __forceinline__ void fft_stages(float*& cur, float*& other,
                                           const float* tw, int lane) {
  if constexpr (NL > 1) {
    constexpr int R = radix(NL);
    fft_stage<N / 2, NL, S, R>(cur, other, tw, lane);
    __syncwarp();
    float* const done = other;
    other = cur;
    cur = done;
    fft_stages<N, NL / R, S * R>(cur, other, tw + stage_floats(NL, R), lane);
  }
}

// Bins 0..M of the real sequence from the complex bins `z`, in pairs
// (k, M - k) for k <= M/2: with E = (Z[k] + conj Z[M-k]) / 2,
// O = (Z[k] - conj Z[M-k]) / 2i and W = exp(-2 pi i k / N),
// X[k] = E + W O and X[M-k] = conj(E - W O). `emit(k, re, im)` takes each
// bin once, except bin M/2, which it takes twice with the same value.
template <int N, class Emit>
__device__ __forceinline__ void untangle(const float* z, const float* table,
                                         int lane, Emit emit) {
  constexpr int M = N / 2, Q = M / 2;
  for (int k = lane; k <= Q; k += 32) {
    const int ia = phys(k), ib = phys((M - k) & (M - 1));
    const float ar = z[ia], ai = z[M + ia], br = z[ib], bi = z[M + ib];
    const float c = table[k], s = table[Q + 1 + k];
    const float er = 0.5f * (ar + br), ei = 0.5f * (ai - bi);
    const float pr = 0.5f * (ai + bi), qi = 0.5f * (br - ar);
    const float tr = pr * c + qi * s, ti = qi * c - pr * s;
    emit(M - k, er - tr, -(ei - ti));
    emit(k, er + tr, ei + ti);
  }
}

// The table from device memory to the block's shared memory (all threads).
template <int N>
__device__ __forceinline__ void load_table(const float* __restrict__ table,
                                           float* dst) {
  for (int i = threadIdx.x; i < table_floats(N); i += blockDim.x)
    dst[i] = __ldg(table + i);
}

// Samples x[0..n) (times w[0..n) if WINDOWED), zero-padded to N, packed into
// `buf` as z[t / 2] = v[t] + i v[t + 1]. If WINDOWED, each lane also adds its
// share of the energy sum(v^2) to `e` and of the sign changes between
// neighbouring samples to `changes` (sum both across the warp): the signs of
// the windowed samples, or with RAW_SIGNS those of the samples as read (a
// product x w that underflows to zero loses the sign of x).
// VEC reads 16 bytes a lane (n % 4 == 0, x and w 16-byte aligned); otherwise
// one float a lane, neighbouring lanes on neighbouring addresses. All 32
// lanes must call it.
template <int N, bool WINDOWED, bool VEC, bool RAW_SIGNS = false>
__device__ __forceinline__ void pack_frame(const float* __restrict__ x, int n,
                                           const float* __restrict__ w,
                                           float* buf, int lane, float& e,
                                           int& changes) {
  constexpr int M = N / 2;
  float carry = 0.f;  // the sample before lane 0's
  if constexpr (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* w4 = reinterpret_cast<const float4*>(w);
    for (int t4 = lane; t4 < N / 4; t4 += 32) {
      const bool live = 4 * t4 < n;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 raw = v;
      if (live) {
        v = __ldg(x4 + t4);
        raw = v;
        if constexpr (WINDOWED) {
          const float4 ww = __ldg(w4 + t4);
          v.x *= ww.x;
          v.y *= ww.y;
          v.z *= ww.z;
          v.w *= ww.w;
        }
      }
      if constexpr (WINDOWED) {
        const float4 s = RAW_SIGNS ? raw : v;  // what the signs are taken of
        float prev = __shfl_up_sync(kFull, s.w, 1);
        if (lane == 0) prev = carry;
        carry = __shfl_sync(kFull, s.w, 31);
        if (live) {
          e = fmaf(v.x, v.x, e);
          e = fmaf(v.y, v.y, e);
          e = fmaf(v.z, v.z, e);
          e = fmaf(v.w, v.w, e);
          changes += (t4 > 0 && sign_of(s.x) != sign_of(prev)) +
                     (sign_of(s.y) != sign_of(s.x)) +
                     (sign_of(s.z) != sign_of(s.y)) +
                     (sign_of(s.w) != sign_of(s.z));
        }
      }
      const int i0 = phys(2 * t4), i1 = phys(2 * t4 + 1);
      buf[i0] = v.x;
      buf[M + i0] = v.y;
      buf[i1] = v.z;
      buf[M + i1] = v.w;
    }
  } else {
    for (int t = lane; t < N; t += 32) {
      const bool live = t < n;
      float v = 0.f, raw = 0.f;
      if (live) {
        v = __ldg(x + t);
        raw = v;
        if constexpr (WINDOWED) v *= __ldg(w + t);
      }
      if constexpr (WINDOWED) {
        const float s = RAW_SIGNS ? raw : v;
        float prev = __shfl_up_sync(kFull, s, 1);
        if (lane == 0) prev = carry;
        carry = __shfl_sync(kFull, s, 31);
        if (live) {
          e = fmaf(v, v, e);
          changes += t > 0 && sign_of(s) != sign_of(prev);
        }
      }
      buf[(t & 1) * M + phys(t >> 1)] = v;
    }
  }
}

__host__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Blocks of a launch whose warps loop over the frames with a grid stride:
// one block per `frames_per_block` frames, at most 32 per multiprocessor.
__host__ inline int grid_blocks(int n_frames, int frames_per_block) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int need = (n_frames + frames_per_block - 1) / frames_per_block;
  const int cap = 32 * (sms > 0 ? sms : 1);
  return need < cap ? need : cap;
}

}  // namespace fft
}  // namespace sspv
