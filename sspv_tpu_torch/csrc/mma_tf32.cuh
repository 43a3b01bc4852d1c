// One warp-level tensor-core product, mma.sync.aligned.m16n8k8.row.col
// .f32.tf32.tf32.f32: D (16 x 8, fp32) += A (16 x 8, tf32) * B (8 x 8, tf32),
// and the fp32 -> tf32 rounding of its operands (cvt.rna.tf32.f32's: round to
// nearest, ties away from zero, 10 mantissa bits kept).
//
// Fragments, with g = lane >> 2 and t = lane & 3 (PTX ISA, "Matrix Fragments
// for mma.m16n8k8", .tf32):
//   a[0] = A[g][t]      a[1] = A[g + 8][t]
//   a[2] = A[g][t + 4]  a[3] = A[g + 8][t + 4]
//   b[0] = B[t][g]      b[1] = B[t + 4][g]
//   d[0] = D[g][2t]     d[1] = D[g][2t + 1]
//   d[2] = D[g + 8][2t] d[3] = D[g + 8][2t + 1]
//
// On the card the product is the PTX. Compiled by a host compiler against the CPU
// stand-in of the CUDA runtime (tests/cuda_cpu_stub), where every lane is a
// host thread, it is a scalar emulation: each lane publishes its fragment
// registers to its warp, and every lane reads each element of its rows of A
// and columns of B from the lane and register that hold it in the layout
// above, so a kernel that puts an operand in the wrong register or lane
// computes a wrong product there too. (One warp barrier a call: the stand-in's
// __shfl_sync costs two, and 32 of them per product made the rehearsal of a
// kernel take minutes.)
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#if !defined(__CUDACC__)
#include <cstring>
#endif

namespace sspv {

__device__ __forceinline__ float bits_float(uint32_t u) {
#if defined(__CUDACC__)
  return __uint_as_float(u);
#else
  float f;
  std::memcpy(&f, &u, 4);
  return f;
#endif
}

__device__ __forceinline__ uint32_t float_bits(float f) {
#if defined(__CUDACC__)
  return __float_as_uint(f);
#else
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
#endif
}

// A finite x rounded to tf32 as cvt.rna.tf32.f32 rounds it (to nearest,
// ties away from zero, 10 mantissa bits kept), as a float with its 13 low
// bits zero: the bit pattern plus half a tf32 unit, truncated (a carry
// rounds into the exponent; the sign bit is never reached). Two integer
// operations where the conversion instruction compiles to a longer
// sequence; the kernels split samples and bases, which are finite.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (float_bits(x) + 0x1000u) & 0xffffe000u;
}

// The 3xTF32 split of a finite x: hi = tf32(x), lo = tf32(x - hi); hi + lo
// carries x to about 2^-22 of its magnitude (x - hi is exact in fp32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - bits_float(hi));
}

#if !defined(__CUDACC__)
namespace emu {

// Each thread's published fragment registers: up to two A fragments (4
// registers each), then up to two B fragments (2 each). Two sets, used in
// turn: a lane writes a set only after the barrier of the next call, which
// every lane reaches once its reads of that set are done.
constexpr int kSlots = 12;
inline uint32_t (*published(int turn))[kSlots] {
  static uint32_t sets[2][1024][kSlots];
  return sets[turn];
}
inline thread_local int turn = 0;

// d += A * B from the warp's published registers, A's fragment at slot
// `a_at`, B's at `b_at`: A[row][k] is register (row >> 3) + 2 (k >> 2) of
// lane (row & 7) * 4 + (k & 3), B[k][col] register k >> 2 of lane
// col * 4 + (k & 3). A product of two tf32 values is exact in fp32; the sum
// is taken in double and rounded once.
inline void product(float (&d)[4], const uint32_t (*warp)[kSlots], int a_at,
                    int b_at) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int i = 0; i < 2; ++i)
    for (int c = 0; c < 2; ++c) {
      const int row = g + 8 * i;
      const int col = 2 * t + c;
      double acc = d[2 * i + c];
      for (int k = 0; k < 8; ++k) {
        const float a = bits_float(
            warp[(row & 7) * 4 + (k & 3)][a_at + (row >> 3) + 2 * (k >> 2)]);
        const float b = bits_float(warp[col * 4 + (k & 3)][b_at + (k >> 2)]);
        acc += (double)(a * b);
      }
      d[2 * i + c] = (float)acc;
    }
}

// Publishes the calling lane's `n_a` A fragments (4 registers each) and
// `n_b` B fragments (2 each) and returns its warp's published set once every
// lane of the warp has published.
inline const uint32_t (*publish(const uint32_t* const* a, int n_a,
                                const uint32_t* const* b, int n_b))[kSlots] {
  uint32_t (*set)[kSlots] = published(turn);
  turn ^= 1;
  uint32_t* mine = set[threadIdx.x];
  for (int i = 0; i < n_a; ++i)
    for (int r = 0; r < 4; ++r) mine[4 * i + r] = a[i][r];
  for (int i = 0; i < n_b; ++i)
    for (int r = 0; r < 2; ++r) mine[4 * n_a + 2 * i + r] = b[i][r];
  __syncwarp();
  return set + (threadIdx.x & ~31u);
}

}  // namespace emu
#endif

__device__ __forceinline__ void mma_tf32_m16n8k8(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 const uint32_t (&b)[2]) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#elif !defined(__CUDACC__)
  const uint32_t* as[] = {a};
  const uint32_t* bs[] = {b};
  emu::product(d, emu::publish(as, 1, bs, 1), 0, 4);
#endif
}

// The 3xTF32 product of the split operands: d += a_lo b_hi + a_hi b_lo +
// a_hi b_hi, the small terms first (a_lo b_lo, below 2^-22 of the product,
// is left out).
__device__ __forceinline__ void mma_3xtf32_m16n8k8(
    float (&d)[4], const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
    const uint32_t (&b_hi)[2], const uint32_t (&b_lo)[2]) {
#if defined(__CUDACC__)
  mma_tf32_m16n8k8(d, a_lo, b_hi);
  mma_tf32_m16n8k8(d, a_hi, b_lo);
  mma_tf32_m16n8k8(d, a_hi, b_hi);
#else
  const uint32_t* as[] = {a_hi, a_lo};
  const uint32_t* bs[] = {b_hi, b_lo};
  const uint32_t (*warp)[emu::kSlots] = emu::publish(as, 2, bs, 2);
  emu::product(d, warp, 4, 8);   // a_lo b_hi
  emu::product(d, warp, 0, 10);  // a_hi b_lo
  emu::product(d, warp, 0, 8);   // a_hi b_hi
#endif
}

}  // namespace sspv
