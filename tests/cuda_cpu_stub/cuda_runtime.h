// A CPU stand-in for the CUDA runtime, for tests/test_torch_kernels_on_cpu.py:
// the kernel sources of sspv_tpu_torch/csrc compile with a host C++ compiler
// against this header and run with every thread of a block as a host thread.
// Warps synchronise and shuffle through barriers, so the warp-synchronous code
// runs as written (every lane of a warp must reach each __syncwarp and each
// shuffle, as on the card). Blocks run one after another. Only what those
// sources use is here.
#pragma once

#include <pthread.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
struct float4 {
  float x, y, z, w;
};
struct alignas(16) int4 {
  int x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaDevAttrMultiProcessorCount = 16
};

constexpr size_t kEmuSharedBytes = 232448;  // what a block may use on the card

struct EmuBlock {
  pthread_barrier_t block_barrier;
  std::vector<pthread_barrier_t> warp_barriers;
  std::vector<uint32_t> slots;  // one shuffle slot per thread
};

// Defined once, in the translation unit that defines EMU_MAIN.
extern thread_local dim3 threadIdx, blockIdx;
extern dim3 blockDim, gridDim;
extern EmuBlock* emu_block;
extern float4 smem4[];  // every kernel's `extern __shared__ float4 smem4[]`
#ifdef EMU_MAIN
thread_local dim3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
EmuBlock* emu_block = nullptr;
alignas(16) float4 smem4[kEmuSharedBytes / 16];
#endif

template <class T>
inline T __ldg(const T* p) {
  return *p;
}
template <class T>
inline cudaError_t cudaFuncSetAttribute(T, int, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* device) {
  *device = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, int, int) {
  *value = 1;  // one multiprocessor: the grid-stride loops take several turns
  return cudaSuccess;
}
template <class T>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, T, int,
                                                                 size_t) {
  *n = 1;  // with one multiprocessor: one block takes every tile in turn
  return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return "CPU stand-in"; }

// Double-precision arithmetic rounded to nearest, never contracted into an
// FMA: the host's own operations (the test builds for the baseline x86-64 or
// with -ffp-contract=off).
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline float __double2float_rn(double x) { return (float)x; }

inline void __syncthreads() { pthread_barrier_wait(&emu_block->block_barrier); }
inline void __syncwarp() {
  pthread_barrier_wait(&emu_block->warp_barriers[threadIdx.x >> 5]);
}

// The value of lane `src` of the caller's warp (the caller's own if `src` is
// outside the warp).
template <class T>
inline T emu_shuffle(T v, int src) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  std::memcpy(&emu_block->slots[threadIdx.x], &v, 4);
  __syncwarp();
  T out = v;
  if (src >= 0 && src < 32)
    std::memcpy(&out, &emu_block->slots[(threadIdx.x & ~31u) + src], 4);
  __syncwarp();
  return out;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int lane) {
  return emu_shuffle(v, lane);
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int mask) {
  return emu_shuffle(v, (int)(threadIdx.x & 31) ^ mask);
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, int delta) {
  return emu_shuffle(v, (int)(threadIdx.x & 31) - delta);
}

// kernel<<<blocks, threads, shared_bytes, stream>>>(args...), which the test
// rewrites to emu_launch(kernel, blocks, threads, shared_bytes, stream, args...).
// One host thread per thread of a block runs every block of the grid in turn;
// a barrier ends each block before the next one starts.
template <class Kernel, class... Args>
void emu_launch(Kernel kernel, int blocks, int threads, size_t shared_bytes,
                cudaStream_t, Args... args) {
  if (shared_bytes > kEmuSharedBytes || threads > 1024) std::abort();
  gridDim.x = blocks;
  blockDim.x = threads;
  EmuBlock block;
  emu_block = &block;
  pthread_barrier_init(&block.block_barrier, nullptr, threads);
  block.warp_barriers.resize((threads + 31) / 32);
  for (size_t w = 0; w < block.warp_barriers.size(); ++w)
    pthread_barrier_init(&block.warp_barriers[w], nullptr,
                         std::min(32, threads - 32 * (int)w));
  block.slots.assign(threads, 0);
  std::vector<std::thread> lanes;
  for (int t = 0; t < threads; ++t)
    lanes.emplace_back([=, &block] {
      threadIdx.x = t;
      for (int b = 0; b < blocks; ++b) {
        blockIdx.x = b;
        kernel(args...);
        pthread_barrier_wait(&block.block_barrier);
      }
    });
  for (auto& lane : lanes) lane.join();
  pthread_barrier_destroy(&block.block_barrier);
  for (auto& w : block.warp_barriers) pthread_barrier_destroy(&w);
}
