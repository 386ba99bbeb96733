// A CPU stand-in for the CUDA runtime header, so that a kernel source of
// ratilqr_tpu_torch/csrc compiles with a host C++20 compiler and runs on
// the CPU: one std::thread per CUDA thread, a std::barrier per block for
// __syncthreads() and per warp for __syncwarp(), __shfl_sync through a
// per-warp exchange array, blocks one after another, shared memory one
// static buffer filled with NaN bytes before each block.  It checks a
// kernel's arithmetic, indexing and barriers at small sizes; it says
// nothing of speed.  tests/test_torch_candidate_emulated.py uses it.
#pragma once
#include <math.h>

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __align__(n)
#define __launch_bounds__(...)

struct uint3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local uint3 threadIdx, blockIdx, blockDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int cudaGetLastError() { return 0; }
constexpr int kEmulatedSharedBytes = 232448;   // a block's limit on the H100
template <class F>
int cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  return bytes > kEmulatedSharedBytes ? 1 : 0;
}

alignas(64) inline unsigned char smem_raw[kEmulatedSharedBytes];
inline std::barrier<>* g_block_barrier;
inline std::vector<std::unique_ptr<std::barrier<>>> g_warp_barriers;
inline double g_shuffle[64][32];

inline void __syncthreads() { g_block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  g_warp_barriers[threadIdx.x / 32]->arrive_and_wait();
}
template <class T>
T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_shuffle[w][l] = double(v);
  __syncwarp();
  const T r = T(g_shuffle[w][(l / width) * width + src]);
  __syncwarp();
  return r;
}

// kernel<<<grid, block, bytes, stream>>>(args) becomes
// emulated_launch(kernel, grid, block, args).
template <class F, class A>
void emulated_launch(F kernel, int grid, int block, const A& args) {
  for (int g = 0; g < grid; ++g) {
    std::memset(smem_raw, 0xff, sizeof(smem_raw));
    std::barrier<> block_barrier(block);
    g_block_barrier = &block_barrier;
    g_warp_barriers.clear();
    for (int w = 0; w < (block + 31) / 32; ++w)
      g_warp_barriers.emplace_back(new std::barrier<>(std::min(32, block - 32 * w)));
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([=, &args] {
        threadIdx.x = t;
        blockIdx.x = g;
        blockDim.x = block;
        kernel(args);
      });
    for (auto& th : threads) th.join();
  }
}
