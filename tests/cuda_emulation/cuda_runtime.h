// A CPU stand-in for the CUDA runtime header, so that a kernel source of
// ratilqr_tpu_torch/csrc compiles with a host C++20 compiler and runs on
// the CPU.  Blocks run one after another on the calling thread; a block's
// CUDA threads are fibers on that thread, each on its own stack, and each
// runs until it reaches a barrier (__syncthreads() for the block,
// __syncwarp() for its warp of 32) or returns; a barrier opens when every
// thread of its block (or warp) that has not returned waits at it.
// __shfl_sync goes through a per-warp exchange array between two warp
// barriers; the device reports 132 SMs unless rq_emu_set_sm_count says
// otherwise; shared memory is one static buffer filled with NaN bytes
// before each block.  So one block takes one CPU core, however many
// threads it has.  It checks a kernel's arithmetic, indexing and barriers
// at small sizes; it says nothing of speed, and the lockstep it runs in
// hides races.  The cp.async pipeline calls of <cuda_pipeline.h>
// (cuda_pipeline.h beside this file includes this one) are synchronous
// stand-ins: __pipeline_memcpy_async copies at once, __pipeline_commit and
// __pipeline_wait_prior do nothing.  tests/test_torch_*_emulated.py use it.
#pragma once
#include <math.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>

#if !defined(__x86_64__)
#include <ucontext.h>
#endif

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
inline uint3 threadIdx, blockIdx, blockDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
// The emulated card's SM count (an H100's 132 unless a test sets another
// through rq_emu_set_sm_count).
inline int g_sm_count = 132;
extern "C" void rq_emu_set_sm_count(int sms) { g_sm_count = sms; }
inline int cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = g_sm_count;
  return cudaSuccess;
}
constexpr int kEmulatedSharedBytes = 232448;   // a block's limit on the H100
template <class F>
int cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  return bytes > kEmulatedSharedBytes ? 1 : 0;
}

alignas(64) inline unsigned char smem_raw[kEmulatedSharedBytes];
inline double g_shuffle[64][32];

// The round-to-nearest arithmetic intrinsics, which nvcc never fuses into
// a multiply-add: plain operations here (host code in ISO C++ mode is not
// contracted either).
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t bytes) {
  std::memcpy(dst, src, bytes);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}

namespace emu {

#if defined(__x86_64__)
// Save the callee-saved registers on the current stack, store its pointer
// in *save, and resume the stack at `load` (a fiber's, or the
// scheduler's).  A fiber's round trip through the scheduler takes about
// 50 ns this way and about 650 ns by swapcontext, which also saves the
// signal mask by a system call.
extern "C" void rq_emu_switch(void** save, void* load);
__asm__(
    ".pushsection .text\n"
    ".globl rq_emu_switch\n"
    ".hidden rq_emu_switch\n"
    ".type rq_emu_switch, @function\n"
    "rq_emu_switch:\n"
    "  pushq %rbp\n"
    "  pushq %rbx\n"
    "  pushq %r12\n"
    "  pushq %r13\n"
    "  pushq %r14\n"
    "  pushq %r15\n"
    "  movq %rsp, (%rdi)\n"
    "  movq %rsi, %rsp\n"
    "  popq %r15\n"
    "  popq %r14\n"
    "  popq %r13\n"
    "  popq %r12\n"
    "  popq %rbx\n"
    "  popq %rbp\n"
    "  ret\n"
    ".size rq_emu_switch, .-rq_emu_switch\n"
    ".popsection\n");
#endif

constexpr size_t kStackBytes = size_t(1) << 18;
enum Wait { kRunnable, kWarp, kBlock };

struct Fiber {
  std::unique_ptr<unsigned char[]> stack{new unsigned char[kStackBytes]};
#if defined(__x86_64__)
  void* sp = nullptr;
#else
  ucontext_t ctx;
#endif
  Wait wait = kRunnable;
  bool done = false;
};

inline std::vector<Fiber> fibers;
inline int current;
inline std::function<void()> body;
#if defined(__x86_64__)
inline void* scheduler_sp;
#else
inline ucontext_t scheduler_ctx;
#endif

// From the running fiber back to the scheduler.
inline void yield() {
#if defined(__x86_64__)
  rq_emu_switch(&fibers[current].sp, scheduler_sp);
#else
  swapcontext(&fibers[current].ctx, &scheduler_ctx);
#endif
}

// A fiber's first frame: the kernel, then back to the scheduler for good.
inline void entry() {
  body();
  fibers[current].done = true;
  yield();
}

// Fiber t ready to run the kernel from its start.
inline void start(int t) {
  Fiber& f = fibers[t];
  f.wait = kRunnable;
  f.done = false;
#if defined(__x86_64__)
  // rq_emu_switch pops six registers and returns into entry(), which then
  // sees the stack of a called function (16-byte aligned before the call).
  const uintptr_t top = (uintptr_t(f.stack.get()) + kStackBytes) & ~uintptr_t(15);
  void** sp = reinterpret_cast<void**>(top - 16);
  sp[0] = reinterpret_cast<void*>(&entry);
  sp -= 6;
  for (int i = 0; i < 6; ++i) sp[i] = nullptr;
  f.sp = sp;
#else
  getcontext(&f.ctx);
  f.ctx.uc_stack.ss_sp = f.stack.get();
  f.ctx.uc_stack.ss_size = kStackBytes;
  f.ctx.uc_link = nullptr;
  makecontext(&f.ctx, entry, 0);
#endif
}

// Run fiber t until it waits at a barrier or returns.
inline void resume(int t) {
  current = t;
  threadIdx.x = t;
#if defined(__x86_64__)
  rq_emu_switch(&scheduler_sp, fibers[t].sp);
#else
  swapcontext(&scheduler_ctx, &fibers[t].ctx);
#endif
}

// Open the barriers at which every fiber of [lo, hi) that has not returned
// waits: the block's, else each warp's.  Returns whether one opened.
inline bool open_barriers(int block) {
  const auto open = [](int lo, int hi, Wait at) {
    bool waiting = false;
    for (int t = lo; t < hi; ++t) {
      if (fibers[t].done) continue;
      if (fibers[t].wait != at) return false;
      waiting = true;
    }
    if (waiting)
      for (int t = lo; t < hi; ++t) fibers[t].wait = kRunnable;
    return waiting;
  };
  if (open(0, block, kBlock)) return true;
  bool opened = false;
  for (int lo = 0; lo < block; lo += 32) opened |= open(lo, std::min(lo + 32, block), kWarp);
  return opened;
}

}  // namespace emu

inline void __syncthreads() {
  emu::fibers[emu::current].wait = emu::kBlock;
  emu::yield();
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu::fibers[emu::current].wait = emu::kWarp;
  emu::yield();
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
// emulated_launch(kernel, grid, block, args).  Aborts on a barrier that no
// thread can pass (a deadlock on the card too).
template <class F, class A>
void emulated_launch(F kernel, int grid, int block, const A& args) {
  emu::body = [&] { kernel(args); };
  emu::fibers.resize(block);
  blockDim.x = block;
  for (int g = 0; g < grid; ++g) {
    std::memset(smem_raw, 0xff, sizeof(smem_raw));
    blockIdx.x = g;
    for (int t = 0; t < block; ++t) emu::start(t);
    for (;;) {
      for (int t = 0; t < block; ++t)
        if (!emu::fibers[t].done && emu::fibers[t].wait == emu::kRunnable) emu::resume(t);
      bool all_done = true;
      for (int t = 0; t < block; ++t) all_done = all_done && emu::fibers[t].done;
      if (all_done) break;
      if (!emu::open_barriers(block)) {
        std::fprintf(stderr, "emulated block %d: no thread can pass its barrier\n", g);
        std::abort();
      }
    }
  }
}
