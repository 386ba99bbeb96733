// The width rule of the few-lane kernels at n ≤ kUnrollMax, kernels A-D
// (riccati.cu:riccati_small_kernel, step.cu:step_kernel,
// candidate.cu:candidate_kernel, riccati_folded.cu:
// riccati_folded_small_kernel): how many lanes of a warp one solve takes,
// for a bank of B lanes on this card, and (kernel A) whether its teams
// read each step's streamed blocks into registers or stage them.
//
// K = 4 while that keeps the bank within kSmallFill = 512 threads an SM,
// so up to B = 16,896 on an H100's 132 SMs; 1 above.  A narrow bank so
// spreads its solves over four times the warps, which shortens what holds
// it, one solve's dependent chain; a wide bank fills the card with warps
// anyway, and there a solve's lanes, which all repeat the model calls, M's
// factor and the risk term, cost more issue slots than the extra warps
// save (python -m ratilqr_tpu_torch.team_sweep candidate and step; PERF.md
// §6).
//
// Kernel A streams its step's blocks (40-85 words a lane) where B and C
// recompute them.  At K = 4 its teams read them from device memory into
// registers while the bank stays within kDirectFill = 256 threads an SM
// (up to B = 8,448 on 132 SMs): there the SMs hold few warps, one solve's
// chain is the time, and reading into registers was 1.1-1.5x faster than
// staging (B = 1 to 8,192), which adds a block barrier and shared-memory
// loads to every step's chain.  Above, they stage them in shared memory:
// a thread holds 60-96 registers (f32) instead of 140-168, and at 16,384
// lanes staging was 1.4x faster (python -m ratilqr_tpu_torch.team_sweep
// riccati; PERF.md §6).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

// Lanes a solve: 0, the launch picks K by small_lanes; -DRQ_SMALL_LANES=1
// or 4 builds a variant whose launch always takes that K (python -m
// ratilqr_tpu_torch.team_sweep, tests/test_torch_*_emulated.py).
#ifndef RQ_SMALL_LANES
#define RQ_SMALL_LANES 0
#endif
static_assert(RQ_SMALL_LANES == 0 || RQ_SMALL_LANES == 1 || RQ_SMALL_LANES == 4,
              "a solve takes 1 or 4 lanes");

// Threads a block where K > 1 and at K = 1 (at K = 1 a 64-thread block
// raised kernel C's occupancy; 32, 64 and 128 tied for kernel B);
// -DRQ_SMALL_THREADS/-DRQ_WIDE_THREADS build the variants team_sweep
// times.
#ifndef RQ_SMALL_THREADS
#define RQ_SMALL_THREADS 128
#endif
#ifndef RQ_WIDE_THREADS
#define RQ_WIDE_THREADS 64
#endif

namespace rq {
namespace small {

constexpr int kSmallFill = 512;
constexpr int kDirectFill = 256;

__host__ __device__ constexpr int small_threads(int K) {
  return K > 1 ? RQ_SMALL_THREADS : RQ_WIDE_THREADS;
}

// The card's SM count (1 if the runtime cannot say).
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  return sms;
}

// Lanes a solve for a bank of B on `sms` SMs: 4 where that keeps the bank
// within kSmallFill threads an SM, else 1.
inline int small_lanes(int B, int sms) {
  if (RQ_SMALL_LANES > 0) return RQ_SMALL_LANES;
  return int64_t(B) * 4 <= int64_t(sms) * kSmallFill ? 4 : 1;
}

// Whether kernel A's teams of K lanes read their steps into registers at
// width B on `sms` SMs: always at K = 1, and at K > 1 while the bank stays
// within kDirectFill threads an SM.
inline bool small_direct(int B, int sms, int K) {
  return K == 1 || int64_t(B) * K <= int64_t(sms) * kDirectFill;
}

// f(k) for the K that small_lanes picked, as a compile-time constant:
// 4 or 1, or the one a variant fixes.
template <typename F>
int with_lanes(int K, F f) {
  if constexpr (RQ_SMALL_LANES > 0) {
    return f(std::integral_constant<int, RQ_SMALL_LANES>{});
  } else {
    if (K == 4) return f(std::integral_constant<int, 4>{});
    return f(std::integral_constant<int, 1>{});
  }
}

}  // namespace small
}  // namespace rq
