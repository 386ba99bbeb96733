// Block-wide staging for the one-solve-per-team kernels (candidate.cu,
// step.cu, riccati.cu): a block holds K teams, team k on lane b0 + k of
// the bank (stage_lanes: the few-lane teams of candidate.cu at n ≤ 4).
//
// Once per step the block copies what its teams need from lane-minor
// (·, C, B) arrays into each team's shared memory in one pass, and writes
// the teams' per-step outputs back the same way: K consecutive lanes of
// one entry are neighbours in memory, so the block reads or writes them
// together (8 neighbouring lanes are one 32-byte sector in f32).  W_t,
// W⁻¹_t and logdet W_t, the same for every lane, are staged once a block.
// The caller puts a __syncthreads() before and after each pass.
//
// A staging pass may also be asynchronous (ASYNC): each word goes by
// cp.async (__pipeline_memcpy_async), which moves it from device memory to
// shared memory without holding a register, so the block can issue the
// next step's loads and go on computing.  The caller then commits the
// batch (__pipeline_commit) and, before the __syncthreads() that publishes
// it, waits for it (__pipeline_wait_prior).
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

// Lanes per team (16: half a warp; 32: a warp) and teams per block.
// -DRQ_TEAM_LANES=.. -DRQ_TEAMS=.. build other shapes for
// python -m ratilqr_tpu_torch.team_sweep to time.
#ifndef RQ_TEAM_LANES
#define RQ_TEAM_LANES 16
#endif
#ifndef RQ_TEAMS
#define RQ_TEAMS 8
#endif

namespace rq {
namespace team {

constexpr int kTeamLanes = RQ_TEAM_LANES;
constexpr int kTeams = RQ_TEAMS;
static_assert(32 % kTeamLanes == 0 && kTeamLanes * kTeams % 32 == 0,
              "teams fill whole warps and never straddle one");

// Blocks of a team kernel an H100 SM holds at once: as many as its shared
// memory allows (228 KB an SM, 1 KB of it reserved a block), and no more
// than leave each thread `regs` of the SM's 65,536 registers.  As the
// minimum blocks of __launch_bounds__ it gives ptxas the register budget
// of the occupancy the shared memory sets anyway.
constexpr int resident_blocks(int smem_bytes, int threads, int regs) {
  const int by_smem = 233472 / (smem_bytes + 1024);
  const int by_regs = 65536 / (regs * threads);
  return by_smem < by_regs ? by_smem : by_regs;
}

// An empty member: what a team or block stages only in some variants
// (e.g. std::conditional_t<WLANE, Noise<T, N>, Nothing<0>>).
template <int>
struct Nothing {};

// W_t, W⁻¹_t and logdet W_t.
template <typename T, int N>
struct Noise {
  T W[N][N], Wi[N][N], ldW;
};

// A block's shared memory: W_t, W⁻¹_t and logdet W_t (the same for every
// lane) and its K teams' working sets.
template <typename T, int N, typename Team, int K>
struct BlockSmem {
  T W[N][N], Wi[N][N], ldW;
  Team team[K];
};

// One word from device memory into shared memory: a plain copy, or
// (ASYNC) a cp.async of 4 or 8 bytes.
template <bool ASYNC, typename T>
__device__ __forceinline__ void copy_word(T* dst, const T* src) {
  if constexpr (ASYNC)
    __pipeline_memcpy_async(dst, src, sizeof(T));
  else
    *dst = *src;
}

// Copy C entries per lane of step t of a lane-minor (·, C, B) array to
// dst(k)[0..C) for each of the block's K teams (dst(k): a T* into team k's
// shared memory).  Lanes past the bank read lane B − 1 (their teams store
// nothing).
template <int C, int K, bool ASYNC = false, typename T, typename Dst>
__device__ __forceinline__ void stage_into(const T* src, int t, int64_t B, int b0, Dst dst) {
  for (int idx = threadIdx.x; idx < C * K; idx += blockDim.x) {
    const int k = idx % K, c = idx / K;
    const int64_t b = b0 + k < B ? b0 + k : B - 1;
    copy_word<ASYNC>(dst(k) + c, src + (int64_t(t) * C + c) * B + b);
  }
}

// Copy C entries per lane of step t of a lane-minor (·, C, B) array to
// dst[c][k] for the block's S lanes b0 + k: entry-major, as in device
// memory, so a warp reads and writes runs of neighbouring words.  The
// block's Threads threads each take one lane k and every (Threads / S)-th
// entry, so a copy costs one address add.  Lanes past the bank read lane
// B − 1.
template <int C, int S, int Threads, bool ASYNC = false, typename T>
__device__ __forceinline__ void stage_lanes(T (&dst)[C][S], const T* src, int t, int64_t B,
                                            int b0) {
  static_assert(Threads % S == 0, "the block's threads cover its lanes evenly");
  const int k = threadIdx.x % S;
  const int64_t b = b0 + k < B ? b0 + k : B - 1;
  const T* from = src + int64_t(t) * C * B + b;
#pragma unroll
  for (int c = threadIdx.x / S; c < C; c += Threads / S)
    copy_word<ASYNC>(&dst[c][k], from + c * B);
}

// stage_into field `f` of each team.
template <int C, typename T, typename Team, typename Field, int K>
__device__ __forceinline__ void stage(const T* src, int t, int64_t B, int b0, Team (&teams)[K],
                                      Field Team::*f) {
  stage_into<C, K>(src, t, B, b0,
                   [&](int k) { return reinterpret_cast<T*>(&(teams[k].*f)); });
}

// The reverse of stage: C entries of field `f` of each team into step t
// of a lane-minor (·, C, B) array; teams past the bank store nothing.
template <int C, typename T, typename Team, typename Field, int K>
__device__ __forceinline__ void unstage(T* dst, int t, int64_t B, int b0, const Team (&teams)[K],
                                        Field Team::*f) {
  for (int idx = threadIdx.x; idx < C * K; idx += blockDim.x) {
    const int k = idx % K, c = idx / K;
    if (b0 + k < B)
      dst[(int64_t(t) * C + c) * B + b0 + k] = reinterpret_cast<const T*>(&(teams[k].*f))[c];
  }
}

// Copy C consecutive words, the same for every lane, into the block's
// shared memory.
template <int C, bool ASYNC = false, typename T>
__device__ __forceinline__ void stage_block(T* dst, const T* src) {
  for (int idx = threadIdx.x; idx < C; idx += blockDim.x) copy_word<ASYNC>(dst + idx, src + idx);
}

// W_t, W⁻¹_t ((T, N, N)) and logdet W_t ((T,)) into one copy in shared
// memory.
template <int N, bool ASYNC = false, typename T>
__device__ __forceinline__ void stage_noise(T (&W)[N][N], T (&Wi)[N][N], T& ldW, const T* Ws,
                                            const T* Wis, const T* ldWs, int t) {
  stage_block<N * N, ASYNC>(&W[0][0], Ws + int64_t(t) * N * N);
  stage_block<N * N, ASYNC>(&Wi[0][0], Wis + int64_t(t) * N * N);
  stage_block<1, ASYNC>(&ldW, ldWs + t);
}

// W_t, W⁻¹_t and logdet W_t into the block's copy.
template <typename T, int N, typename Team, int K>
__device__ __forceinline__ void stage_noise(BlockSmem<T, N, Team, K>& sm, const T* Ws,
                                            const T* Wis, const T* ldWs, int t) {
  stage_noise<N>(sm.W, sm.Wi, sm.ldW, Ws, Wis, ldWs, t);
}

}  // namespace team
}  // namespace rq
