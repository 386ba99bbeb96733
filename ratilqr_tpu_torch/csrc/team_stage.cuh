// Block-wide staging for the one-solve-per-team kernels (candidate.cu,
// step.cu): a block holds K teams, team k on lane b0 + k of the bank.
//
// Once per step the block copies what its teams need from lane-minor
// (·, C, B) arrays into each team's shared memory in one pass, and writes
// the teams' per-step outputs back the same way: K consecutive lanes of
// one entry are neighbours in memory, so the block reads or writes them
// together (8 neighbouring lanes are one 32-byte sector in f32).  W_t,
// W⁻¹_t and logdet W_t, the same for every lane, are staged once a block.
// The caller puts a __syncthreads() before and after each pass.
#pragma once

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

// A block's shared memory: W_t, W⁻¹_t and logdet W_t (the same for every
// lane) and its K teams' working sets.
template <typename T, int N, typename Team, int K>
struct BlockSmem {
  T W[N][N], Wi[N][N], ldW;
  Team team[K];
};

// Copy C entries per lane of step t of a lane-minor (·, C, B) array into
// field `f` of each of the block's K teams.  Lanes past the bank read lane
// B − 1 (their teams store nothing).
template <int C, typename T, typename Team, typename Field, int K>
__device__ __forceinline__ void stage(const T* src, int t, int64_t B, int b0, Team (&teams)[K],
                                      Field Team::*f) {
  for (int idx = threadIdx.x; idx < C * K; idx += blockDim.x) {
    const int k = idx % K, c = idx / K;
    const int64_t b = b0 + k < B ? b0 + k : B - 1;
    reinterpret_cast<T*>(&(teams[k].*f))[c] = src[(int64_t(t) * C + c) * B + b];
  }
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

// W_t, W⁻¹_t ((T, N, N)) and logdet W_t ((T,)) into the block's copy.
template <typename T, int N, typename Team, int K>
__device__ __forceinline__ void stage_noise(BlockSmem<T, N, Team, K>& sm, const T* Ws,
                                            const T* Wis, const T* ldWs, int t) {
  for (int idx = threadIdx.x; idx < N * N; idx += blockDim.x) {
    (&sm.W[0][0])[idx] = Ws[int64_t(t) * N * N + idx];
    (&sm.Wi[0][0])[idx] = Wis[int64_t(t) * N * N + idx];
  }
  if (threadIdx.x == 0) sm.ldW = ldWs[t];
}

}  // namespace team
}  // namespace rq
