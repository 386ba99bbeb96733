// Kernel D: the value-only evaluating Riccati pass over a closed-loop-folded
// stack.
//
// Replaces ratilqr_tpu/ops/riccati_pallas.py:_riccati_folded_kernel (:581),
// reached through riccati_bank_folded (:669).  Per step it reads the folded
// blocks (q, q̄_vec, Q̄, Ā) of ratilqr_tpu/ops/approx.py:FoldedApprox and
// runs folded_step, the step kernel C runs after refolding:
//   M = sym(W⁻¹ − θS) (a failed factor latches m_fail), D = I + θ(M⁻¹S)ᵀ,
//   s ← q + s + risk,  s⃗ ← q̄_vec + ĀᵀD s⃗,  S ← sym(Q̄ + ĀᵀD S Ā).
// The noise model is shared (T, n, n) or per lane (T, n, n, B).  Only value
// and m_fail are written, once, after step 0.
//
// Two designs, chosen per n at compile time (launch()):
//
// One solve per thread (riccati_folded_kernel; n ≤ kUnrollMax, and n a
// team does not take): the T-step backward loop runs inside the thread
// with the carry (s, s⃗, S, m_fail) in registers, folded_step of
// dp_step.cuh.  A CUDA grid gives no order between blocks, so unlike the
// Pallas grid (tiles, T) time is never a grid axis.  Per-lane arrays are
// lane-minor, (T, ..., B), so a warp's loads coalesce; a shared noise
// model is one buffer every lane reads (SMEM on the TPU, L1/L2-resident
// here).
//
// One solve per team (riccati_folded_team_kernel; kUnrollMax < n <
// kTeamLanes: the quadrotor n=12, and n = 5..15 built at first use, e.g.
// n=6): the same recursion spread over a team of 16 lanes (two a warp)
// with rq::team::folded_step (team_mat.cuh), which takes one lane per row
// of M and the lane after the last row for M⁻¹s⃗; K = kTeams = 8 teams a
// block on 8 consecutive lanes b (team_stage.cuh).  Each team keeps its
// working set in shared memory: the carry (s, s⃗, S), θ, folded_step's
// FoldScratch, and the step's streamed blocks (q, q̄_vec, Q̄, Ā; a
// per-lane noise model: W_t, W⁻¹_t, logdet W_t; a shared one is the
// block's), which the block stages from the lane-minor inputs in one
// coalesced pass a step.  With kBuffers = 2 they are double-buffered:
// after the barrier that publishes step t, the block's cp.async copies
// bring step t − 1 into the other buffer while the teams run step t, so a
// step takes one block barrier (kBuffers = 1: two, around a synchronous
// pass).  A team past the end of the bank reads lane B − 1, keeps every
// barrier and stores nothing.
//
// Bound on the H100: per step and lane it streams 1 + n + 2n² words (22 for
// the unicycle, 88 bytes in f32) against ~250 scalar operations (the 3x3
// factor, two solves, three 3x3 products): ~3 operations per byte, below
// the card's ~20 FP32 operations per byte of DRAM bandwidth.  At
// B = 262,144 and T = 100 that is ~2.3 GB, ~0.7 ms at 3.35 TB/s, so the
// per-thread kernel is bound by device memory; coalescing is all it does
// about it.
//
// At n=12 (the quadrotor) a step streams 301 words (1.2 KB in f32) against
// ~16,200 operations: at B = 16,384 and T = 50, 1.0 GB (0.30 ms) against
// 1.33e10 operations (0.20 ms), bound by bytes on paper.  One solve per
// thread kept the 12x12 carry, Q̄, Ā, W and W⁻¹ in a 6.6 KB stack frame
// (f32), 108 MB of local memory at that width, beyond the 50 MB L2, and
// took 44.281 ms there (149x the bound; 278.608 ms at B = 262,144): hence
// the team design, which takes 2.626 ms (8.8x the bound) and 38.210 ms
// (8.0x the 4.761 ms bound at B = 262,144) with a 0 B stack frame and no
// spills, 80 registers a thread (launch alone, f32, python -m
// ratilqr_tpu_torch.team_sweep riccati_folded; NVIDIA H100 80GB HBM3,
// 700 W; PERF.md §6).
//
// At n=4 (the cartpole) a step streams 37 words against ~750 operations: at
// B = 16,384 and T = 50, 0.12 GB (0.037 ms) against 6.1e8 operations
// (0.009 ms), bound by bytes.
#include <cstdint>
#include <type_traits>

#include "dp_step.cuh"
#include "dtype.cuh"
#include "team_mat.cuh"
#include "team_stage.cuh"

// Buffers of a team's streamed blocks, as in riccati.cu: 1 stages each
// step synchronously; 2 copies step t − 1 by cp.async while the teams
// compute step t.  -DRQ_STAGE_BUFFERS=.. builds the other form for
// python -m ratilqr_tpu_torch.team_sweep riccati_folded to time.
#ifndef RQ_STAGE_BUFFERS
#define RQ_STAGE_BUFFERS 2
#endif

namespace {

using rq::team::kTeamLanes;
using rq::team::kTeams;
using rq::team::Noise;
using rq::team::Nothing;
constexpr int kBuffers = RQ_STAGE_BUFFERS;
static_assert(kBuffers == 1 || kBuffers == 2, "one or two staging buffers");

struct FoldedArgs {
  int B, T, w_shared;
  const void *q, *q_vec, *Q, *A, *W, *W_inv, *logdet_W;
  const void *q_term, *q_vec_term, *Q_term, *theta;
  void* value;
  bool* m_fail;
};

template <typename T, int N>
__global__ void __launch_bounds__(128) riccati_folded_kernel(const FoldedArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int64_t B = a.B;
  const T* q = static_cast<const T*>(a.q);
  const T* q_vec = static_cast<const T*>(a.q_vec);
  const T* Qs = static_cast<const T*>(a.Q);
  const T* As = static_cast<const T*>(a.A);
  const T* Ws = static_cast<const T*>(a.W);
  const T* Wis = static_cast<const T*>(a.W_inv);
  const T* ldWs = static_cast<const T*>(a.logdet_W);

  // Terminal carry.
  T s = static_cast<const T*>(a.q_term)[b];
  T sv[N], S[N][N];
#pragma unroll (rq::Unroll<N>::value)
  for (int i = 0; i < N; ++i) {
    sv[i] = static_cast<const T*>(a.q_vec_term)[i * B + b];
#pragma unroll (rq::Unroll<N>::value)
    for (int j = 0; j < N; ++j) S[i][j] = static_cast<const T*>(a.Q_term)[(i * N + j) * B + b];
  }
  const T theta = static_cast<const T*>(a.theta)[b];
  bool m_fail = false;

  for (int t = a.T - 1; t >= 0; --t) {
    T qt = q[t * B + b], qv[N], Q[N][N], A[N][N], W[N][N], Wi[N][N];
#pragma unroll (rq::Unroll<N>::value)
    for (int i = 0; i < N; ++i) {
      qv[i] = q_vec[(t * N + i) * B + b];
#pragma unroll (rq::Unroll<N>::value)
      for (int j = 0; j < N; ++j) {
        const int64_t e = (int64_t(t) * N + i) * N + j;
        Q[i][j] = Qs[e * B + b];
        A[i][j] = As[e * B + b];
        W[i][j] = a.w_shared ? Ws[e] : Ws[e * B + b];
        Wi[i][j] = a.w_shared ? Wis[e] : Wis[e * B + b];
      }
    }
    const T ldW = a.w_shared ? ldWs[t] : ldWs[t * B + b];
    rq::folded_step<T, N>(qt, qv, Q, A, W, Wi, ldW, theta, s, sv, S, m_fail);
  }
  static_cast<T*>(a.value)[b] = s;
  a.m_fail[b] = m_fail;
}

// ---- One solve per team (kUnrollMax < N < kTeamLanes) ----

// The n a team takes: past the per-thread kernel's unrolled algebra, with
// a lane for every row of M and one more for M⁻¹s⃗ (team::m_factor).
template <int N>
constexpr bool kTeamShape = N > rq::kUnrollMax && N < kTeamLanes;

// What a team stages each step: the folded blocks, and the noise model
// when it is per lane (WLANE).
template <typename T, int N, bool WLANE>
struct StepIn {
  T Q[N][N], A[N][N], qv[N], q;
  std::conditional_t<WLANE, Noise<T, N>, Nothing<0>> noise;
};

// One team's working set: the streamed blocks (kBuffers of them), the
// carry (s, s⃗, S), folded_step's scratch and θ.
template <typename T, int N, bool WLANE>
struct FoldedTeam {
  StepIn<T, N, WLANE> in[kBuffers];
  T S[N][N];
  rq::team::FoldScratch<T, N> w;
  T sv[N], s, theta;
};

// A block's shared memory: its K teams and, when the noise model is
// shared, the block's own kBuffers copies of it.
template <typename T, int N, bool WLANE, int K>
struct FoldedBlock {
  std::conditional_t<WLANE, Nothing<1>, Noise<T, N>[kBuffers]> noise;
  FoldedTeam<T, N, WLANE> team[K];
};

// The same pass as riccati_folded_kernel, one solve per team.  The
// register budget is that of the blocks the shared memory lets an SM hold,
// but no less than the 80 registers a thread (160 in f64) kernel B's team
// step takes.
template <typename T, int N, bool WLANE, int Lanes, int K>
__global__ void __launch_bounds__(
    Lanes * K, rq::team::resident_blocks(sizeof(FoldedBlock<T, N, WLANE, K>), Lanes * K,
                                         20 * int(sizeof(T))))
    riccati_folded_team_kernel(const FoldedArgs a) {
  using Team = FoldedTeam<T, N, WLANE>;
  using In = StepIn<T, N, WLANE>;
  using rq::team::stage;
  using rq::team::stage_into;
  constexpr bool kAsync = kBuffers == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<FoldedBlock<T, N, WLANE, K>*>(smem_raw);
  const int lane = threadIdx.x % Lanes, k = threadIdx.x / Lanes;
  const int b0 = blockIdx.x * K, b = b0 + k;
  const int64_t B = a.B;
  Team& tm = sm.team[k];
  const auto in = [](const void* p) { return static_cast<const T*>(p); };

  // Step t's streamed blocks into buffer j of every team (and of the
  // block, for a shared noise model).
  const auto fetch = [&](int t, int j) {
    const auto x = [&](int i) -> In& { return sm.team[i].in[j]; };
    stage_into<1, K, kAsync>(in(a.q), t, B, b0, [&](int i) { return &x(i).q; });
    stage_into<N, K, kAsync>(in(a.q_vec), t, B, b0, [&](int i) { return x(i).qv; });
    stage_into<N * N, K, kAsync>(in(a.Q), t, B, b0, [&](int i) { return &x(i).Q[0][0]; });
    stage_into<N * N, K, kAsync>(in(a.A), t, B, b0, [&](int i) { return &x(i).A[0][0]; });
    if constexpr (WLANE) {
      stage_into<N * N, K, kAsync>(in(a.W), t, B, b0,
                                   [&](int i) { return &x(i).noise.W[0][0]; });
      stage_into<N * N, K, kAsync>(in(a.W_inv), t, B, b0,
                                   [&](int i) { return &x(i).noise.Wi[0][0]; });
      stage_into<1, K, kAsync>(in(a.logdet_W), t, B, b0, [&](int i) { return &x(i).noise.ldW; });
    } else {
      rq::team::stage_noise<N, kAsync>(sm.noise[j].W, sm.noise[j].Wi, sm.noise[j].ldW, in(a.W),
                                       in(a.W_inv), in(a.logdet_W), t);
    }
  };

  // Terminal carry and θ.
  stage<N * N>(in(a.Q_term), 0, B, b0, sm.team, &Team::S);
  stage<N>(in(a.q_vec_term), 0, B, b0, sm.team, &Team::sv);
  stage<1>(in(a.q_term), 0, B, b0, sm.team, &Team::s);
  stage<1>(in(a.theta), 0, B, b0, sm.team, &Team::theta);
  if (kAsync && a.T > 0) {
    fetch(a.T - 1, 0);
    __pipeline_commit();
  }
  __syncthreads();
  T s = tm.s;   // lane 0's
  const T theta = tm.theta;
  bool m_fail = false;
  int cur = 0;
  for (int t = a.T - 1; t >= 0; --t) {
    if constexpr (kAsync) {
      __pipeline_wait_prior(0);   // this thread's copies of step t
      // Every copy of step t has landed, and every team is done with step
      // t + 1, whose buffer now takes step t − 1.
      __syncthreads();
      if (t > 0) {
        fetch(t - 1, 1 - cur);
        __pipeline_commit();
      }
    } else {
      __syncthreads();   // step t + 1 is done with the buffer
      fetch(t, 0);
      __syncthreads();
    }
    const In& x = tm.in[cur];
    const Noise<T, N>& nz = [&]() -> const Noise<T, N>& {
      if constexpr (WLANE)
        return x.noise;
      else
        return sm.noise[cur];
    }();
    rq::team::folded_step<T, N, Lanes>(lane, x.q, x.qv, x.Q, x.A, nz.W, nz.Wi, nz.ldW, theta, s,
                                       tm.sv, tm.S, m_fail, tm.w);
    if constexpr (kAsync) cur = 1 - cur;
  }
  if (b < a.B && lane == 0) {
    static_cast<T*>(a.value)[b] = s;   // the t = 0 value
    a.m_fail[b] = m_fail;
  }
}

// Dynamic shared memory of one team-kernel block (0: one solve per
// thread).
template <typename T, int N, bool WLANE>
constexpr int team_smem_bytes() {
  if constexpr (kTeamShape<N>)
    return int(sizeof(FoldedBlock<T, N, WLANE, kTeams>));
  else
    return 0;
}

template <typename T, int N, bool WLANE>
cudaError_t launch_team(const FoldedArgs& a, cudaStream_t stream) {
  constexpr int bytes = team_smem_bytes<T, N, WLANE>();
  const auto kernel = riccati_folded_team_kernel<T, N, WLANE, kTeamLanes, kTeams>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<(a.B + kTeams - 1) / kTeams, kTeamLanes * kTeams, bytes, stream>>>(a);
  return cudaGetLastError();
}

// One solve per team for the n a team takes, one per thread otherwise.
template <typename T, int N>
cudaError_t launch(const FoldedArgs& a, cudaStream_t stream) {
  if constexpr (kTeamShape<N>) {
    return a.w_shared ? launch_team<T, N, false>(a, stream) : launch_team<T, N, true>(a, stream);
  } else {
    const int threads = 128;
    const int blocks = (a.B + threads - 1) / threads;
    riccati_folded_kernel<T, N><<<blocks, threads, 0, stream>>>(a);
    return cudaGetLastError();
  }
}

template <int N_>
struct Dim {
  static constexpr int N = N_;
};

// f(Dim<n>{}) for an instantiated n, else -1.  As in riccati.cu: the
// shipped models' n here, any other n built at its first use from this
// file with -DRQ_SHAPE_N=n, holding that n alone.
template <typename F>
int with_dim(int n, F f) {
#if defined(RQ_SHAPE_N)
  if (n == RQ_SHAPE_N) return f(Dim<RQ_SHAPE_N>{});
#else
  if (n == 3) return f(Dim<3>{});
  if (n == 2) return f(Dim<2>{});
  if (n == 4) return f(Dim<4>{});
  if (n == 12) return f(Dim<12>{});
#endif
  return -1;
}

}  // namespace

// Per-lane arrays are lane-minor, of type Real; the noise model is
// (T, n, n)/(T,) when w_shared, else lane-minor too.  Returns
// cudaGetLastError() after the launch, or -1 for an unsupported n.
extern "C" int RQ_ENTRY(ratilqr_riccati_folded)(int n, int B, int T, int w_shared,
                                                const void* q, const void* q_vec, const void* Q,
                                                const void* A, const void* W, const void* W_inv,
                                                const void* logdet_W, const void* q_term,
                                                const void* q_vec_term, const void* Q_term,
                                                const void* theta, void* value, void* m_fail,
                                                void* stream) {
  if (B <= 0) return 0;
  const FoldedArgs a{B,      T,          w_shared, q,     q_vec, Q,
                     A,      W,          W_inv,    logdet_W, q_term, q_vec_term,
                     Q_term, theta,      value,    static_cast<bool*>(m_fail)};
  return with_dim(n, [&](auto dim) {
    using D = decltype(dim);
    return int(launch<Real, D::N>(a, static_cast<cudaStream_t>(stream)));
  });
}

// Dynamic shared memory a block of kernel D takes at n with a shared or
// per-lane noise model (0 for one solve per thread, -1 for an n not
// instantiated); its teams per block and lanes per team.
extern "C" int RQ_ENTRY(ratilqr_riccati_folded_smem)(int n, int w_shared, int* teams_per_block,
                                                     int* lanes_per_team) {
  *teams_per_block = kTeams;
  *lanes_per_team = kTeamLanes;
  return with_dim(n, [&](auto dim) {
    using D = decltype(dim);
    return w_shared ? team_smem_bytes<Real, D::N, false>() : team_smem_bytes<Real, D::N, true>();
  });
}
