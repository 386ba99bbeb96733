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
// and m_fail are written, once, after step 0.  A CUDA grid gives no order
// between blocks, so unlike the Pallas grid (tiles, T) time is never a
// grid axis: each solve runs its T-step backward loop in one team or
// thread.  Per-lane arrays are lane-minor, (T, ..., B), so neighbouring
// solves read neighbouring words; a shared noise model is one buffer every
// solve reads (SMEM on the TPU).
//
// Three designs, chosen per n at compile time (launch()):
//
// One solve per team of 4 lanes of a warp (riccati_folded_small_kernel;
// n ≤ kUnrollMax: the unicycle n=3, LQR n=2, the cartpole n=4, and any
// n ≤ 4 built at first use) while small_launch.cuh's rule takes K = 4
// (the bank within 512 threads an SM, B ≤ 16,896 on 132 SMs), on
// small_team.cuh's folded_step, the step kernel C runs: every lane holds
// the carry (s, s⃗, S), θ, the step's blocks and M's factor; lane r takes
// the solves with M's factor for columns r, r + 4 of M⁻¹[S | s⃗] and the
// rows r, r + 4 of DS and ĀᵀDS·Ā, and the rows go round by
// __shfl_sync(width = 4).  A block is 128 threads, 32 solves.  Each
// step's blocks (q, q̄_vec, Q̄, Ā and the noise model W_t, W⁻¹_t,
// logdet W_t) are read from device memory into registers at the top of
// the step; no shared memory.  The float32 register budget (kMinBlocks)
// lets an SM hold the whole band at once.  Kernel D streams 22-37 words a
// lane and step (A 40-67), and read into registers it beat staging them
// in shared memory by cp.async at every float32 width of the band
// (PERF.md §6).  The risk term's last product and difference are rounded
// on their own (small_team.cuh:risk_term), as in one solve per thread; the
// contraction policy is smallmat.cuh's default, kFactor.  Above the band (K = 1) the launch takes the
// one-solve-per-thread kernel below, its risk term rounded alike: a team
// of one lane ran the few-lane algebra up to 10% slower there (PERF.md
// §6).
//
// One solve per team of 16 lanes (riccati_folded_team_kernel; kUnrollMax
// < n < kTeamLanes: the quadrotor n=12, and n = 5..15 built at first use,
// e.g. n=6): the same recursion spread over a team of 16 lanes (two a
// warp) with rq::team::folded_step (team_mat.cuh), which takes one lane
// per row of M and the lane after the last row for M⁻¹s⃗; K = kTeams = 8
// teams a block on 8 consecutive lanes b (team_stage.cuh).  Each team
// keeps its working set in shared memory: the carry (s, s⃗, S), θ,
// folded_step's FoldScratch, and the step's streamed blocks (q, q̄_vec,
// Q̄, Ā; a per-lane noise model: W_t, W⁻¹_t, logdet W_t; a shared one is
// the block's), which the block stages from the lane-minor inputs in one
// coalesced pass a step.  With kBuffers = 2 they are double-buffered:
// after the barrier that publishes step t, the block's cp.async copies
// bring step t − 1 into the other buffer while the teams run step t, so a
// step takes one block barrier (kBuffers = 1: two, around a synchronous
// pass).
//
// One solve per thread (riccati_folded_kernel; n ≤ kUnrollMax above the
// 4-lane band, and kTeamLanes ≤ n ≤ MAX_DIM, built at first use): the
// T-step loop inside the thread with the carry (s, s⃗, S, m_fail) in
// registers (in its stack frame at n ≥ 16), folded_step of dp_step.cuh,
// 128 threads a block.
//
// In the team designs a team past the end of the bank reads lane B − 1,
// keeps every barrier and shuffle and stores nothing; a thread past it
// returns at once.
//
// Bound on the H100 (kernel_check.bound_ms): per step and lane D streams
// 1 + n + 2n² words (22 for the unicycle, 88 bytes in f32; 37 for the
// cartpole) against ~250 scalar operations (~750 at n=4), so every n ≤ 4
// is bound by bytes: at T = 100 and B = 262,144 the unicycle's 2.3 GB take
// 0.693 ms at 3.35 TB/s, the cartpole's at T = 50 and B = 16,384 0.037
// ms.  Below ~10,000 lanes no rate binds: one solve's chain of T dependent
// steps does (a 3x3 factor, four solves, DS, ĀᵀDS·Ā and the risk term).
// The few-lane teams shorten that chain by splitting the solves and
// products over K = 4 lanes, and spread a narrow bank (RAT iLQR's B = 10)
// over four times the warps (PERF.md §6).
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
#include <cstdint>
#include <type_traits>

#include "dp_step.cuh"
#include "dtype.cuh"
#include "small_launch.cuh"
#include "small_team.cuh"
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

using rq::small::sm_count;
using rq::small::small_lanes;
using rq::small::small_threads;
using rq::team::kTeamLanes;
using rq::team::kTeams;
using rq::team::Noise;
using rq::team::Nothing;
using rq::team::read_lane;
constexpr int kBuffers = RQ_STAGE_BUFFERS;
static_assert(kBuffers == 1 || kBuffers == 2, "one or two staging buffers");

struct FoldedArgs {
  int B, T, w_shared;
  const void *q, *q_vec, *Q, *A, *W, *W_inv, *logdet_W;
  const void *q_term, *q_vec_term, *Q_term, *theta;
  void* value;
  bool* m_fail;
};

// ---- One solve per thread (N ≤ kUnrollMax above the 4-lane band; kTeamLanes ≤ N) ----

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

// The n a team takes: past the few-lane kernel's unrolled algebra, with a
// lane for every row of M and one more for M⁻¹s⃗ (team::m_factor).
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

// ---- One solve per team of 4 lanes (N ≤ kUnrollMax, the 4-lane band) ----

// The n a few-lane team takes: every matrix of the step in registers.
template <int N>
constexpr bool kSmallShape = N <= rq::kUnrollMax;

// Lanes a solve of the few-lane kernel: small_launch.cuh's K = 4 band.
// Above it (K = 1) the launch takes riccati_folded_kernel, one solve per
// thread, the same algebra with its risk term rounded alike: the same
// bits at n ≤ 3, the value within an ulp at n = 4 (nvcc fuses a product
// of the carry otherwise), and no slower (PERF.md §6).
constexpr int kSmallLanes = 4;

// Blocks an SM whose registers ptxas must leave room for in the few-lane
// kernel (__launch_bounds__' minimum): in float32 kSmallFill threads an
// SM, the whole K = 4 band of small_lanes, so the bank is resident in one
// wave; in float64 one block (108-238 registers a thread, no spills).
template <typename T>
constexpr int kMinBlocks =
    sizeof(T) > 4 ? 1 : rq::small::kSmallFill / small_threads(kSmallLanes);

// The same pass as riccati_folded_kernel, one solve per team of
// kSmallLanes lanes of a warp, on rq::small::folded_step with its risk
// term rounded, as the one-solve-per-thread kernel's.
// Every lane holds the carry and θ and reads the step's blocks into
// registers; the lanes split the solves and products of the step.  A team
// past the bank reads lane B − 1 and keeps every shuffle.
template <typename T, int N, bool WLANE>
__global__ void __launch_bounds__(small_threads(kSmallLanes), kMinBlocks<T>)
    riccati_folded_small_kernel(const FoldedArgs a) {
  constexpr int K = kSmallLanes, Solves = small_threads(K) / K;
  const int lane = threadIdx.x % K, k = threadIdx.x / K;
  const int b0 = blockIdx.x * Solves;
  const bool live = b0 + k < a.B;   // a team past the bank stores nothing
  const int64_t B = a.B, b = live ? b0 + k : a.B - 1;
  const auto in = [](const void* p) { return static_cast<const T*>(p); };

  // Terminal carry and θ, on every lane.
  T s = in(a.q_term)[b], sv[N], S[N][N];
  read_lane<N>(sv, in(a.q_vec_term), 0, B, b);
  read_lane<N * N>(&S[0][0], in(a.Q_term), 0, B, b);
  const T theta = in(a.theta)[b];
  bool m_fail = false;

  for (int t = a.T - 1; t >= 0; --t) {
    StepIn<T, N, true> x;   // the step's blocks and noise model
    x.q = in(a.q)[t * B + b];
    read_lane<N>(x.qv, in(a.q_vec), t, B, b);
    read_lane<N * N>(&x.Q[0][0], in(a.Q), t, B, b);
    read_lane<N * N>(&x.A[0][0], in(a.A), t, B, b);
    // A shared noise model: one (T, n, n) buffer, read as a bank of one lane.
    const int64_t wB = WLANE ? B : 1, wb = WLANE ? b : 0;
    read_lane<N * N>(&x.noise.W[0][0], in(a.W), t, wB, wb);
    read_lane<N * N>(&x.noise.Wi[0][0], in(a.W_inv), t, wB, wb);
    x.noise.ldW = in(a.logdet_W)[t * wB + wb];
    rq::small::folded_step<T, N, K, true>(lane, x.q, x.qv, x.Q, x.A, x.noise.W, x.noise.Wi,
                                          x.noise.ldW, theta, s, sv, S, m_fail);
  }
  if (live && lane == 0) {
    static_cast<T*>(a.value)[b] = s;   // the t = 0 value
    a.m_fail[b] = m_fail;
  }
}

// Dynamic shared memory of one team-kernel block.
template <typename T, int N, bool WLANE>
constexpr int team_smem_bytes() {
  return int(sizeof(FoldedBlock<T, N, WLANE, kTeams>));
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

template <typename T, int N, bool WLANE>
cudaError_t launch_small(const FoldedArgs& a, cudaStream_t stream) {
  constexpr int threads = small_threads(kSmallLanes), solves = threads / kSmallLanes;
  const auto kernel = riccati_folded_small_kernel<T, N, WLANE>;
  kernel<<<(a.B + solves - 1) / solves, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

// Threads a block of the one-solve-per-thread kernel.
constexpr int kThreadBlock = 128;

template <typename T, int N>
cudaError_t launch_thread(const FoldedArgs& a, cudaStream_t stream) {
  const auto kernel = riccati_folded_kernel<T, N>;
  kernel<<<(a.B + kThreadBlock - 1) / kThreadBlock, kThreadBlock, 0, stream>>>(a);
  return cudaGetLastError();
}

// f(std::integral_constant<bool, WLANE>) for the noise model (WLANE: per
// lane) chosen at run time.
template <typename F>
int with_noise(int w_shared, F f) {
  using std::integral_constant;
  return w_shared ? f(integral_constant<bool, false>{}) : f(integral_constant<bool, true>{});
}

// At n ≤ kUnrollMax one solve per team of kSmallLanes lanes while
// small_lanes(B, SMs) takes 4, one per thread above; one per team of
// kTeamLanes for the n a team takes; one per thread otherwise.
template <typename T, int N>
int launch(const FoldedArgs& a, cudaStream_t stream) {
  if constexpr (kTeamShape<N>) {
    return with_noise(a.w_shared, [&](auto wlane) {
      return int(launch_team<T, N, decltype(wlane)::value>(a, stream));
    });
  } else {
    if constexpr (kSmallShape<N>) {
      if (small_lanes(a.B, sm_count()) == kSmallLanes)
        return with_noise(a.w_shared, [&](auto wlane) {
          return int(launch_small<T, N, decltype(wlane)::value>(a, stream));
        });
    }
    return int(launch_thread<T, N>(a, stream));
  }
}

// The launch at n for a bank of B lanes on the current device with a
// shared or per-lane noise model: returns its dynamic shared memory a
// block and sets its solves (teams) a block and lanes a solve.
template <typename T, int N>
int launch_shape(int B, int w_shared, int* solves, int* lanes) {
  if constexpr (kSmallShape<N>) {
    if (small_lanes(B, sm_count()) == kSmallLanes) {
      *solves = small_threads(kSmallLanes) / kSmallLanes;
      *lanes = kSmallLanes;
      return 0;
    }
  } else if constexpr (kTeamShape<N>) {
    *solves = kTeams;
    *lanes = kTeamLanes;
    return with_noise(w_shared,
                      [&](auto wlane) { return team_smem_bytes<T, N, decltype(wlane)::value>(); });
  }
  *solves = kThreadBlock;
  *lanes = 1;
  return 0;
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
    return launch<Real, D::N>(a, static_cast<cudaStream_t>(stream));
  });
}

// The launch of kernel D at n for a bank of B lanes on the current device
// with a shared or per-lane noise model: returns the dynamic shared memory
// a block takes (-1 for an n not instantiated) and sets its solves (teams)
// a block and lanes a solve.
extern "C" int RQ_ENTRY(ratilqr_riccati_folded_smem)(int n, int B, int w_shared,
                                                     int* teams_per_block, int* lanes_per_team) {
  return with_dim(n, [&](auto dim) {
    using D = decltype(dim);
    return launch_shape<Real, D::N>(B, w_shared, teams_per_block, lanes_per_team);
  });
}
