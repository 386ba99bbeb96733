// Kernel A: the batched risk-sensitive Riccati backward pass.
//
// Replaces ratilqr_tpu/ops/riccati_pallas.py:_riccati_kernel (:193),
// reached through riccati_bank (:382), its pallas_call at :541.  Every
// static variant of the Pallas kernel is here: optimizing or evaluating
// (template OPT), slim or full outputs, lane-invariant or per-lane noise
// model (a template too where a team stages it), with or without a dl
// stream (runtime flags, uniform across the grid).  A CUDA grid gives no
// order between blocks, so unlike the Pallas grid (tiles, T) time is never
// a grid axis: each solve runs its T-step backward loop in one team or
// thread, the value-function carry (s, s⃗, S) and the latched fail flags
// with it.  Per-lane arrays are lane-minor, (T, ..., B), so neighbouring
// solves read neighbouring words; a shared noise model is one (T, n, n)
// buffer (the TPU kept it in SMEM).
//
// Three designs, chosen per shape at compile time (launch()):
//
// One solve per team of K lanes of a warp (n, m ≤ kUnrollMax: the
// unicycle (3, 2), LQR (2, 2), the cartpole (4, 1), and such shapes built
// at first use; riccati_small_kernel on small_team.cuh's dp_step, both
// passes), K = 4 or 1 by small_launch.cuh's rule (4 while the bank stays
// within 512 threads an SM, B ≤ 16,896 on 132 SMs).  Every lane holds the
// carry, θ and μ and reads the step's blocks; lane r takes the solves with
// M's factor for columns r, r + K, ... of M⁻¹[S | s⃗] and (optimizing)
// with H's factor for the same columns of −H⁻¹[G | g], the rows r, r + K,
// ... of DS, AᵀDS·A and the carry's update, and stores entries r, r + K,
// ... of every output; the rows go round by __shfl_sync(width = K).  A
// block is 128 threads where K > 1 and 64 at K = 1.  A step's streamed
// blocks (q, q⃗, Q, r, R, P, A, B; evaluating: L_t, dl_t; a per-lane
// noise model: W_t, W⁻¹_t, logdet W_t) come in one of two forms:
//   - read from device memory into registers at the top of the step: at
//     K = 4 while the bank stays within 256 threads an SM (B ≤ 8,448 on
//     132 SMs, small_direct), and at K = 1;
//   - staged by cp.async in two shared buffers (a solve's step padded to
//     an odd number of words, so a warp's solves read distinct banks), one
//     block barrier a step, the copies of step t − 1 in flight while the
//     teams run step t, each block read where the step uses it: at K = 4
//     above 256 threads an SM, and at every width where a step would take
//     more than kStepRegisters registers (float64 (4, 1)).
// value, m_fail and h_fail are written by lane 0.  The risk term's last
// product and difference are rounded on their own (small_team.cuh:
// risk_term): nvcc fused them or not with the code around the step, and
// K = 1 and K = 4 then gave the cartpole's values different bits.  Every
// K and form gives the same bits.
//
// One solve per team of 16 lanes (riccati_team_kernel; kUnrollMax < n,
// m ≤ kUnrollMax and n + m ≤ kTeamLanes: the quadrotor (12, 4), and
// shapes such as (6, 3) built at first use): the same recursion spread
// over a team of 16 lanes (two teams a warp) with rq::team::dp_step
// (team_mat.cuh), optimizing or evaluating, K = kTeams = 8 teams a block
// on 8 consecutive lanes b (team_stage.cuh).  Each team keeps its working
// set in shared memory: the carry (s⃗, S), dp_step's scratch and outputs
// (L, dl, g, G, H), θ and μ, and the step's streamed blocks, which the
// block stages from the lane-minor inputs in one coalesced pass a step.
// With kBuffers = 2 the streamed blocks are double-buffered: while the
// teams run step t, the block's cp.async copies bring step t − 1 into the
// other buffer.  The per-step outputs (L, dl; full: s, s⃗, S, g, G, H)
// leave in one coalesced pass at the top of the next step.  Two block
// barriers a step.
//
// One solve per thread (riccati_kernel): the shapes neither team takes
// (m > 4, or n > 4 with n + m > 16), their loops rolled above kUnrollMax
// so their n x n arrays live in the stack frame; ops/riccati_cuda.py:
// MAX_DIM is the largest n measured to build and agree.
//
// In every design a team (thread) past the end of the bank reads lane
// B − 1, keeps every barrier and shuffle and stores nothing.
//
// Bound on the H100 (kernel_check.bound_ms: the function's bytes, each
// input read once and each output written once, over 3.35 TB/s, against
// the DP's arithmetic over 67 TFLOP/s), f32, slim optimizing pass: the
// unicycle streams 40 words a lane and step in and 8 out against 652
// operations, 1.508 ms at T = 100 and B = 262,144, 0.094 ms at 16,384,
// 0.0016 ms at T = 30 and B = 942; the cartpole 47 in and 5 out against
// 953 operations, 0.051 ms at T = 50 and B = 16,384, 0.821 ms at
// 262,144; every shape is bound by bytes (the evaluating pass reads L_t
// and writes no gains: 2-4% less).  Below ~10,000 lanes no rate binds:
// one solve's dependent chain of T steps does.
//
// What held the one-solve-per-thread design back at n ≤ 4, and what the
// few-lane teams do about it (launch alone, f32, H100 80GB HBM3 at 700 W,
// the parent in the same call by python -m ratilqr_tpu_torch.team_sweep
// riccati --baseline; PERF.md §6):
//   - narrow banks (RAT iLQR++'s 1-942 lanes and 120-2,004, the fleets'
//     64-640): one warp paid each step's chain in turn (M's and H's
//     factors, their solves, divisions, square roots and logs).  Four
//     lanes a solve split the longest parts (the N + 1 solves with each
//     factor) and spread the bank over four times the warps: unicycle
//     T = 100, B = 10-8,448, 0.43-0.46 against 0.78-0.83 ms; T = 30 0.18-
//     0.21 against 0.28-0.32; cartpole B = 10-8,448 0.30-0.39 against
//     0.48-0.56; B = 1 (T = 100) 0.22-0.23 against 0.31-0.32.
//   - B = 8,449-16,896 (K = 4 above 256 threads an SM): read into
//     registers, a thread takes 140-168 registers (f32) and the SMs hold
//     too few of the bank's warps; staged, 60-96: unicycle T = 100,
//     B = 16,384 0.70-0.73 against 0.84-0.85 ms, cartpole 0.49-0.50
//     against 0.56-0.59 (reading into registers there: 0.69-0.74).
//   - B > 16,896: the card is full of warps and the step is issue-bound,
//     as for kernels B and C; K = 1 reads into registers, the per-thread
//     algorithm in rq::small's order: a tie (unicycle T = 100, B =
//     262,144 3.86-3.96 against 3.93-3.96 ms, cartpole 3.25-3.26 against
//     3.17-3.31).  Staging at K = 1 lost 22-45% on the unicycle at
//     B = 262,144 (a tie on the cartpole); reading a step ahead into
//     registers lost 30% there and tied or lost at K = 4; K = 4 staged
//     at B = 262,144 took 7.5 ms on the unicycle against K = 1's 3.9.
//
// At n=12, m=4 (the quadrotor) a step streams 417 words in and 52 out
// (1.9 KB per lane in f32) against ~22,600 operations: at B = 16,384 and
// T = 50 that is 1.55 GB (0.46 ms) against 1.85e10 operations (0.28 ms),
// still bound by bytes on paper.  One solve per thread held S, A, Q, W, W⁻¹,
// M and D at 144 words each, far above the 255-register cap, in an 8.8 KB
// stack frame whose local-memory traffic, not the streamed blocks, set
// the time: hence the 16-lane team design.
#include <cstdint>
#include <type_traits>

#include "dp_step.cuh"
#include "dtype.cuh"
#include "small_launch.cuh"
#include "small_team.cuh"
#include "team_mat.cuh"
#include "team_stage.cuh"

// Buffers of a team's streamed blocks: 1 stages each step synchronously
// after the barrier that frees the buffer; 2 copies step t − 1 by cp.async
// while the teams compute step t (on an H100 80GB HBM3 at 700 W, 3-7%
// faster in f32 and 12% in f64 on the quadrotor, PERF.md §6).
// -DRQ_STAGE_BUFFERS=.. builds the other form for
// python -m ratilqr_tpu_torch.team_sweep riccati to time.
#ifndef RQ_STAGE_BUFFERS
#define RQ_STAGE_BUFFERS 2
#endif

// How a few-lane team (n, m ≤ kUnrollMax) gets each step's streamed
// blocks: 2 (shipped) by the launch's rule (small_launch.cuh:small_direct
// and kStageAlways below); 0 read from device memory into registers at the
// top of every step; 1 staged in shared memory by cp.async,
// double-buffered.  -DRQ_STEP_FORM=0|1 build the variants python -m
// ratilqr_tpu_torch.team_sweep riccati times.
#ifndef RQ_STEP_FORM
#define RQ_STEP_FORM 2
#endif

namespace {

using rq::small::sm_count;
using rq::small::small_direct;
using rq::small::small_lanes;
using rq::small::small_threads;
using rq::small::with_lanes;
using rq::team::kTeamLanes;
using rq::team::kTeams;
using rq::team::Noise;
using rq::team::Nothing;
using rq::team::read_lane;
constexpr int kBuffers = RQ_STAGE_BUFFERS;
static_assert(kBuffers == 1 || kBuffers == 2, "one or two staging buffers");
static_assert(RQ_STEP_FORM >= 0 && RQ_STEP_FORM <= 2,
              "a step's blocks are read from device memory, staged, or by the rule");

struct RiccatiArgs {
  int B, T, slim, w_shared, has_dl;
  const void *q, *q_vec, *Q, *r, *R, *P, *A, *Bm, *W, *W_inv, *logdet_W;
  const void *q_term, *q_vec_term, *Q_term, *theta, *mu, *L_in, *dl_in;
  void *value, *s, *s_vec, *S, *g, *G, *H, *L, *dl;
  bool *m_fail, *h_fail;
};

template <typename T, int N, int M, bool OPT>
__global__ void __launch_bounds__(128) riccati_kernel(const RiccatiArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int64_t B = a.B;
  const T* q = static_cast<const T*>(a.q);
  const T* q_vec = static_cast<const T*>(a.q_vec);
  const T* Qs = static_cast<const T*>(a.Q);
  const T* r_ = static_cast<const T*>(a.r);
  const T* Rs = static_cast<const T*>(a.R);
  const T* Ps = static_cast<const T*>(a.P);
  const T* As = static_cast<const T*>(a.A);
  const T* Bs = static_cast<const T*>(a.Bm);
  const T* Ws = static_cast<const T*>(a.W);
  const T* Wis = static_cast<const T*>(a.W_inv);
  const T* ldWs = static_cast<const T*>(a.logdet_W);
  const T* L_in = static_cast<const T*>(a.L_in);
  const T* dl_in = static_cast<const T*>(a.dl_in);

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
  const T mu = static_cast<const T*>(a.mu)[b];
  bool m_fail = false, h_fail = false;

  for (int t = a.T - 1; t >= 0; --t) {
    T qt = q[t * B + b], qv[N], Q[N][N], r[M], R[M][M], P[M][N], A[N][N], Bm[N][M];
    T W[N][N], Wi[N][N], ldW, L[M][N], dl[M], g[M], G[M][N], H[M][M];
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
#pragma unroll (rq::Unroll<M>::value)
      for (int j = 0; j < M; ++j) Bm[i][j] = Bs[((int64_t(t) * N + i) * M + j) * B + b];
    }
    ldW = a.w_shared ? ldWs[t] : ldWs[t * B + b];
#pragma unroll (rq::Unroll<M>::value)
    for (int i = 0; i < M; ++i) {
      r[i] = r_[(t * M + i) * B + b];
#pragma unroll (rq::Unroll<M>::value)
      for (int j = 0; j < M; ++j) R[i][j] = Rs[((int64_t(t) * M + i) * M + j) * B + b];
#pragma unroll (rq::Unroll<N>::value)
      for (int j = 0; j < N; ++j) P[i][j] = Ps[((int64_t(t) * M + i) * N + j) * B + b];
    }
    if (!OPT) {
#pragma unroll (rq::Unroll<M>::value)
      for (int i = 0; i < M; ++i) {
        dl[i] = a.has_dl ? dl_in[(t * M + i) * B + b] : T(0);
#pragma unroll (rq::Unroll<N>::value)
        for (int j = 0; j < N; ++j) L[i][j] = L_in[((int64_t(t) * M + i) * N + j) * B + b];
      }
    }

    rq::dp_step<T, N, M, OPT>(qt, qv, Q, r, R, P, A, Bm, W, Wi, ldW, theta, mu, L, dl, g, G,
                              H, s, sv, S, m_fail, h_fail);

    if (OPT || !a.slim) {
      T* Lo = static_cast<T*>(a.L);
      T* dlo = static_cast<T*>(a.dl);
#pragma unroll (rq::Unroll<M>::value)
      for (int i = 0; i < M; ++i) {
        dlo[(t * M + i) * B + b] = dl[i];
#pragma unroll (rq::Unroll<N>::value)
        for (int j = 0; j < N; ++j) Lo[((int64_t(t) * M + i) * N + j) * B + b] = L[i][j];
      }
    }
    if (!a.slim) {
      static_cast<T*>(a.s)[t * B + b] = s;
#pragma unroll (rq::Unroll<N>::value)
      for (int i = 0; i < N; ++i) {
        static_cast<T*>(a.s_vec)[(t * N + i) * B + b] = sv[i];
#pragma unroll (rq::Unroll<N>::value)
        for (int j = 0; j < N; ++j)
          static_cast<T*>(a.S)[((int64_t(t) * N + i) * N + j) * B + b] = S[i][j];
      }
#pragma unroll (rq::Unroll<M>::value)
      for (int i = 0; i < M; ++i) {
        static_cast<T*>(a.g)[(t * M + i) * B + b] = g[i];
#pragma unroll (rq::Unroll<N>::value)
        for (int j = 0; j < N; ++j)
          static_cast<T*>(a.G)[((int64_t(t) * M + i) * N + j) * B + b] = G[i][j];
#pragma unroll (rq::Unroll<M>::value)
        for (int j = 0; j < M; ++j)
          static_cast<T*>(a.H)[((int64_t(t) * M + i) * M + j) * B + b] = H[i][j];
      }
    }
  }
  static_cast<T*>(a.value)[b] = s;  // the t = 0 value
  a.m_fail[b] = m_fail;
  a.h_fail[b] = h_fail;
}

// ---- One solve per team (kUnrollMax < N, M ≤ kUnrollMax, N + M ≤ kTeamLanes) ----

// The shapes a team takes: past the per-thread kernel's unrolled algebra,
// with H small enough for every lane to factor in registers and a lane for
// every row of AᵀDS and of BᵀDS (team::dp_step).
template <int N, int M>
constexpr bool kTeamShape = N > rq::kUnrollMax && M <= rq::kUnrollMax && N + M <= kTeamLanes;

// The model blocks of one step, streamed from device memory.
template <typename T, int N, int M>
struct Blocks {
  T Q[N][N], A[N][N], Bm[N][M], P[M][N], R[M][M], qv[N], r[M], q;
};

// The evaluating pass's policy at one step.
template <typename T, int N, int M>
struct Policy {
  T L[M][N], dl[M];
};

// What a team stages each step: the blocks, the policy when evaluating
// (not OPT) and the noise model when it is per lane (WLANE).
template <typename T, int N, int M, bool OPT, bool WLANE>
struct StepIn {
  Blocks<T, N, M> m;
  std::conditional_t<OPT, Nothing<0>, Policy<T, N, M>> pol;
  std::conditional_t<WLANE, Noise<T, N>, Nothing<1>> noise;
};

// One team's working set: the streamed blocks (kBuffers of them), the
// carry (s, s⃗, S), dp_step's scratch and outputs, θ and μ.
template <typename T, int N, int M, bool OPT, bool WLANE>
struct RiccatiTeam {
  StepIn<T, N, M, OPT, WLANE> in[kBuffers];
  T S[N][N];
  rq::team::DpScratch<T, N, M> d;
  T L[M][N], G[M][N], H[M][M];
  T sv[N], g[M], dl[M], s, theta, mu;
};

// A block's shared memory: its K teams and, when the noise model is
// shared, the block's own kBuffers copies of it.
template <typename T, int N, int M, bool OPT, bool WLANE, int K>
struct RiccatiBlock {
  std::conditional_t<WLANE, Nothing<2>, Noise<T, N>[kBuffers]> noise;
  RiccatiTeam<T, N, M, OPT, WLANE> team[K];
};

// Step t of a lane-minor (T, C, B) array, src, into dst for the block's
// live lanes (zeros for a null src): the evaluating full pass writes its
// input policy out, as riccati_kernel does.
template <int C, int K, typename T>
__device__ __forceinline__ void copy_lanes(T* dst, const T* src, int t, int64_t B, int b0) {
  for (int idx = threadIdx.x; idx < C * K; idx += blockDim.x) {
    const int k = idx % K, c = idx / K;
    const int64_t e = (int64_t(t) * C + c) * B + b0 + k;
    if (b0 + k < B) dst[e] = src ? src[e] : T(0);
  }
}

// The same pass as riccati_kernel, one solve per team.  The register
// budget is that of the blocks the shared memory lets an SM hold, but no
// less than the 80 registers a thread (160 in f64) kernel B's team step
// takes.
template <typename T, int N, int M, bool OPT, bool WLANE, int Lanes, int K>
__global__ void __launch_bounds__(
    Lanes * K, rq::team::resident_blocks(sizeof(RiccatiBlock<T, N, M, OPT, WLANE, K>), Lanes * K,
                                         20 * int(sizeof(T))))
    riccati_team_kernel(const RiccatiArgs a) {
  using Team = RiccatiTeam<T, N, M, OPT, WLANE>;
  using In = StepIn<T, N, M, OPT, WLANE>;
  using rq::team::stage;
  using rq::team::stage_into;
  using rq::team::unstage;
  constexpr bool kAsync = kBuffers == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<RiccatiBlock<T, N, M, OPT, WLANE, K>*>(smem_raw);
  const int lane = threadIdx.x % Lanes, k = threadIdx.x / Lanes;
  const int b0 = blockIdx.x * K, b = b0 + k;
  const int64_t B = a.B;
  Team& tm = sm.team[k];
  const auto in = [](const void* p) { return static_cast<const T*>(p); };
  const auto out = [](void* p) { return static_cast<T*>(p); };

  // Step t's streamed blocks into buffer j of every team (and of the
  // block, for a shared noise model).
  const auto fetch = [&](int t, int j) {
    const auto x = [&](int i) -> In& { return sm.team[i].in[j]; };
    stage_into<1, K, kAsync>(in(a.q), t, B, b0, [&](int i) { return &x(i).m.q; });
    stage_into<N, K, kAsync>(in(a.q_vec), t, B, b0, [&](int i) { return x(i).m.qv; });
    stage_into<N * N, K, kAsync>(in(a.Q), t, B, b0, [&](int i) { return &x(i).m.Q[0][0]; });
    stage_into<M, K, kAsync>(in(a.r), t, B, b0, [&](int i) { return x(i).m.r; });
    stage_into<M * M, K, kAsync>(in(a.R), t, B, b0, [&](int i) { return &x(i).m.R[0][0]; });
    stage_into<M * N, K, kAsync>(in(a.P), t, B, b0, [&](int i) { return &x(i).m.P[0][0]; });
    stage_into<N * N, K, kAsync>(in(a.A), t, B, b0, [&](int i) { return &x(i).m.A[0][0]; });
    stage_into<N * M, K, kAsync>(in(a.Bm), t, B, b0, [&](int i) { return &x(i).m.Bm[0][0]; });
    if constexpr (!OPT) {
      stage_into<M * N, K, kAsync>(in(a.L_in), t, B, b0,
                                   [&](int i) { return &x(i).pol.L[0][0]; });
      if (a.has_dl)
        stage_into<M, K, kAsync>(in(a.dl_in), t, B, b0, [&](int i) { return x(i).pol.dl; });
    }
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

  // Step t's outputs from every team.
  const auto store = [&](int t) {
    if constexpr (OPT) {
      unstage<M * N>(out(a.L), t, B, b0, sm.team, &Team::L);
      unstage<M>(out(a.dl), t, B, b0, sm.team, &Team::dl);
    } else if (!a.slim) {
      copy_lanes<M * N, K>(out(a.L), in(a.L_in), t, B, b0);
      copy_lanes<M, K>(out(a.dl), a.has_dl ? in(a.dl_in) : nullptr, t, B, b0);
    }
    if (!a.slim) {
      unstage<1>(out(a.s), t, B, b0, sm.team, &Team::s);
      unstage<N>(out(a.s_vec), t, B, b0, sm.team, &Team::sv);
      unstage<N * N>(out(a.S), t, B, b0, sm.team, &Team::S);
      unstage<M>(out(a.g), t, B, b0, sm.team, &Team::g);
      unstage<M * N>(out(a.G), t, B, b0, sm.team, &Team::G);
      unstage<M * M>(out(a.H), t, B, b0, sm.team, &Team::H);
    }
  };

  // Terminal carry, θ and μ; without a dl stream the evaluating offsets
  // are zero in every buffer.
  stage<N * N>(in(a.Q_term), 0, B, b0, sm.team, &Team::S);
  stage<N>(in(a.q_vec_term), 0, B, b0, sm.team, &Team::sv);
  stage<1>(in(a.q_term), 0, B, b0, sm.team, &Team::s);
  stage<1>(in(a.theta), 0, B, b0, sm.team, &Team::theta);
  stage<1>(in(a.mu), 0, B, b0, sm.team, &Team::mu);
  if constexpr (!OPT) {
    if (!a.has_dl)
      for (int idx = threadIdx.x; idx < K * kBuffers * M; idx += blockDim.x)
        sm.team[idx / (kBuffers * M)].in[idx / M % kBuffers].pol.dl[idx % M] = T(0);
  }
  if (kAsync && a.T > 0) {
    fetch(a.T - 1, 0);
    __pipeline_commit();
  }
  __syncthreads();
  T s = tm.s;   // lane 0's
  const T theta = tm.theta, mu = tm.mu;
  bool m_fail = false, h_fail = false;
  int cur = 0;
  for (int t = a.T - 1; t >= 0; --t) {
    __syncthreads();   // step t + 1 is done: its outputs and its buffer are free
    if (t + 1 < a.T) store(t + 1);
    if constexpr (kAsync) {
      if (t > 0) {
        fetch(t - 1, 1 - cur);
        __pipeline_commit();
        __pipeline_wait_prior(1);   // step t's copies, not step t − 1's
      } else {
        __pipeline_wait_prior(0);
      }
    } else {
      fetch(t, 0);
    }
    __syncthreads();
    In& x = tm.in[cur];
    const Noise<T, N>& nz = [&]() -> const Noise<T, N>& {
      if constexpr (WLANE)
        return x.noise;
      else
        return sm.noise[cur];
    }();
    T(&Lg)[M][N] = [&]() -> T(&)[M][N] {
      if constexpr (OPT)
        return tm.L;
      else
        return x.pol.L;
    }();
    T(&dl)[M] = [&]() -> T(&)[M] {
      if constexpr (OPT)
        return tm.dl;
      else
        return x.pol.dl;
    }();
    rq::team::dp_step<T, N, M, Lanes, OPT>(lane, x.m.q, x.m.qv, x.m.Q, x.m.r, x.m.R, x.m.P,
                                           x.m.A, x.m.Bm, nz.W, nz.Wi, nz.ldW, theta, mu, Lg,
                                           dl, tm.g, tm.G, tm.H, s, tm.sv, tm.S, m_fail,
                                           h_fail, tm.d);
    if (lane == 0) tm.s = s;
    if constexpr (kAsync) cur = 1 - cur;
  }
  __syncthreads();
  if (a.T > 0) store(0);
  if (b < a.B && lane == 0) {
    out(a.value)[b] = s;   // the t = 0 value
    a.m_fail[b] = m_fail;
    a.h_fail[b] = h_fail;
  }
}

// ---- One solve per team of K lanes (N, M ≤ kUnrollMax) ----

// The shapes the few-lane teams take: every loop of the algebra unrolled,
// every matrix in registers.
template <int N, int M>
constexpr bool kSmallShape = N <= rq::kUnrollMax && M <= rq::kUnrollMax;

// A solve's staged step: its blocks, the policy when evaluating and a
// per-lane noise model (StepIn), padded to an odd number of words of T so
// that the solves of a warp, which read one address each, and the
// block's staging copies, which write one word a solve, fall in distinct
// banks.
template <typename In, typename T>
struct OddStride {
  In in;
  T pad[(sizeof(In) / sizeof(T)) % 2 == 0 ? 1 : 2];
};

// One staged step for a block's S solves, and a shared noise model once.
template <typename T, int N, int M, bool OPT, bool WLANE, int S>
struct SmallStep {
  std::conditional_t<WLANE, Nothing<2>, Noise<T, N>> noise;
  OddStride<StepIn<T, N, M, OPT, WLANE>, T> solve[S];
};
// Staged steps: step t in buffer t % kSmallBuffers.
constexpr int kSmallBuffers = 2;

// One step's inputs in a lane's registers: the blocks, the policy (the
// optimizing pass's output) and the noise model.
template <typename T, int N, int M>
struct StepRegs {
  Blocks<T, N, M> m;
  T L[M][N], dl[M], W[N][N], Wi[N][N], ldW;
};

// Whether a step is always staged: where its words (the blocks, the
// policy when evaluating, the noise model) would take more than
// kStepRegisters of a thread's 255 registers.  Read into registers, the
// float64 (4, 1) step (160-170 registers) spilled 110-150 B at K = 1 and
// 66-128 B at K = 4; float64 (3, 2) (118-134) and every float32 step
// (at most 90) did not.
constexpr int kStepRegisters = 144;
template <typename T, int N, int M, bool OPT>
constexpr bool kStageAlways =
    (sizeof(Blocks<T, N, M>) + (OPT ? 0 : sizeof(Policy<T, N, M>)) + sizeof(Noise<T, N>)) >
    kStepRegisters * 4;

// Whether the build can stage a step at K lanes a solve, and read one
// into registers (the launch's rule stages only at K > 1).
template <typename T, int N, int M, bool OPT, int K>
constexpr bool kMayStage =
    RQ_STEP_FORM == 1 || kStageAlways<T, N, M, OPT> || (RQ_STEP_FORM == 2 && K > 1);
template <typename T, int N, int M, bool OPT>
constexpr bool kMayRead = RQ_STEP_FORM != 1 && !kStageAlways<T, N, M, OPT>;

// Lane `lane` of a team of K stores entries lane, lane + K, ... of v into
// step t of a lane-minor (T, C, B) array at lane b (a live team only).
template <int C, int K, typename T>
__device__ __forceinline__ void write_lane(T* dst, const T* v, int t, int64_t B, int64_t b,
                                           int lane, bool live) {
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (live && c % K == lane) dst[(int64_t(t) * C + c) * B + b] = v[c];
}

// The same pass as riccati_kernel, one solve per team of K lanes of a
// warp (K = 1: one per thread), on rq::small::dp_step (its risk term
// rounded, so that every K and form gives the same bits).  Every lane
// holds the carry, θ and μ and reads the step's blocks; the lanes split
// the solves and products of the DP step and the stores of its outputs.
// A step's blocks come from device memory into registers at the top of
// the step, or (STAGED) by cp.async into one of two shared buffers behind
// the block's one barrier a step, while the teams run the step before,
// and are read from there where the step uses them.  Every team, live or
// not, keeps every barrier and shuffle.
template <typename T, int N, int M, bool OPT, bool WLANE, int K, bool STAGED>
__global__ void __launch_bounds__(small_threads(K)) riccati_small_kernel(const RiccatiArgs a) {
  constexpr int Threads = small_threads(K), Solves = Threads / K;
  constexpr int Cols = rq::small::kSlots<N + 1, K>;
  using Step = SmallStep<T, N, M, OPT, WLANE, Solves>;
  using In = StepIn<T, N, M, OPT, WLANE>;
  using rq::team::stage_into;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Step* st = reinterpret_cast<Step*>(smem_raw);   // kSmallBuffers steps when staged
  const int lane = threadIdx.x % K, k = threadIdx.x / K;
  const int b0 = blockIdx.x * Solves;
  const bool live = b0 + k < a.B;   // a team past the bank stores nothing
  const int64_t B = a.B, b = live ? b0 + k : a.B - 1;
  const auto in = [](const void* p) { return static_cast<const T*>(p); };
  const auto out = [](void* p) { return static_cast<T*>(p); };

  // Step t's blocks into its buffer by cp.async, as one batch.
  const auto fetch = [&](int t) {
    Step& d = st[t % kSmallBuffers];
    const auto x = [&](int i) -> In& { return d.solve[i].in; };
    stage_into<1, Solves, true>(in(a.q), t, B, b0, [&](int i) { return &x(i).m.q; });
    stage_into<N, Solves, true>(in(a.q_vec), t, B, b0, [&](int i) { return x(i).m.qv; });
    stage_into<N * N, Solves, true>(in(a.Q), t, B, b0, [&](int i) { return &x(i).m.Q[0][0]; });
    stage_into<M, Solves, true>(in(a.r), t, B, b0, [&](int i) { return x(i).m.r; });
    stage_into<M * M, Solves, true>(in(a.R), t, B, b0, [&](int i) { return &x(i).m.R[0][0]; });
    stage_into<M * N, Solves, true>(in(a.P), t, B, b0, [&](int i) { return &x(i).m.P[0][0]; });
    stage_into<N * N, Solves, true>(in(a.A), t, B, b0, [&](int i) { return &x(i).m.A[0][0]; });
    stage_into<N * M, Solves, true>(in(a.Bm), t, B, b0,
                                    [&](int i) { return &x(i).m.Bm[0][0]; });
    if constexpr (!OPT) {
      stage_into<M * N, Solves, true>(in(a.L_in), t, B, b0,
                                      [&](int i) { return &x(i).pol.L[0][0]; });
      if (a.has_dl)
        stage_into<M, Solves, true>(in(a.dl_in), t, B, b0, [&](int i) { return x(i).pol.dl; });
    }
    if constexpr (WLANE) {
      stage_into<N * N, Solves, true>(in(a.W), t, B, b0,
                                      [&](int i) { return &x(i).noise.W[0][0]; });
      stage_into<N * N, Solves, true>(in(a.W_inv), t, B, b0,
                                      [&](int i) { return &x(i).noise.Wi[0][0]; });
      stage_into<1, Solves, true>(in(a.logdet_W), t, B, b0,
                                  [&](int i) { return &x(i).noise.ldW; });
    } else {
      rq::team::stage_noise<N, true>(d.noise.W, d.noise.Wi, d.noise.ldW, in(a.W), in(a.W_inv),
                                     in(a.logdet_W), t);
    }
    __pipeline_commit();
  };
  // Step t's inputs into registers from device memory; without a dl
  // stream the evaluating offsets are zero.
  const auto load = [&](int t, StepRegs<T, N, M>& x) {
    x.m.q = in(a.q)[t * B + b];
    read_lane<N>(x.m.qv, in(a.q_vec), t, B, b);
    read_lane<N * N>(&x.m.Q[0][0], in(a.Q), t, B, b);
    read_lane<M>(x.m.r, in(a.r), t, B, b);
    read_lane<M * M>(&x.m.R[0][0], in(a.R), t, B, b);
    read_lane<M * N>(&x.m.P[0][0], in(a.P), t, B, b);
    read_lane<N * N>(&x.m.A[0][0], in(a.A), t, B, b);
    read_lane<N * M>(&x.m.Bm[0][0], in(a.Bm), t, B, b);
    if constexpr (!OPT) {
      read_lane<M * N>(&x.L[0][0], in(a.L_in), t, B, b);
#pragma unroll
      for (int i = 0; i < M; ++i) x.dl[i] = a.has_dl ? in(a.dl_in)[(t * M + i) * B + b] : T(0);
    }
    if constexpr (WLANE) {
      read_lane<N * N>(&x.W[0][0], in(a.W), t, B, b);
      read_lane<N * N>(&x.Wi[0][0], in(a.W_inv), t, B, b);
      x.ldW = in(a.logdet_W)[t * B + b];
    } else {
      read_lane<N * N>(&x.W[0][0], in(a.W), t, 1, 0);
      read_lane<N * N>(&x.Wi[0][0], in(a.W_inv), t, 1, 0);
      x.ldW = in(a.logdet_W)[t];
    }
  };

  // Terminal carry, θ and μ, on every lane.
  T s = in(a.q_term)[b], sv[N], S[N][N];
  read_lane<N>(sv, in(a.q_vec_term), 0, B, b);
  read_lane<N * N>(&S[0][0], in(a.Q_term), 0, B, b);
  const T theta = in(a.theta)[b];
  const T mu = in(a.mu)[b];
  bool m_fail = false, h_fail = false;

  // The DP step t on blocks m, noise model (W, W⁻¹, logdet W) and policy
  // (L, dl: inputs when evaluating, outputs when optimizing), and its
  // stores.
  const auto step = [&](int t, const Blocks<T, N, M>& m, const T(&W)[N][N],
                        const T(&Wi)[N][N], T ldW, T(&L)[M][N], T(&dl)[M]) {
    T LX[Cols][M], g[M], G[M][N], H[M][M];
    rq::small::dp_step<T, N, M, K, OPT, true>(lane, m.q, m.qv, m.Q, m.r, m.R, m.P, m.A, m.Bm,
                                              W, Wi, ldW, theta, mu, LX, L, dl, g, G, H, s, sv,
                                              S, m_fail, h_fail);
    if (OPT || !a.slim) {
      write_lane<M * N, K>(out(a.L), &L[0][0], t, B, b, lane, live);
      write_lane<M, K>(out(a.dl), dl, t, B, b, lane, live);
    }
    if (!a.slim) {
      write_lane<1, K>(out(a.s), &s, t, B, b, lane, live);
      write_lane<N, K>(out(a.s_vec), sv, t, B, b, lane, live);
      write_lane<N * N, K>(out(a.S), &S[0][0], t, B, b, lane, live);
      write_lane<M, K>(out(a.g), g, t, B, b, lane, live);
      write_lane<M * N, K>(out(a.G), &G[0][0], t, B, b, lane, live);
      write_lane<M * M, K>(out(a.H), &H[0][0], t, B, b, lane, live);
    }
  };

  if constexpr (STAGED) {
    if constexpr (!OPT) {   // without a dl stream the offsets stay zero
      if (!a.has_dl)
        for (int idx = threadIdx.x; idx < kSmallBuffers * Solves * M; idx += Threads)
          st[idx / (Solves * M)].solve[idx / M % Solves].in.pol.dl[idx % M] = T(0);
    }
    if (a.T > 0) fetch(a.T - 1);
    for (int t = a.T - 1; t >= 0; --t) {
      __pipeline_wait_prior(0);   // step t has landed,
      __syncthreads();            // and every thread is past step t + 1's buffer
      if (t > 0) fetch(t - 1);
      Step& d = st[t % kSmallBuffers];
      In& x = d.solve[k].in;
      const Noise<T, N>& nz = [&]() -> const Noise<T, N>& {
        if constexpr (WLANE)
          return x.noise;
        else
          return d.noise;
      }();
      if constexpr (OPT) {
        T L[M][N], dl[M];
        step(t, x.m, nz.W, nz.Wi, nz.ldW, L, dl);
      } else {
        step(t, x.m, nz.W, nz.Wi, nz.ldW, x.pol.L, x.pol.dl);
      }
    }
  } else {
    for (int t = a.T - 1; t >= 0; --t) {
      StepRegs<T, N, M> x;
      load(t, x);
      step(t, x.m, x.W, x.Wi, x.ldW, x.L, x.dl);
    }
  }
  if (live && lane == 0) {
    out(a.value)[b] = s;   // the t = 0 value
    a.m_fail[b] = m_fail;
    a.h_fail[b] = h_fail;
  }
}

// Dynamic shared memory of one team-kernel block (0: one solve per
// thread).
template <typename T, int N, int M, bool OPT, bool WLANE>
constexpr int team_smem_bytes() {
  if constexpr (kTeamShape<N, M>)
    return int(sizeof(RiccatiBlock<T, N, M, OPT, WLANE, kTeams>));
  else
    return 0;
}

template <typename T, int N, int M, bool OPT, bool WLANE>
cudaError_t launch_team(const RiccatiArgs& a, cudaStream_t stream) {
  constexpr int bytes = team_smem_bytes<T, N, M, OPT, WLANE>();
  const auto kernel = riccati_team_kernel<T, N, M, OPT, WLANE, kTeamLanes, kTeams>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<(a.B + kTeams - 1) / kTeams, kTeamLanes * kTeams, bytes, stream>>>(a);
  return cudaGetLastError();
}

// Dynamic shared memory of one few-lane block (0 unless staged).
template <typename T, int N, int M, bool OPT, bool WLANE, int K, bool STAGED>
constexpr int small_smem_bytes() {
  if constexpr (STAGED)
    return kSmallBuffers * int(sizeof(SmallStep<T, N, M, OPT, WLANE, small_threads(K) / K>));
  else
    return 0;
}

template <typename T, int N, int M, bool OPT, bool WLANE, int K, bool STAGED>
cudaError_t launch_small(const RiccatiArgs& a, cudaStream_t stream) {
  constexpr int bytes = small_smem_bytes<T, N, M, OPT, WLANE, K, STAGED>();
  constexpr int solves = small_threads(K) / K;
  const auto kernel = riccati_small_kernel<T, N, M, OPT, WLANE, K, STAGED>;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(a.B + solves - 1) / solves, small_threads(K), bytes, stream>>>(a);
  return cudaGetLastError();
}

// Whether the few-lane launch at width B with K lanes a solve stages its
// steps: always where a step is too large for registers, at K > 1 where
// the bank is too wide for reading into registers (small_direct), and as
// a variant build fixes.
template <typename T, int N, int M, bool OPT, int K>
bool small_staged(int B) {
  if constexpr (!kMayRead<T, N, M, OPT>)
    return true;
  else if constexpr (!kMayStage<T, N, M, OPT, K>)
    return false;
  else
    return !small_direct(B, sm_count(), K);
}

// f(std::integral_constant<bool, STAGED>) for the form chosen at run time,
// instantiating only the forms the build may take.
template <typename T, int N, int M, bool OPT, int K, typename F>
int with_form(bool staged, F f) {
  using std::integral_constant;
  if constexpr (kMayStage<T, N, M, OPT, K> && kMayRead<T, N, M, OPT>)
    return staged ? f(integral_constant<bool, true>{}) : f(integral_constant<bool, false>{});
  else
    return f(integral_constant<bool, kMayStage<T, N, M, OPT, K>>{});
}

// f(std::integral_constant<bool, OPT>, std::integral_constant<bool, WLANE>)
// for the pass and the noise model (WLANE: per lane) chosen at run time.
template <typename F>
int with_variant(int optimizing, int w_shared, F f) {
  using std::integral_constant;
  if (optimizing)
    return w_shared ? f(integral_constant<bool, true>{}, integral_constant<bool, false>{})
                    : f(integral_constant<bool, true>{}, integral_constant<bool, true>{});
  return w_shared ? f(integral_constant<bool, false>{}, integral_constant<bool, false>{})
                  : f(integral_constant<bool, false>{}, integral_constant<bool, true>{});
}

// One solve per team of K = small_lanes(B, SMs) lanes at n, m ≤
// kUnrollMax, per team of kTeamLanes for the shapes a team takes, one per
// thread otherwise.
template <typename T, int N, int M>
int launch(const RiccatiArgs& a, int optimizing, cudaStream_t stream) {
  if constexpr (kSmallShape<N, M>) {
    return with_lanes(small_lanes(a.B, sm_count()), [&](auto k) {
      constexpr int K = decltype(k)::value;
      return with_variant(optimizing, a.w_shared, [&](auto opt, auto wlane) {
        constexpr bool O = decltype(opt)::value;
        return with_form<T, N, M, O, K>(small_staged<T, N, M, O, K>(a.B), [&](auto staged) {
          return int(launch_small<T, N, M, O, decltype(wlane)::value, K,
                                  decltype(staged)::value>(a, stream));
        });
      });
    });
  } else if constexpr (kTeamShape<N, M>) {
    return with_variant(optimizing, a.w_shared, [&](auto opt, auto wlane) {
      return int(launch_team<T, N, M, decltype(opt)::value, decltype(wlane)::value>(a, stream));
    });
  } else {
    const int threads = 128;
    const int blocks = (a.B + threads - 1) / threads;
    if (optimizing)
      riccati_kernel<T, N, M, true><<<blocks, threads, 0, stream>>>(a);
    else
      riccati_kernel<T, N, M, false><<<blocks, threads, 0, stream>>>(a);
    return cudaGetLastError();
  }
}

// The launch at (N, M) for a bank of B lanes on the current device in one
// variant: returns its dynamic shared memory a block and sets its solves
// (teams) a block and lanes a solve.
template <typename T, int N, int M>
int launch_shape(int B, int optimizing, int w_shared, int* solves, int* lanes) {
  if constexpr (kSmallShape<N, M>) {
    const int K = small_lanes(B, sm_count());
    *solves = small_threads(K) / K;
    *lanes = K;
    return with_lanes(K, [&](auto k) {
      constexpr int Kc = decltype(k)::value;
      return with_variant(optimizing, w_shared, [&](auto opt, auto wlane) {
        constexpr bool O = decltype(opt)::value;
        return with_form<T, N, M, O, Kc>(small_staged<T, N, M, O, Kc>(B), [&](auto staged) {
          return small_smem_bytes<T, N, M, O, decltype(wlane)::value, Kc,
                                  decltype(staged)::value>();
        });
      });
    });
  } else if constexpr (kTeamShape<N, M>) {
    *solves = kTeams;
    *lanes = kTeamLanes;
    return with_variant(optimizing, w_shared, [&](auto opt, auto wlane) {
      return team_smem_bytes<T, N, M, decltype(opt)::value, decltype(wlane)::value>();
    });
  } else {
    *solves = 128;
    *lanes = 1;
    return 0;
  }
}

template <int N_, int M_>
struct Shape {
  static constexpr int N = N_, M = M_;
};

// f(Shape<n, m>{}) for an instantiated (n, m), else -1.  The library
// ops/_build.py builds from every source holds the shapes of the models
// the repository ships; any other (n, m) is built at its first use into a
// library of its own, from this file with -DRQ_SHAPE_N=n -DRQ_SHAPE_M=m,
// which holds that shape alone.
template <typename F>
int with_shape(int n, int m, F f) {
#if defined(RQ_SHAPE_N) && defined(RQ_SHAPE_M)
  if (n == RQ_SHAPE_N && m == RQ_SHAPE_M) return f(Shape<RQ_SHAPE_N, RQ_SHAPE_M>{});
#else
  if (n == 3 && m == 2) return f(Shape<3, 2>{});
  if (n == 2 && m == 2) return f(Shape<2, 2>{});
  if (n == 4 && m == 1) return f(Shape<4, 1>{});
  if (n == 12 && m == 4) return f(Shape<12, 4>{});
#endif
  return -1;
}

}  // namespace

// Arrays are lane-minor, of type Real; unused pointers may be null.
// Returns cudaGetLastError() after the launch, or -1 for an unsupported
// (n, m).
extern "C" int RQ_ENTRY(ratilqr_riccati)(int n, int m, int B, int T, int optimizing, int slim,
                                         int w_shared, int has_dl, const void* q,
                                         const void* q_vec, const void* Q, const void* r,
                                         const void* R, const void* P, const void* A,
                                         const void* Bm, const void* W, const void* W_inv,
                                         const void* logdet_W, const void* q_term,
                                         const void* q_vec_term, const void* Q_term,
                                         const void* theta, const void* mu, const void* L_in,
                                         const void* dl_in, void* value, void* s, void* s_vec,
                                         void* S, void* g, void* G, void* H, void* L, void* dl,
                                         void* m_fail, void* h_fail, void* stream) {
  if (B <= 0) return 0;
  const RiccatiArgs a{B,      T,        slim,     w_shared,   has_dl, q,
                      q_vec,  Q,        r,        R,          P,      A,
                      Bm,     W,        W_inv,    logdet_W,   q_term, q_vec_term,
                      Q_term, theta,    mu,       L_in,       dl_in,  value,
                      s,      s_vec,    S,        g,          G,      H,
                      L,      dl,       static_cast<bool*>(m_fail), static_cast<bool*>(h_fail)};
  return with_shape(n, m, [&](auto shape) {
    using S = decltype(shape);
    return int(launch<Real, S::N, S::M>(a, optimizing, static_cast<cudaStream_t>(stream)));
  });
}

// The launch of kernel A at (n, m) for a bank of B lanes on the current
// device, in the optimizing or evaluating pass with a shared or per-lane
// noise model: returns the dynamic shared memory a block takes (-1 for an
// (n, m) not instantiated) and sets its solves (teams) a block and lanes a
// solve.
extern "C" int RQ_ENTRY(ratilqr_riccati_smem)(int n, int m, int B, int optimizing, int w_shared,
                                              int* teams_per_block, int* lanes_per_team) {
  return with_shape(n, m, [&](auto shape) {
    using S = decltype(shape);
    return launch_shape<Real, S::N, S::M>(B, optimizing, w_shared, teams_per_block,
                                          lanes_per_team);
  });
}
