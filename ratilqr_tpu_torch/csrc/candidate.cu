// Kernel C: one fused line-search trial — closed-loop rollout,
// quadratization, closed-loop fold and the folded evaluating Riccati pass.
//
// Replaces both ratilqr_tpu/ops/candidate_pallas.py:_candidate_kernel (:81,
// the stored folded stack) and :_candidate_kernel_recompute (:184), reached
// through candidate_bank (:280).  Both compute the same value; this kernel
// takes the recompute design for every model and horizon.  Per-example
// meaning: approximate_folded followed by the folded evaluating pass
// (candidate_pallas.py:427-432); with L = 0 and x̄ = x0 it is also the
// initialize! evaluation (ileqg.py:351-360).
//
// Two designs, one per size of model (launch() picks by Model::N):
//
// One solve per team of K lanes of a warp (n ≤ kUnrollMax: the unicycle,
// LQR, the cartpole; candidate_kernel, on small_team.cuh), K = 4 or 1.
// The forward phase rolls the policy u = l_cand + L(x − x̄) out in
// registers and stores the (T+1)·n states in a scratch buffer the wrapper
// allocates (lane-minor, (T+1, n, B)); the backward phase re-reads x_t,
// x̄_t, l_t and L_t, recomputes u, the model blocks and the fold
//   q̄_vec = q_vec + Lᵀr,  Q̄ = sym(Q + LᵀP + PᵀL + LᵀRL + μLᵀL),  Ā = A + BL
// and runs rq::small::folded_step, in dp_step.cuh:folded_step's order.
// Every lane of a team rolls out, calls the device model and folds (that
// saves broadcasting ~40 words a step); lane r takes the solves with M's
// factor for columns r, r + K, ... of M⁻¹[S | s⃗] and the rows r, r + K, ...
// of DS, AᵀDS and AᵀDS·A, which go round by __shfl_sync(width = K).  Only
// value and m_fail are written, by lane 0.  A block is 128 threads where
// K > 1 and 64 at K = 1, one solve per K of them, on consecutive lanes b.
//
// The launch picks K from B and the card's SM count (small_lanes,
// small_launch.cuh, the rule kernel B shares): 4 while that keeps the bank
// within kSmallFill = 512 threads an SM, so up to B = 16,896 on an H100's
// 132 SMs, 1 above (at ~1,000 threads an SM the lanes' replicated model,
// fold and factor cost more issue slots than the extra warps save; K = 2
// between the two tied K = 1 when measured,
// team_sweep.py candidate, so the launch does not take it).  One lane
// a solve everywhere (the former design) left one warp a scheduler at
// B = 16,384 and most SMs empty at the widths of RAT iLQR++ and the
// fleets (1 to 942 lanes), each thread paying its step's dependent chain
// of loads, divisions, square roots and logs in turn.
// Where K > 1 two more things shorten that chain:
//   - the backward phase computes the fold of step t − 1, which does not
//     depend on the carry, in the same iteration as the DP step of step
//     t, so its loads and model calls fill the DP's dependent chain;
//   - each step the block stages x̄, l, L (backward also x and W_t, W⁻¹_t,
//     logdet W_t, once a block) of a later step by cp.async into a ring of
//     three shared buffers, entry-major as in device memory, behind the
//     one block barrier of the step.
// At K = 1 the bank fills the card with warps that hide the loads and the
// chain, and the registers both cost would lower occupancy (measured:
// team_sweep.py candidate), so K = 1 reads its steps where it uses them,
// one step at a time.  Shared memory a block (three steps) at K = 4, f32:
// unicycle 5,604 B, cartpole 5,388 B, LQR 3,948 B; twice that in f64; none
// at K = 1.  A team past
// the end of the bank reads lane B − 1, keeps every barrier and shuffle
// and stores nothing.
//
// One solve per team (n > kUnrollMax: the quadrotor; candidate_team_kernel).
// Same phases and arithmetic, spread over a team of 16 lanes (two teams a
// warp) with the algebra of team_mat.cuh; K = kTeams = 8 teams a block,
// on 8 consecutive lanes b.  Each step, the block stages W_t, W⁻¹_t,
// logdet W_t once and every team's x̄_t, l_t, L_t (and x_t) in one
// coalesced pass (8 neighbouring lanes of one entry are one 32-byte
// sector in f32).  Each team keeps its working set in shared memory: the
// carry (s⃗, S), Q̄, Ā, the factor of M (later DS), M⁻¹S (later AᵀDS), the
// model's B, P, R, RL and the vectors, 1,048 words: 34,692 bytes a block
// in f32 and 69,384 in f64 with W and W⁻¹ (dynamic shared memory, so the
// launch raises the block's limit first).  No array lives in a thread's
// stack frame.  One lane calls the device model on the team's shared
// arrays; lane i owns row i of every product and of M's factor (held in
// registers, its pivots and columns passed round by shuffles); lanes 0-11
// solve the 12 columns of M⁻¹S and lane 12 M⁻¹s⃗, each in registers.
// What bounds it on the H100 is no longer memory but the instruction rate
// of the team's shared-memory loads and multiply-adds and its serial parts
// (the factor's 12 pivots, the substitutions' dependent chains, the
// one-lane model calls and risk term), ~12 warp barriers and 2 block
// barriers a step; two teams a warp run their serial parts at once.
// Registers (96 a thread in f32) leave 5 blocks, 40 teams, an SM.  A team
// past the end of the bank reads lane B − 1, keeps every barrier and
// stores nothing.
//
// Bound on the H100: the function reads x̄, l and L once (the wrapper's
// bound, kernel_check.kernel_work: 0.346 ms for the unicycle at T = 100,
// B = 262,144 in f32).  The recompute design reads x̄ (n), l (m) and L
// (m·n) twice and writes and re-reads x (n): 2·11 + 6 = 28 words a lane and
// step for the unicycle (112 bytes), ~2.94 GB at T = 100 and B = 262,144,
// a traffic floor of ~0.88 ms at 3.35 TB/s, against ~2e10 operations
// (~0.6 ms at 33.5e12 FP32 instructions/s before divisions, sqrt and
// sin/cos expand).  The TPU's stored variant kept the folded stack in
// VMEM; here a register-resident stack is impossible (22 words × T per
// lane) and neither a stored stack in device memory nor one in shared
// memory (22·T words a solve) pays, so the recompute design is the one
// kernel and x goes through the lane-minor scratch.
//
// At n=12, m=4 (the quadrotor; the TPU ran its recompute variant there,
// candidate_pallas.py:440-456) a step needs x̄, l and L, 64 words per
// lane (this design reads them twice), against ~21,900 operations of fold
// and folded DP: at B = 16,384 and T = 50 that is 0.21 GB (0.06 ms)
// against 1.79e10 operations (0.27 ms), bound by the FP32 rate.  One solve
// per thread kept its 12x12 working set in a 10.4 KB stack frame, 170 MB
// of local memory at that width (more than the 50 MB L2), with 4 warps an
// SM: hence the team design above.
//
// At n=4, m=1 (the cartpole) a step reads x̄, l and L (9 words) and the
// state it stored, against ~950 operations of fold and folded DP: at
// B = 16,384 and T = 50, 0.030 GB (0.009 ms) against 7.8e8 operations
// (0.012 ms), bound by the FP32 rate.
#include <cstdint>

// The contraction policy at kCarry (smallmat.cuh): at kFactor alone this
// kernel's float32 m_fail disagreed with the plain version's on a lane
// near neurotic breakdown.
#ifndef RQ_PSD_ROUNDING
#define RQ_PSD_ROUNDING 2
#endif

#include "dtype.cuh"
#include "small_launch.cuh"
#include "small_team.cuh"
#include "team_mat.cuh"
#include "team_stage.cuh"
#include "tile_model.cuh"

namespace {

using rq::small::sm_count;
using rq::small::small_lanes;
using rq::small::small_threads;
using rq::small::with_lanes;
using rq::team::kTeamLanes;
using rq::team::kTeams;

struct CandidateArgs {
  int B, T;
  rq::Params p;
  const void *x_ref, *l_cand, *L, *W, *W_inv, *logdet_W, *theta, *mu;
  void *x_scratch, *value;
  bool* m_fail;
};

// ---- One solve per team of K lanes (N ≤ rq::kUnrollMax) ----

// Whether a team of K > 1 lanes stages its streamed steps in shared
// memory by cp.async (1) or reads them from device memory where it uses
// them (0; K = 1 always does).  The launch picks K, and the threads a
// block, by small_launch.cuh's rule.  -DRQ_SMALL_STAGE (and
// small_launch.cuh's -DRQ_SMALL_THREADS/-DRQ_WIDE_THREADS/-DRQ_SMALL_LANES)
// build the variants python -m ratilqr_tpu_torch.team_sweep times.
#ifndef RQ_SMALL_STAGE
#define RQ_SMALL_STAGE 1
#endif

// Whether a team of K lanes computes the fold of step t − 1 during the
// DP step of step t, and whether it also stages its steps.  Both pay where
// the bank is narrow (K > 1: few warps, each step's dependent chain is the
// time); at K = 1 the bank fills the card with warps that hide the loads
// and chain, and the extra registers of either would cost occupancy.
__host__ __device__ constexpr bool small_ahead(int K) { return K > 1; }
__host__ __device__ constexpr bool small_staged(int K) {
  return RQ_SMALL_STAGE == 1 && small_ahead(K);
}
static_assert(RQ_SMALL_STAGE == 0 || RQ_SMALL_STAGE == 1, "staging is off or on");

// One step's streamed inputs for a block's S solves, entry-major as in
// device memory: x̄_t, l_t, L_t, x_t, and W_t, W⁻¹_t, logdet W_t once.
template <typename T, int N, int M, int S>
struct SmallStep {
  T xr[N][S], l[M][S], L[M * N][S], x[N][S];
  T W[N][N], Wi[N][N], ldW;
};

// Staged steps: step t in buffer t % kSmallBuffers.  The fold of step
// t − 1 is computed during the DP step of step t, which still reads W_t,
// while the copies of step t − 2 land.
constexpr int kSmallBuffers = 3;

// One step's closed-loop fold: q, q̄⃗ = q⃗ + Lᵀr, Q̄ = sym(Q + LᵀP + PᵀL +
// LᵀRL + μLᵀL) and Ā = A + BL.
template <typename T, int N>
struct Fold {
  T q, qv[N], Q[N][N], A[N][N];
};

// The same trial as the team kernel below, one solve per team of K lanes
// of a warp (K = 1: one per thread), on rq::small::folded_step.  Every
// lane rolls the policy out, calls the device model and folds in
// registers; the lanes split the solves and products of the DP step.
// Ahead (small_ahead), the backward phase is software-pipelined: the fold
// of step t − 1, which does not depend on the carry, is computed in the
// same iteration as the DP step of step t, so its loads and model calls
// fill the DP's dependent chain.  Staged (small_staged, only where ahead),
// each step starts with the block's one barrier, after which the block
// issues the cp.async copies of a later step; every team, live or not,
// keeps every barrier and shuffle.
template <typename T, template <typename> class Model, int K>
__global__ void __launch_bounds__(small_threads(K)) candidate_kernel(const CandidateArgs a) {
  using Mod = Model<T>;
  constexpr int Threads = small_threads(K);
  constexpr int N = Mod::N, M = Mod::M, Solves = Threads / K;
  constexpr int Rows = rq::small::kSlots<N, K>;
  constexpr bool Staged = small_staged(K), Ahead = small_ahead(K);
  using Step = SmallStep<T, N, M, Solves>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Step* st = reinterpret_cast<Step*>(smem_raw);   // kSmallBuffers steps when staged
  const int lane = threadIdx.x % K, k = threadIdx.x / K;
  const int b0 = blockIdx.x * Solves;
  const bool live = b0 + k < a.B;   // a team past the bank stores nothing
  const int64_t B = a.B, b = live ? b0 + k : a.B - 1;
  const Mod model(a.p);
  const T* xr = static_cast<const T*>(a.x_ref);
  const T* lc = static_cast<const T*>(a.l_cand);
  const T* Lg = static_cast<const T*>(a.L);
  const T* Ws = static_cast<const T*>(a.W);
  const T* Wis = static_cast<const T*>(a.W_inv);
  const T* ldWs = static_cast<const T*>(a.logdet_W);
  T* xs = static_cast<T*>(a.x_scratch);
  const auto buf = [&](int t) -> Step& { return st[t % kSmallBuffers]; };

  // Step t's x̄_t, l_t, L_t (and backward x_t and the noise model) into
  // its buffer by cp.async, as one batch.
  const auto fetch = [&](int t, bool backward) {
    Step& d = buf(t);
    rq::team::stage_lanes<N, Solves, Threads, true>(d.xr, xr, t, B, b0);
    rq::team::stage_lanes<M, Solves, Threads, true>(d.l, lc, t, B, b0);
    rq::team::stage_lanes<M * N, Solves, Threads, true>(d.L, Lg, t, B, b0);
    if (backward) {
      rq::team::stage_lanes<N, Solves, Threads, true>(d.x, xs, t, B, b0);
      rq::team::stage_noise<N, true>(d.W, d.Wi, d.ldW, Ws, Wis, ldWs, t);
    }
    __pipeline_commit();
  };
  // Staged: the batch in flight has landed, and every thread is past the
  // previous step, so the batch of step `next` may go into its buffer.
  const auto next_step = [&](int next, bool backward) {
    if constexpr (Staged) {
      __pipeline_wait_prior(0);
      __syncthreads();
      if (next >= 0 && next < a.T) fetch(next, backward);
    }
  };
  // u = l_t + L_t (x − x̄_t), from step t's buffer (staged) or device memory.
  const auto policy = [&](int t, const T (&x)[N], T (&u)[M], T (&L)[M][N]) {
    const Step& d = buf(t);
    T dx[N];
#pragma unroll
    for (int i = 0; i < N; ++i)
      dx[i] = x[i] - (Staged ? d.xr[i][k] : xr[(int64_t(t) * N + i) * B + b]);
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int c = 0; c < N; ++c)
        L[i][c] = Staged ? d.L[i * N + c][k] : Lg[((int64_t(t) * M + i) * N + c) * B + b];
      T acc = L[i][0] * dx[0];
#pragma unroll
      for (int c = 1; c < N; ++c) acc = acc + L[i][c] * dx[c];
      u[i] = (Staged ? d.l[i][k] : lc[(int64_t(t) * M + i) * B + b]) + acc;
    }
  };
  // Lane r stores entries r, r + K, ... of x_t.
  const auto store_x = [&](int t, const T (&x)[N]) {
#pragma unroll
    for (int r = 0; r < Rows; ++r) {
      const int i = lane + K * r;
      if (i < N && live) xs[(int64_t(t) * N + i) * B + b] = rq::small::pick<T, N>(x, i);
    }
  };

  // Forward: closed-loop rollout from x̄_0 (rollout_feedback: x_0 = x̄_0).
  T x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = xr[i * B + b];
  store_x(0, x);
  if (Staged && a.T > 0) fetch(0, false);
  for (int t = 0; t < a.T; ++t) {
    next_step(t + 1, false);
    T u[M], L[M][N], xn[N];
    policy(t, x, u, L);
    model.f(x, u, xn);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = xn[i];
    store_x(t + 1, x);
  }

  // Backward: fold recomputed per step, folded evaluating DP.
  T s, sv[N], S[N][N];
  model.term(x, s, sv, S);
  const T theta = static_cast<const T*>(a.theta)[b];
  const T mu = static_cast<const T*>(a.mu)[b];
  bool m_fail = false;
  // Step t's fold, from its buffer (staged) or device memory.
  const auto fold = [&](int t, Fold<T, N>& f) {
    T xt[N], u[M], L[M][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
      xt[i] = Staged ? buf(t).x[i][k] : xs[(int64_t(t) * N + i) * B + b];
    policy(t, xt, u, L);
    T r[M], R[M][M], P[M][N], Bm[N][M];
    model.jac(xt, u, f.A, Bm);
    model.quad(t, xt, u, f.q, f.qv, f.Q, r, R, P);
    T Ltr[N], LtP[N][N], RL[M][N], LtRL[N][N], LtL[N][N], BL[N][N];
    rq::mtv<T, M, N>(L, r, Ltr);
    rq::mtm<T, M, N, N>(L, P, LtP);
    rq::mm<T, M, M, N>(R, L, RL);
    rq::mtm<T, M, N, N>(L, RL, LtRL);
    rq::mtm<T, M, N, N>(L, L, LtL);
    rq::mm<T, N, M, N>(Bm, L, BL);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      f.qv[i] = f.qv[i] + Ltr[i];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        f.Q[i][j] = f.Q[i][j] + LtP[i][j] + LtP[j][i] + LtRL[i][j] + mu * LtL[i][j];
        f.A[i][j] = f.A[i][j] + BL[i][j];
      }
    }
    rq::sym_inplace<T, N>(f.Q);
  };
  __syncthreads();   // the team's x stores, and every thread past the forward's buffers
  Fold<T, N> f;
  if (Staged && a.T > 0) {
    fetch(a.T - 1, true);
    if (a.T > 1) fetch(a.T - 2, true);
  }
  if (Ahead && a.T > 0) {
    if constexpr (Staged) {
      __pipeline_wait_prior(a.T > 1 ? 1 : 0);
      __syncthreads();
    }
    fold(a.T - 1, f);
  }
  for (int t = a.T - 1; t >= 0; --t) {
    next_step(t - 2, true);   // staged, so ahead
    Fold<T, N> next;
    if constexpr (Ahead)
      fold(t > 0 ? t - 1 : 0, next);   // step 0's twice, so the body has no branch
    else
      fold(t, f);
    if constexpr (Staged) {
      const Step& d = buf(t);
      rq::small::folded_step<T, N, K>(lane, f.q, f.qv, f.Q, f.A, d.W, d.Wi, d.ldW, theta, s, sv,
                                      S, m_fail);
    } else {
      T W[N][N], Wi[N][N];
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) {
          W[i][j] = Ws[(t * N + i) * N + j];
          Wi[i][j] = Wis[(t * N + i) * N + j];
        }
      rq::small::folded_step<T, N, K>(lane, f.q, f.qv, f.Q, f.A, W, Wi, ldWs[t], theta, s, sv,
                                      S, m_fail);
    }
    if constexpr (Ahead) f = next;
  }
  if (live && lane == 0) {
    static_cast<T*>(a.value)[b] = s;
    a.m_fail[b] = m_fail;
  }
}

// ---- One solve per team (N > rq::kUnrollMax: the quadrotor) ----

// One team's working set in shared memory: the carry (s⃗, S), the model
// blocks and the fold (q̄, Q̄, Ā, P, R, r, B, RL = R·L), the staged x̄_t,
// l_t, L_t and x_t, the policy's u and folded_step's scratch.
template <typename T, int N, int M>
struct TeamSmem {
  T S[N][N], Q[N][N], A[N][N];
  rq::team::FoldScratch<T, N> w;
  T Bm[N][M], P[M][N], R[M][M], RL[M][N], L[M][N];
  T x[2][N], xr[N], qv[N], sv[N], l[M], u[M], r[M];
};

template <typename T, int N, int M, int K>
using BlockSmem = rq::team::BlockSmem<T, N, TeamSmem<T, N, M>, K>;

// u = l_t + L_t (x − x̄_t) on lanes 0..M−1 (policy's arithmetic).
template <typename T, int N, int M>
__device__ __forceinline__ void team_policy(int lane, TeamSmem<T, N, M>& tm,
                                            const T (&x)[N]) {
  if (lane < M) {
    T acc = tm.L[lane][0] * (x[0] - tm.xr[0]);
    for (int j = 1; j < N; ++j) acc = acc + tm.L[lane][j] * (x[j] - tm.xr[j]);
    tm.u[lane] = tm.l[lane] + acc;
  }
  __syncwarp();
}

// The same trial as candidate_kernel, one solve per team: the forward
// rollout, then per step the model blocks (one lane calls the device
// model on the team's shared arrays), the fold and rq::team::folded_step.
// Each step starts with one block-wide pass that stages W_t, W⁻¹_t and
// every team's x̄_t, l_t, L_t (and x_t) in shared memory.
template <typename T, template <typename> class Model, int Lanes, int K>
__global__ void __launch_bounds__(Lanes * K) candidate_team_kernel(const CandidateArgs a) {
  using Mod = Model<T>;
  constexpr int N = Mod::N, M = Mod::M;
  using Team = TeamSmem<T, N, M>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<BlockSmem<T, N, M, K>*>(smem_raw);
  const int lane = threadIdx.x % Lanes, k = threadIdx.x / Lanes;
  const int b0 = blockIdx.x * K, b = b0 + k;
  const bool live = b < a.B;   // a team past the bank keeps every barrier
  const int64_t B = a.B, bc = live ? b : a.B - 1;
  Team& tm = sm.team[k];
  const Mod model(a.p);
  const T* xr = static_cast<const T*>(a.x_ref);
  const T* lc = static_cast<const T*>(a.l_cand);
  const T* Lg = static_cast<const T*>(a.L);
  const T* Ws = static_cast<const T*>(a.W);
  const T* Wis = static_cast<const T*>(a.W_inv);
  const T* ldWs = static_cast<const T*>(a.logdet_W);
  T* xs = static_cast<T*>(a.x_scratch);

  // Forward: closed-loop rollout from x̄_0, x_t ping-ponging in tm.x.
  if (lane < N) {
    tm.x[0][lane] = xr[lane * B + bc];
    if (live) xs[lane * B + b] = tm.x[0][lane];
  }
  int cur = 0;
  for (int t = 0; t < a.T; ++t) {
    __syncthreads();
    rq::team::stage<N>(xr, t, B, b0, sm.team, &Team::xr);
    rq::team::stage<M>(lc, t, B, b0, sm.team, &Team::l);
    rq::team::stage<M * N>(Lg, t, B, b0, sm.team, &Team::L);
    __syncthreads();
    team_policy<T, N, M>(lane, tm, tm.x[cur]);
    if (lane == 0) model.f(tm.x[cur], tm.u, tm.x[1 - cur]);
    __syncwarp();
    cur = 1 - cur;
    if (lane < N && live) xs[((t + 1) * N + lane) * B + b] = tm.x[cur][lane];
  }

  // Backward: fold recomputed per step, folded evaluating DP.
  T s = T(0), q = T(0);   // lane 0's
  if (lane == 0) model.term(tm.x[cur], s, tm.sv, tm.S);
  const T theta = static_cast<const T*>(a.theta)[bc];
  const T mu = static_cast<const T*>(a.mu)[bc];
  bool m_fail = false;
  for (int t = a.T - 1; t >= 0; --t) {
    __syncthreads();
    rq::team::stage<N>(xr, t, B, b0, sm.team, &Team::xr);
    rq::team::stage<M>(lc, t, B, b0, sm.team, &Team::l);
    rq::team::stage<M * N>(Lg, t, B, b0, sm.team, &Team::L);
    rq::team::stage<N>(xs, t, B, b0, sm.team, &Team::x);   // into x[0]
    rq::team::stage_noise(sm, Ws, Wis, ldWs, t);
    __syncthreads();
    const T (&x)[N] = tm.x[0];
    team_policy<T, N, M>(lane, tm, x);
    if (lane == 0) {
      model.jac(x, tm.u, tm.A, tm.Bm);
      model.quad(t, x, tm.u, q, tm.qv, tm.Q, tm.r, tm.R, tm.P);
    }
    __syncwarp();

    // The fold, in candidate_kernel's order: lane i < N owns row i of
    // Ā = A + BL, q̄_vec = q_vec + Lᵀr and Q̄ = sym(Q + LᵀP + PᵀL + LᵀRL +
    // μLᵀL); the lanes after them RL = R L first.
    T row[N], out[N];
    if (lane < N) {
      rq::team::mm_row<T, N, M, N>(tm.Bm, tm.L, lane, row);
#pragma unroll
      for (int j = 0; j < N; ++j) tm.A[lane][j] = tm.A[lane][j] + row[j];
      tm.qv[lane] = tm.qv[lane] + rq::team::mtv_at<T, M, N>(tm.L, tm.r, lane);
    }
    for (int i = lane - N; i >= 0 && i < M; i += Lanes - N) {
      rq::team::mm_row<T, M, M, N>(tm.R, tm.L, i, row);
#pragma unroll
      for (int j = 0; j < N; ++j) tm.RL[i][j] = row[j];
    }
    __syncwarp();
    if (lane < N) {
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = tm.Q[lane][j];
      rq::team::mtm_row<T, M, N, N>(tm.L, tm.P, lane, row);   // LᵀP
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = out[j] + row[j];
      rq::team::mtm_row<T, M, N, N>(tm.P, tm.L, lane, row);   // PᵀL
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = out[j] + row[j];
      rq::team::mtm_row<T, M, N, N>(tm.L, tm.RL, lane, row);   // LᵀRL
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = out[j] + row[j];
      rq::team::mtm_row<T, M, N, N>(tm.L, tm.L, lane, row);   // LᵀL
#pragma unroll
      for (int j = 0; j < N; ++j) tm.Q[lane][j] = out[j] + mu * row[j];
    }
    __syncwarp();
    rq::team::sym_inplace<T, N, Lanes>(lane, tm.Q);
    rq::team::folded_step<T, N, Lanes>(lane, q, tm.qv, tm.Q, tm.A, sm.W, sm.Wi, sm.ldW, theta,
                                       s, tm.sv, tm.S, m_fail, tm.w);
  }
  if (live && lane == 0) {
    static_cast<T*>(a.value)[b] = s;
    a.m_fail[b] = m_fail;
  }
}

// Dynamic shared memory of one team-kernel block (the quadrotor).
template <typename T, template <typename> class Model>
constexpr int team_smem_bytes() {
  using Mod = Model<T>;
  return int(sizeof(BlockSmem<T, Mod::N, Mod::M, kTeams>));
}

// Dynamic shared memory of one candidate_kernel block at K lanes a solve:
// its staged steps (0 unstaged).
template <typename T, template <typename> class Model, int K>
constexpr int small_smem_bytes() {
  using Mod = Model<T>;
  return small_staged(K)
             ? int(kSmallBuffers * sizeof(SmallStep<T, Mod::N, Mod::M, small_threads(K) / K>))
             : 0;
}

template <typename T, template <typename> class Model, int K>
int launch_small(const CandidateArgs& a, cudaStream_t stream) {
  constexpr int bytes = small_smem_bytes<T, Model, K>(), solves = small_threads(K) / K;
  const auto kernel = candidate_kernel<T, Model, K>;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(a.B + solves - 1) / solves, small_threads(K), bytes, stream>>>(a);
  return cudaGetLastError();
}

// One solve per team of kTeamLanes lanes above kUnrollMax; one per team of
// small_lanes(B, SMs) lanes at n ≤ kUnrollMax.
template <typename T, template <typename> class Model>
int launch(const CandidateArgs& a, cudaStream_t stream) {
  if constexpr (Model<T>::N > rq::kUnrollMax) {
    constexpr int bytes = team_smem_bytes<T, Model>();
    const auto kernel = candidate_team_kernel<T, Model, kTeamLanes, kTeams>;
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    kernel<<<(a.B + kTeams - 1) / kTeams, kTeamLanes * kTeams, bytes, stream>>>(a);
    return cudaGetLastError();
  } else {
    return with_lanes(small_lanes(a.B, sm_count()),
                      [&](auto K) {
                        return launch_small<T, Model, decltype(K)::value>(a, stream);
                      });
  }
}

// The launch on `model` at width B: returns its dynamic shared memory a
// block and sets its solves a block and lanes a solve.
template <typename T, template <typename> class Model>
int launch_shape(int B, int* solves, int* lanes) {
  if constexpr (Model<T>::N > rq::kUnrollMax) {
    *solves = kTeams;
    *lanes = kTeamLanes;
    return team_smem_bytes<T, Model>();
  } else {
    const int K = small_lanes(B, sm_count());
    *solves = small_threads(K) / K;
    *lanes = K;
    return with_lanes(
        K, [](auto k) { return small_smem_bytes<T, Model, decltype(k)::value>(); });
  }
}

template <typename T>
int dispatch(int model, const CandidateArgs& a, cudaStream_t stream) {
  if (model == rq::kUnicycle) return launch<T, rq::Unicycle>(a, stream);
  if (model == rq::kLqr) return launch<T, rq::Lqr>(a, stream);
  if (model == rq::kQuadrotor) return launch<T, rq::Quadrotor>(a, stream);
  if (model == rq::kCartpole) return launch<T, rq::Cartpole>(a, stream);
  return -1;
}

}  // namespace

// model: a rq::ModelId whose parameters are the host array
// params[rq::kMaxParams].  Arrays are lane-minor, of type Real; x_scratch
// holds (T+1)·n·B elements.  Returns cudaGetLastError() after the launch,
// or -1 for an unsupported model.
extern "C" int RQ_ENTRY(ratilqr_candidate)(int model, int B, int T, const double* params,
                                           const void* x_ref, const void* l_cand,
                                           const void* L, const void* W, const void* W_inv,
                                           const void* logdet_W, const void* theta,
                                           const void* mu, void* x_scratch, void* value,
                                           void* m_fail, void* stream) {
  if (B <= 0) return 0;
  CandidateArgs a{B,     T,  {},        x_ref, l_cand, L, W, W_inv, logdet_W,
                  theta, mu, x_scratch, value, static_cast<bool*>(m_fail)};
  for (int i = 0; i < rq::kMaxParams; ++i) a.p[i] = params[i];
  return dispatch<Real>(model, a, static_cast<cudaStream_t>(stream));
}

// The launch of kernel C on `model` for a bank of B lanes on the current
// device: returns the dynamic shared memory a block takes (-1 for an
// unsupported model) and sets the solves a block and the lanes a solve.
extern "C" int RQ_ENTRY(ratilqr_candidate_smem)(int model, int B, int* solves_per_block,
                                                int* lanes_per_solve) {
  int* const sb = solves_per_block;
  int* const ls = lanes_per_solve;
  if (model == rq::kUnicycle) return launch_shape<Real, rq::Unicycle>(B, sb, ls);
  if (model == rq::kLqr) return launch_shape<Real, rq::Lqr>(B, sb, ls);
  if (model == rq::kQuadrotor) return launch_shape<Real, rq::Quadrotor>(B, sb, ls);
  if (model == rq::kCartpole) return launch_shape<Real, rq::Cartpole>(B, sb, ls);
  return -1;
}
