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
// One solve per thread (n ≤ kUnrollMax: the unicycle, LQR, the cartpole;
// candidate_kernel).  The forward phase rolls the policy
// u = l_cand + L(x − x̄) out in registers and stores the (T+1)·n states in
// a scratch buffer the wrapper allocates (lane-minor, (T+1, n, B)); the
// backward phase re-reads x_t, x̄_t, l_t and L_t, recomputes u, the model
// blocks and the fold
//   q̄_vec = q_vec + Lᵀr,  Q̄ = sym(Q + LᵀP + PᵀL + LᵀRL + μLᵀL),  Ā = A + BL
// and runs folded_step (dp_step.cuh).  Only value and m_fail are written.
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
// Bound on the H100: per step and lane the two phases read x̄ (n), l (m)
// and L (m·n) twice, write x (n) once and read it back: 2·11 + 6 = 28 words
// for the unicycle (112 bytes) against ~730 scalar operations for the
// fold and the folded DP plus the rollout and model twice.  At
// B = 262,144 and T = 100 that is ~2.9 GB (0.9 ms at 3.35 TB/s) against
// ~2e10 operations (~0.6 ms at 33.5e12 FP32 instructions/s before
// divisions, sqrt and sin/cos expand): bound by device memory in this
// simple form.  The TPU's stored variant kept the folded stack in VMEM;
// here a register-resident stack is impossible (22 words × T per lane)
// and a stored stack in device memory would move more bytes than it
// saves, so the recompute design is the one kernel.
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

#include "dp_step.cuh"
#include "dtype.cuh"
#include "team_mat.cuh"
#include "team_stage.cuh"
#include "tile_model.cuh"

namespace {

using rq::team::kTeamLanes;
using rq::team::kTeams;

struct CandidateArgs {
  int B, T;
  rq::Params p;
  const void *x_ref, *l_cand, *L, *W, *W_inv, *logdet_W, *theta, *mu;
  void *x_scratch, *value;
  bool* m_fail;
};

template <typename T, int N, int M>
__device__ __forceinline__ void policy(const T* xr, const T* lc, const T* Lg, int t, int64_t B,
                                       int b, const T (&x)[N], T (&u)[M], T (&L)[M][N]) {
  T dx[N];
#pragma unroll (rq::Unroll<N>::value)
  for (int i = 0; i < N; ++i) dx[i] = x[i] - xr[(t * N + i) * B + b];
#pragma unroll (rq::Unroll<M>::value)
  for (int i = 0; i < M; ++i) {
#pragma unroll (rq::Unroll<N>::value)
    for (int j = 0; j < N; ++j) L[i][j] = Lg[((int64_t(t) * M + i) * N + j) * B + b];
    T acc = L[i][0] * dx[0];
#pragma unroll (rq::Unroll<N>::value)
    for (int j = 1; j < N; ++j) acc = acc + L[i][j] * dx[j];
    u[i] = lc[(t * M + i) * B + b] + acc;
  }
}

template <typename T, template <typename> class Model>
__global__ void __launch_bounds__(128) candidate_kernel(const CandidateArgs a) {
  using Mod = Model<T>;
  constexpr int N = Mod::N, M = Mod::M;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int64_t B = a.B;
  const Mod model(a.p);
  const T* xr = static_cast<const T*>(a.x_ref);
  const T* lc = static_cast<const T*>(a.l_cand);
  const T* Lg = static_cast<const T*>(a.L);
  const T* Ws = static_cast<const T*>(a.W);
  const T* Wis = static_cast<const T*>(a.W_inv);
  const T* ldWs = static_cast<const T*>(a.logdet_W);
  T* xs = static_cast<T*>(a.x_scratch);

  // Forward: closed-loop rollout from x̄_0 (rollout_feedback: x_0 = x̄_0).
  T x[N], u[M], L[M][N];
#pragma unroll (rq::Unroll<N>::value)
  for (int i = 0; i < N; ++i) {
    x[i] = xr[i * B + b];
    xs[i * B + b] = x[i];
  }
  for (int t = 0; t < a.T; ++t) {
    policy<T, N, M>(xr, lc, Lg, t, B, b, x, u, L);
    T xn[N];
    model.f(x, u, xn);
#pragma unroll (rq::Unroll<N>::value)
    for (int i = 0; i < N; ++i) {
      x[i] = xn[i];
      xs[((t + 1) * N + i) * B + b] = x[i];
    }
  }

  // Backward: fold recomputed per step, folded evaluating DP.
  T s, sv[N], S[N][N];
  model.term(x, s, sv, S);
  const T theta = static_cast<const T*>(a.theta)[b];
  const T mu = static_cast<const T*>(a.mu)[b];
  bool m_fail = false;
  for (int t = a.T - 1; t >= 0; --t) {
#pragma unroll (rq::Unroll<N>::value)
    for (int i = 0; i < N; ++i) x[i] = xs[(t * N + i) * B + b];
    policy<T, N, M>(xr, lc, Lg, t, B, b, x, u, L);
    T q, qv[N], Q[N][N], r[M], R[M][M], P[M][N], A[N][N], Bm[N][M];
    model.jac(x, u, A, Bm);
    model.quad(t, x, u, q, qv, Q, r, R, P);

    T Ltr[N], LtP[N][N], RL[M][N], LtRL[N][N], LtL[N][N], BL[N][N];
    rq::mtv<T, M, N>(L, r, Ltr);
    rq::mtm<T, M, N, N>(L, P, LtP);
    rq::mm<T, M, M, N>(R, L, RL);
    rq::mtm<T, M, N, N>(L, RL, LtRL);
    rq::mtm<T, M, N, N>(L, L, LtL);
    rq::mm<T, N, M, N>(Bm, L, BL);
#pragma unroll (rq::Unroll<N>::value)
    for (int i = 0; i < N; ++i) {
      qv[i] = qv[i] + Ltr[i];
#pragma unroll (rq::Unroll<N>::value)
      for (int j = 0; j < N; ++j) {
        Q[i][j] = Q[i][j] + LtP[i][j] + LtP[j][i] + LtRL[i][j] + mu * LtL[i][j];
        A[i][j] = A[i][j] + BL[i][j];
      }
    }
    rq::sym_inplace<T, N>(Q);

    T W[N][N], Wi[N][N];
#pragma unroll (rq::Unroll<N>::value)
    for (int i = 0; i < N; ++i)
#pragma unroll (rq::Unroll<N>::value)
      for (int j = 0; j < N; ++j) {
        W[i][j] = Ws[(t * N + i) * N + j];
        Wi[i][j] = Wis[(t * N + i) * N + j];
      }
    rq::folded_step<T, N>(q, qv, Q, A, W, Wi, ldWs[t], theta, s, sv, S, m_fail);
  }
  static_cast<T*>(a.value)[b] = s;
  a.m_fail[b] = m_fail;
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

// Dynamic shared memory of one team-kernel block (0: one solve per thread).
template <typename T, template <typename> class Model>
constexpr int team_smem_bytes() {
  using Mod = Model<T>;
  return Mod::N > rq::kUnrollMax ? int(sizeof(BlockSmem<T, Mod::N, Mod::M, kTeams>)) : 0;
}

// One solve per thread for the small models, whose working set fits in
// registers; one solve per team of kTeamLanes lanes above kUnrollMax.
template <typename T, template <typename> class Model>
int launch(const CandidateArgs& a, cudaStream_t stream) {
  if constexpr (Model<T>::N > rq::kUnrollMax) {
    constexpr int bytes = team_smem_bytes<T, Model>();
    const auto kernel = candidate_team_kernel<T, Model, kTeamLanes, kTeams>;
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    kernel<<<(a.B + kTeams - 1) / kTeams, kTeamLanes * kTeams, bytes, stream>>>(a);
  } else {
    const int threads = 128;
    candidate_kernel<T, Model><<<(a.B + threads - 1) / threads, threads, 0, stream>>>(a);
  }
  return cudaGetLastError();
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

// Dynamic shared memory a block of kernel C takes on `model` (0 for one
// solve per thread, -1 for an unsupported model); its teams per block and
// lanes per team.
extern "C" int RQ_ENTRY(ratilqr_candidate_smem)(int model, int* teams_per_block,
                                                int* lanes_per_team) {
  *teams_per_block = kTeams;
  *lanes_per_team = kTeamLanes;
  if (model == rq::kUnicycle) return team_smem_bytes<Real, rq::Unicycle>();
  if (model == rq::kLqr) return team_smem_bytes<Real, rq::Lqr>();
  if (model == rq::kQuadrotor) return team_smem_bytes<Real, rq::Quadrotor>();
  if (model == rq::kCartpole) return team_smem_bytes<Real, rq::Cartpole>();
  return -1;
}
