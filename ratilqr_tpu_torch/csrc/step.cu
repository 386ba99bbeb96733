// Kernel B: the fused iLEQG step — open-loop rollout, quadratization and
// the policy-optimizing Riccati pass in one kernel.
//
// Replaces ratilqr_tpu/ops/step_pallas.py:_step_opt_kernel (:81), reached
// through step_optimize_bank (:197).  Per-example meaning: the open-loop
// rollout of l from x0 with Jacobians, approximate_model, and one slim
// optimizing pass (step_pallas.py:341-346).  μ-restarts stay outside, in
// ratilqr_tpu_torch/ops/riccati.py:mu_restart_loop, as on the TPU.
//
// Two designs, one per size of model (launch() picks by Model::N):
//
// One solve per thread (n ≤ kUnrollMax: the unicycle, LQR, the cartpole;
// step_kernel).  The forward phase rolls x forward in registers and writes
// the T+1 states to the output buffer x (lane-minor, (T+1, n, B)); the
// backward phase walks it back, recomputes A, B and the cost derivatives
// from (x_t, l_t) with the device tile model (tile_model.cuh) and runs
// dp_step (dp_step.cuh).  Nothing but x, L, dl and the per-lane scalars
// touches device memory.
//
// One solve per team (n > kUnrollMax: the quadrotor; step_team_kernel).
// Same phases and arithmetic, spread over a team of 16 lanes (two teams a
// warp) with rq::team::dp_step (team_mat.cuh); K = kTeams = 8 teams a
// block, on 8 consecutive lanes b (team_stage.cuh).  Forward, each step the
// block stages every team's l_t in one coalesced pass, one lane calls the
// model on the team's shared x_t, and lanes < n write x_{t+1}.  Backward,
// each step the block writes every team's L_{t+1} and dl_{t+1} in one
// coalesced pass and stages W_t, W⁻¹_t, logdet W_t once and every team's
// x_t and l_t; one lane calls the device model's jac and quad on the
// team's shared arrays.  Each team keeps its working set in shared memory:
// the carry (s⃗, S), Q, A, the factor of M (later DS), M⁻¹S (later
// AᵀDS·A), the model's B, P, R, the gains L, G, H L, H and the vectors,
// 1,109 words: 36,644 bytes a block in f32 and 73,288 in f64 with W and
// W⁻¹ (dynamic shared memory, so the launch raises the block's limit
// first).  No 12x12 array lives in a thread's stack frame.  Lane i owns row
// i of every N×N product and of M's factor (in registers, pivots passed by
// shuffles); lanes 12-15 own the rows of BᵀDS, G and H; every lane factors
// the 4x4 H in registers and lane j solves column j of L (lane 12: dl).
// What bounds it on the H100 is, as for kernel C's team kernel, the
// instruction rate of the team's shared-memory loads and multiply-adds and
// its serial parts (the factor's 12 pivots, the substitutions, the
// one-lane model calls), 8 warp barriers and 2 block barriers a step.  A
// team past the end of the bank reads lane B − 1, keeps every barrier and
// stores nothing.
//
// Bound on the H100: per step and lane the kernel reads l (m words) twice
// and x (n) once, and writes x (n), L (m·n) and dl (m): 2+2+3+3+6+2 = 18
// words for the unicycle (72 bytes), against ~730 scalar operations of DP
// algebra plus the model's sin/cos.  At B = 262,144 and T = 100 that is
// ~1.9 GB (0.56 ms at 3.35 TB/s) against ~1.9e10 operations (~0.6 ms at
// 33.5e12 FP32 instructions/s, more with divisions, sqrt and sin/cos
// expanding to several instructions): the kernel sits near the balance
// point and leans to the FP32 ALUs.  The simple design keeps every
// intermediate in registers and leaves x to the L2 cache between the two
// phases (x of a 128-lane block is 154 KB at T = 100 in f32).
//
// At n=12, m=4 (the quadrotor) a step moves 4 + 12 + 48 + 4 + 4 words per
// lane but runs ~22,600 operations of DP algebra: at B = 16,384 and T = 50
// that is 0.22 GB (0.07 ms) against 1.85e10 operations (0.28 ms), bound by
// the FP32 rate.  One solve per thread kept its 12x12 working set in a
// 10.0 KB stack frame, 164 MB of local memory at that width (more than the
// 50 MB L2), with 4 warps an SM: hence the team design above.
//
// At n=4, m=1 (the cartpole) a step moves 1 + 4 + 4 + 1 + 1 words per lane
// against ~950 operations of DP algebra: at B = 16,384 and T = 50 that is
// 0.034 GB (0.010 ms) against 7.8e8 operations (0.012 ms), bound by the
// FP32 rate; the 4x4 algebra unrolls in full and stays in registers.
#include <cstdint>

#include "dp_step.cuh"
#include "dtype.cuh"
#include "team_mat.cuh"
#include "team_stage.cuh"
#include "tile_model.cuh"

namespace {

using rq::team::kTeamLanes;
using rq::team::kTeams;

struct StepArgs {
  int B, T;
  rq::Params p;
  const void *l, *x0, *W, *W_inv, *logdet_W, *theta, *mu;
  void *x, *value, *L, *dl;
  bool *m_fail, *h_fail;
};

template <typename T, template <typename> class Model>
__global__ void __launch_bounds__(128) step_kernel(const StepArgs a) {
  using Mod = Model<T>;
  constexpr int N = Mod::N, M = Mod::M;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int64_t B = a.B;
  const Mod model(a.p);
  const T* l = static_cast<const T*>(a.l);
  const T* Ws = static_cast<const T*>(a.W);
  const T* Wis = static_cast<const T*>(a.W_inv);
  const T* ldWs = static_cast<const T*>(a.logdet_W);
  T* xs = static_cast<T*>(a.x);
  T* Lo = static_cast<T*>(a.L);
  T* dlo = static_cast<T*>(a.dl);

  // Forward: open-loop rollout u_t = l_t from x0.
  T x[N], u[M];
#pragma unroll (rq::Unroll<N>::value)
  for (int i = 0; i < N; ++i) {
    x[i] = static_cast<const T*>(a.x0)[i * B + b];
    xs[i * B + b] = x[i];
  }
  for (int t = 0; t < a.T; ++t) {
#pragma unroll (rq::Unroll<M>::value)
    for (int j = 0; j < M; ++j) u[j] = l[(t * M + j) * B + b];
    T xn[N];
    model.f(x, u, xn);
#pragma unroll (rq::Unroll<N>::value)
    for (int i = 0; i < N; ++i) {
      x[i] = xn[i];
      xs[((t + 1) * N + i) * B + b] = x[i];
    }
  }

  // Backward: optimizing DP with the model blocks recomputed per step.
  T s, sv[N], S[N][N];
  model.term(x, s, sv, S);
  const T theta = static_cast<const T*>(a.theta)[b];
  const T mu = static_cast<const T*>(a.mu)[b];
  bool m_fail = false, h_fail = false;
  for (int t = a.T - 1; t >= 0; --t) {
#pragma unroll (rq::Unroll<N>::value)
    for (int i = 0; i < N; ++i) x[i] = xs[(t * N + i) * B + b];
#pragma unroll (rq::Unroll<M>::value)
    for (int j = 0; j < M; ++j) u[j] = l[(t * M + j) * B + b];
    T q, qv[N], Q[N][N], r[M], R[M][M], P[M][N], A[N][N], Bm[N][M];
    model.jac(x, u, A, Bm);
    model.quad(t, x, u, q, qv, Q, r, R, P);
    T W[N][N], Wi[N][N];
#pragma unroll (rq::Unroll<N>::value)
    for (int i = 0; i < N; ++i)
#pragma unroll (rq::Unroll<N>::value)
      for (int j = 0; j < N; ++j) {
        W[i][j] = Ws[(t * N + i) * N + j];
        Wi[i][j] = Wis[(t * N + i) * N + j];
      }
    T L[M][N], dl[M], g[M], G[M][N], H[M][M];
    rq::dp_step<T, N, M, true>(q, qv, Q, r, R, P, A, Bm, W, Wi, ldWs[t], theta, mu, L, dl, g,
                               G, H, s, sv, S, m_fail, h_fail);
#pragma unroll (rq::Unroll<M>::value)
    for (int i = 0; i < M; ++i) {
      dlo[(t * M + i) * B + b] = dl[i];
#pragma unroll (rq::Unroll<N>::value)
      for (int j = 0; j < N; ++j) Lo[((int64_t(t) * M + i) * N + j) * B + b] = L[i][j];
    }
  }
  static_cast<T*>(a.value)[b] = s;
  a.m_fail[b] = m_fail;
  a.h_fail[b] = h_fail;
}

// ---- One solve per team (N > rq::kUnrollMax: the quadrotor) ----

// One team's working set in shared memory: the carry (s⃗, S), the model
// blocks (q⃗, Q, A, B, r, R, P), dp_step's outputs (L, dl, g, G, H) and
// scratch, the staged x_t (x[0]; the forward phase ping-pongs x_t in x)
// and l_t (u).
template <typename T, int N, int M>
struct StepTeam {
  T S[N][N], Q[N][N], A[N][N];
  rq::team::DpScratch<T, N, M> d;
  T Bm[N][M], P[M][N], L[M][N], G[M][N], R[M][M], H[M][M];
  T x[2][N], qv[N], sv[N], u[M], r[M], g[M], dl[M];
};

template <typename T, int N, int M, int K>
using StepBlock = rq::team::BlockSmem<T, N, StepTeam<T, N, M>, K>;

// The same step as step_kernel, one solve per team: the forward rollout
// (one lane calls model.f on the team's shared x_t), then per step the
// model blocks (one lane calls model.jac and model.quad) and
// rq::team::dp_step.  The register budget is that of the blocks the shared
// memory lets an SM hold, but no less than the 80 registers a thread (160
// in f64) the step uses; in f32 it keeps the sin/cos range reduction's
// slow path in registers (a 0 B stack frame, 32 B without the bound).
template <typename T, template <typename> class Model, int Lanes, int K>
__global__ void __launch_bounds__(
    Lanes * K, rq::team::resident_blocks(sizeof(StepBlock<T, Model<T>::N, Model<T>::M, K>),
                                         Lanes * K, 20 * int(sizeof(T))))
    step_team_kernel(const StepArgs a) {
  using Mod = Model<T>;
  constexpr int N = Mod::N, M = Mod::M;
  using Team = StepTeam<T, N, M>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<StepBlock<T, N, M, K>*>(smem_raw);
  const int lane = threadIdx.x % Lanes, k = threadIdx.x / Lanes;
  const int b0 = blockIdx.x * K, b = b0 + k;
  const bool live = b < a.B;   // a team past the bank keeps every barrier
  const int64_t B = a.B, bc = live ? b : a.B - 1;
  Team& tm = sm.team[k];
  const Mod model(a.p);
  const T* l = static_cast<const T*>(a.l);
  const T* Ws = static_cast<const T*>(a.W);
  const T* Wis = static_cast<const T*>(a.W_inv);
  const T* ldWs = static_cast<const T*>(a.logdet_W);
  T* xs = static_cast<T*>(a.x);
  T* Lo = static_cast<T*>(a.L);
  T* dlo = static_cast<T*>(a.dl);

  // Forward: open-loop rollout u_t = l_t from x0, x_t ping-ponging in tm.x.
  if (lane < N) {
    tm.x[0][lane] = static_cast<const T*>(a.x0)[lane * B + bc];
    if (live) xs[lane * B + b] = tm.x[0][lane];
  }
  int cur = 0;
  for (int t = 0; t < a.T; ++t) {
    __syncthreads();
    rq::team::stage<M>(l, t, B, b0, sm.team, &Team::u);
    __syncthreads();
    if (lane == 0) model.f(tm.x[cur], tm.u, tm.x[1 - cur]);
    __syncwarp();
    cur = 1 - cur;
    if (lane < N && live) xs[((t + 1) * N + lane) * B + b] = tm.x[cur][lane];
  }
  __syncwarp();

  // Backward: optimizing DP with the model blocks recomputed per step.
  T s = T(0), q = T(0);   // lane 0's
  if (lane == 0) model.term(tm.x[cur], s, tm.sv, tm.S);
  const T theta = static_cast<const T*>(a.theta)[bc];
  const T mu = static_cast<const T*>(a.mu)[bc];
  bool m_fail = false, h_fail = false;
  for (int t = a.T - 1; t >= 0; --t) {
    __syncthreads();
    if (t + 1 < a.T) {   // the gains of step t+1
      rq::team::unstage<M * N>(Lo, t + 1, B, b0, sm.team, &Team::L);
      rq::team::unstage<M>(dlo, t + 1, B, b0, sm.team, &Team::dl);
    }
    rq::team::stage<N>(xs, t, B, b0, sm.team, &Team::x);   // into x[0]
    rq::team::stage<M>(l, t, B, b0, sm.team, &Team::u);
    rq::team::stage_noise(sm, Ws, Wis, ldWs, t);
    __syncthreads();
    const T (&x)[N] = tm.x[0];
    if (lane == 0) {
      model.jac(x, tm.u, tm.A, tm.Bm);
      model.quad(t, x, tm.u, q, tm.qv, tm.Q, tm.r, tm.R, tm.P);
    }
    __syncwarp();
    rq::team::dp_step<T, N, M, Lanes, true>(lane, q, tm.qv, tm.Q, tm.r, tm.R, tm.P, tm.A, tm.Bm,
                                            sm.W, sm.Wi, sm.ldW, theta, mu, tm.L, tm.dl, tm.g,
                                            tm.G, tm.H, s, tm.sv, tm.S, m_fail, h_fail, tm.d);
  }
  __syncthreads();
  if (a.T > 0) {
    rq::team::unstage<M * N>(Lo, 0, B, b0, sm.team, &Team::L);
    rq::team::unstage<M>(dlo, 0, B, b0, sm.team, &Team::dl);
  }
  if (live && lane == 0) {
    static_cast<T*>(a.value)[b] = s;
    a.m_fail[b] = m_fail;
    a.h_fail[b] = h_fail;
  }
}

// Dynamic shared memory of one team-kernel block (0: one solve per thread).
template <typename T, template <typename> class Model>
constexpr int team_smem_bytes() {
  using Mod = Model<T>;
  return Mod::N > rq::kUnrollMax ? int(sizeof(StepBlock<T, Mod::N, Mod::M, kTeams>)) : 0;
}

// One solve per thread for the small models, whose working set fits in
// registers; one solve per team of kTeamLanes lanes above kUnrollMax.
template <typename T, template <typename> class Model>
int launch(const StepArgs& a, cudaStream_t stream) {
  if constexpr (Model<T>::N > rq::kUnrollMax) {
    constexpr int bytes = team_smem_bytes<T, Model>();
    const auto kernel = step_team_kernel<T, Model, kTeamLanes, kTeams>;
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    kernel<<<(a.B + kTeams - 1) / kTeams, kTeamLanes * kTeams, bytes, stream>>>(a);
  } else {
    const int threads = 128;
    step_kernel<T, Model><<<(a.B + threads - 1) / threads, threads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
int dispatch(int model, const StepArgs& a, cudaStream_t stream) {
  if (model == rq::kUnicycle) return launch<T, rq::Unicycle>(a, stream);
  if (model == rq::kLqr) return launch<T, rq::Lqr>(a, stream);
  if (model == rq::kQuadrotor) return launch<T, rq::Quadrotor>(a, stream);
  if (model == rq::kCartpole) return launch<T, rq::Cartpole>(a, stream);
  return -1;
}

}  // namespace

// model: a rq::ModelId whose parameters are the host array
// params[rq::kMaxParams].  Arrays are lane-minor, of type Real.  Returns
// cudaGetLastError() after the launch, or -1 for an unsupported model.
extern "C" int RQ_ENTRY(ratilqr_step)(int model, int B, int T, const double* params,
                                      const void* l, const void* x0, const void* W,
                                      const void* W_inv, const void* logdet_W,
                                      const void* theta, const void* mu, void* x, void* value,
                                      void* L, void* dl, void* m_fail, void* h_fail,
                                      void* stream) {
  if (B <= 0) return 0;
  StepArgs a{B, T, {}, l, x0, W, W_inv, logdet_W, theta, mu, x, value, L, dl,
             static_cast<bool*>(m_fail), static_cast<bool*>(h_fail)};
  for (int i = 0; i < rq::kMaxParams; ++i) a.p[i] = params[i];
  return dispatch<Real>(model, a, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory a block of kernel B takes on `model` (0 for one
// solve per thread, -1 for an unsupported model); its teams per block and
// lanes per team.
extern "C" int RQ_ENTRY(ratilqr_step_smem)(int model, int* teams_per_block, int* lanes_per_team) {
  *teams_per_block = kTeams;
  *lanes_per_team = kTeamLanes;
  if (model == rq::kUnicycle) return team_smem_bytes<Real, rq::Unicycle>();
  if (model == rq::kLqr) return team_smem_bytes<Real, rq::Lqr>();
  if (model == rq::kQuadrotor) return team_smem_bytes<Real, rq::Quadrotor>();
  if (model == rq::kCartpole) return team_smem_bytes<Real, rq::Cartpole>();
  return -1;
}
