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
// One solve per team of K lanes of a warp (n ≤ kUnrollMax: the unicycle,
// LQR, the cartpole; step_kernel, on small_team.cuh's dp_step), K = 4 or
// 1.  The forward phase rolls x forward in registers and writes the T+1
// states to the output buffer x (lane-minor, (T+1, n, B)); the backward
// phase walks it back, recomputes A, B and the cost derivatives from
// (x_t, l_t) with the device tile model (tile_model.cuh) and runs the
// optimizing DP step.  Every lane of a team rolls out and calls the model
// (cheaper than broadcasting ~40 words a step); lane r writes entries r,
// r + K, ... of x_{t+1}, takes the solves with M's factor for columns r,
// r + K, ... of M⁻¹[S | s⃗] and with H's factor for columns r, r + K, ...
// of −H⁻¹[G | g] (L and, as column n, dl, which it stores), and the rows
// r, r + K, ... of DS, AᵀDS·A and the carry's update; the rows go round by
// __shfl_sync(width = K).  Nothing but x, L, dl and the per-lane scalars
// touches device memory.  The launch picks K from B and the card's SM
// count by the rule kernel C shares (small_launch.cuh): 4 up to B = 16,896
// on 132 SMs, 1 above.  A block is 128 threads where K > 1 and 64 at
// K = 1, one solve per K of them, on consecutive lanes b, and takes no
// shared memory.  At every K the forward phase loads l_{t+1} during step
// t, and the backward phase computes the model blocks of step t − 1 (jac
// and quad, which do not depend on the carry) in the same iteration as
// the DP step of step t, so their loads and sin/cos fill the DP's chain;
// computed so at every K, the model runs in the same code and every K
// gives the same bits (with the blocks in step order at K = 1 the bits
// differed, by up to 9.3e-3 on a cartpole value in f32).  M, H and their
// factors follow the contraction policy at kFactor (smallmat.cuh).  A
// team past the end of the bank reads lane B − 1, keeps every shuffle and
// stores nothing.
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
// Bound on the H100 (kernel_check.bound_ms: the function's bytes, each
// input read once and each output written once, over 3.35 TB/s, against
// the DP's arithmetic, 652 operations a step and lane on the unicycle and
// 953 on the cartpole, over 67 TFLOP/s), f32: the unicycle at T = 100 and
// B = 262,144 moves 1.37 GB, 0.410 ms (bytes); at B = 16,384 0.026 ms; at
// T = 30 and B = 942 0.00045 ms, at RAT iLQR's T = 100, B = 10 0.00002 ms;
// the cartpole at T = 50 and B = 16,384 0.012 ms and at 262,144 0.186 ms
// (operations).  Below ~1,000 lanes no rate binds: one solve's dependent
// chain of 2T steps does.
//
// What held the per-thread design back, and what this one does about it
// (launch alone, f32, H100 80GB HBM3 at 700 W, the two in one call by
// python -m ratilqr_tpu_torch.team_sweep step --baseline; PERF.md §6):
//   - narrow banks (RAT iLQR's 10 lanes, RAT iLQR++'s and the fleets' 1
//     to 942): one warp paid each step's chain in turn — the forward
//     model.f, then per backward step jac, quad and the DP with its
//     factor, divisions, square roots and logs.  Four lanes a solve give
//     four times the warps, split the chain's longest parts (the solves
//     with M's and H's factors) and take the model blocks a step ahead:
//     T = 100, B = 10 0.445 against 0.79 ms; T = 30, B = 942 0.16-0.17
//     against 0.26-0.28 ms;
//   - B = 16,384: one warp a scheduler, latency-bound: the cartpole at
//     T = 50 0.41-0.46 against 0.52-0.54 ms (35x its bound);
//   - B = 262,144: issue-bound, and K = 1 is the per-thread algorithm with
//     the blocks a step ahead: a tie (unicycle T = 100 3.85-4.04 against
//     3.87-3.96 ms, cartpole T = 50 2.56-2.60 against 2.54-2.61 ms); its
//     registers (96 unicycle, 127 cartpole) leave the occupancy where it
//     was, at 64 threads a block or 128.
// Staging x, l and the noise model by cp.async in a ring of shared
// buffers, as kernel C does, lost 4-8% at K = 4 (B streams n + m words a
// lane and step, which the blocks ahead already hide; the ring costs a
// block barrier a step), so no step is staged.
//
// At n=12, m=4 (the quadrotor) a step moves 4 + 12 + 48 + 4 + 4 words per
// lane but runs ~22,600 operations of DP algebra: at B = 16,384 and T = 50
// that is 0.22 GB (0.07 ms) against 1.85e10 operations (0.28 ms), bound by
// the FP32 rate.  One solve per thread kept its 12x12 working set in a
// 10.0 KB stack frame, 164 MB of local memory at that width (more than the
// 50 MB L2), with 4 warps an SM: hence the team design above.
#include <cstdint>

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

struct StepArgs {
  int B, T;
  rq::Params p;
  const void *l, *x0, *W, *W_inv, *logdet_W, *theta, *mu;
  void *x, *value, *L, *dl;
  bool *m_fail, *h_fail;
};

// ---- One solve per team of K lanes (N ≤ rq::kUnrollMax) ----

// One step's model blocks: the cost's q, q⃗, Q, r, R, P and the dynamics'
// A and B at (x_t, l_t).
template <typename T, int N, int M>
struct Blocks {
  T q, qv[N], Q[N][N], r[M], R[M][M], P[M][N], A[N][N], Bm[N][M];
};

// The fused step, one solve per team of K lanes of a warp (K = 1: one per
// thread), on rq::small::dp_step.  Every lane rolls x out and calls the
// device model in registers; the lanes split the solves and products of
// the DP step.  The forward phase loads l_{t+1} during step t, and the
// backward phase is software-pipelined: the model blocks of step t − 1,
// which do not depend on the carry, are computed in the same iteration as
// the DP step of step t, so their loads and model calls fill the DP's
// dependent chain (at every K, so every K runs the model in the same code
// and gives the same bits).  Every team, live or not, keeps every shuffle.
template <typename T, template <typename> class Model, int K>
__global__ void __launch_bounds__(small_threads(K)) step_kernel(const StepArgs a) {
  using Mod = Model<T>;
  constexpr int N = Mod::N, M = Mod::M, Solves = small_threads(K) / K;
  constexpr int Rows = rq::small::kSlots<N, K>, Cols = rq::small::kSlots<N + 1, K>;
  const int lane = threadIdx.x % K, k = threadIdx.x / K;
  const bool live = blockIdx.x * Solves + k < a.B;   // a team past the bank stores nothing
  const int64_t B = a.B, b = live ? blockIdx.x * Solves + k : a.B - 1;
  const Mod model(a.p);
  const T* l = static_cast<const T*>(a.l);
  const T* Ws = static_cast<const T*>(a.W);
  const T* Wis = static_cast<const T*>(a.W_inv);
  const T* ldWs = static_cast<const T*>(a.logdet_W);
  T* xs = static_cast<T*>(a.x);
  T* Lo = static_cast<T*>(a.L);
  T* dlo = static_cast<T*>(a.dl);

  // l_t from device memory.
  const auto control = [&](int t, T (&u)[M]) {
#pragma unroll
    for (int j = 0; j < M; ++j) u[j] = l[(int64_t(t) * M + j) * B + b];
  };
  // Lane r stores entries r, r + K, ... of x_t.
  const auto store_x = [&](int t, const T (&x)[N]) {
#pragma unroll
    for (int r = 0; r < Rows; ++r) {
      const int i = lane + K * r;
      if (i < N && live) xs[(int64_t(t) * N + i) * B + b] = rq::small::pick<T, N>(x, i);
    }
  };

  // Forward: open-loop rollout u_t = l_t from x0.
  T x[N], u[M];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = static_cast<const T*>(a.x0)[i * B + b];
  store_x(0, x);
  if (a.T > 0) control(0, u);
  for (int t = 0; t < a.T; ++t) {
    T un[M], xn[N];
    control(t + 1 < a.T ? t + 1 : t, un);
    model.f(x, u, xn);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = xn[i];
    store_x(t + 1, x);
#pragma unroll
    for (int j = 0; j < M; ++j) u[j] = un[j];
  }

  // Backward: optimizing DP with the model blocks recomputed per step.
  T s, sv[N], S[N][N];
  model.term(x, s, sv, S);
  const T theta = static_cast<const T*>(a.theta)[b];
  const T mu = static_cast<const T*>(a.mu)[b];
  bool m_fail = false, h_fail = false;
  // Step t's model blocks, from (x_t, l_t) in device memory.
  const auto blocks = [&](int t, Blocks<T, N, M>& m) {
    T xt[N], ut[M];
#pragma unroll
    for (int i = 0; i < N; ++i) xt[i] = xs[(int64_t(t) * N + i) * B + b];
    control(t, ut);
    model.jac(xt, ut, m.A, m.Bm);
    model.quad(t, xt, ut, m.q, m.qv, m.Q, m.r, m.R, m.P);
  };
  // Lane r stores its columns of [L_t | dl_t].
  const auto store_gains = [&](int t, const T (&LX)[Cols][M]) {
#pragma unroll
    for (int c0 = 0; c0 < Cols; ++c0) {
      const int c = lane + K * c0;
      if (!live || c > N) continue;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (c < N)
          Lo[((int64_t(t) * M + i) * N + c) * B + b] = LX[c0][i];
        else
          dlo[(int64_t(t) * M + i) * B + b] = LX[c0][i];
      }
    }
  };
  __syncwarp();   // the team's x stores
  Blocks<T, N, M> f;
  if (a.T > 0) blocks(a.T - 1, f);
  for (int t = a.T - 1; t >= 0; --t) {
    Blocks<T, N, M> next;
    blocks(t > 0 ? t - 1 : 0, next);   // step 0's twice, so the body has no branch
    T W[N][N], Wi[N][N], LX[Cols][M];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        W[i][j] = Ws[(t * N + i) * N + j];
        Wi[i][j] = Wis[(t * N + i) * N + j];
      }
    rq::small::dp_step<T, N, M, K>(lane, f.q, f.qv, f.Q, f.r, f.R, f.P, f.A, f.Bm, W, Wi,
                                   ldWs[t], theta, mu, LX, s, sv, S, m_fail, h_fail);
    store_gains(t, LX);
    f = next;
  }
  if (live && lane == 0) {
    static_cast<T*>(a.value)[b] = s;
    a.m_fail[b] = m_fail;
    a.h_fail[b] = h_fail;
  }
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

// Dynamic shared memory of one team-kernel block (the quadrotor).
template <typename T, template <typename> class Model>
constexpr int team_smem_bytes() {
  using Mod = Model<T>;
  return int(sizeof(StepBlock<T, Mod::N, Mod::M, kTeams>));
}

template <typename T, template <typename> class Model, int K>
int launch_small(const StepArgs& a, cudaStream_t stream) {
  constexpr int solves = small_threads(K) / K;
  step_kernel<T, Model, K><<<(a.B + solves - 1) / solves, small_threads(K), 0, stream>>>(a);
  return cudaGetLastError();
}

// One solve per team of kTeamLanes lanes above kUnrollMax; one per team of
// small_lanes(B, SMs) lanes at n ≤ kUnrollMax.
template <typename T, template <typename> class Model>
int launch(const StepArgs& a, cudaStream_t stream) {
  if constexpr (Model<T>::N > rq::kUnrollMax) {
    constexpr int bytes = team_smem_bytes<T, Model>();
    const auto kernel = step_team_kernel<T, Model, kTeamLanes, kTeams>;
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    kernel<<<(a.B + kTeams - 1) / kTeams, kTeamLanes * kTeams, bytes, stream>>>(a);
    return cudaGetLastError();
  } else {
    return with_lanes(small_lanes(a.B, sm_count()),
                      [&](auto K) { return launch_small<T, Model, decltype(K)::value>(a, stream); });
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
    return 0;
  }
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

// The launch of kernel B on `model` for a bank of B lanes on the current
// device: returns the dynamic shared memory a block takes (-1 for an
// unsupported model) and sets the solves a block and the lanes a solve.
extern "C" int RQ_ENTRY(ratilqr_step_smem)(int model, int B, int* solves_per_block,
                                           int* lanes_per_solve) {
  int* const sb = solves_per_block;
  int* const ls = lanes_per_solve;
  if (model == rq::kUnicycle) return launch_shape<Real, rq::Unicycle>(B, sb, ls);
  if (model == rq::kLqr) return launch_shape<Real, rq::Lqr>(B, sb, ls);
  if (model == rq::kQuadrotor) return launch_shape<Real, rq::Quadrotor>(B, sb, ls);
  if (model == rq::kCartpole) return launch_shape<Real, rq::Cartpole>(B, sb, ls);
  return -1;
}
