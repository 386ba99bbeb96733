// Kernel A: the batched risk-sensitive Riccati backward pass.
//
// Replaces ratilqr_tpu/ops/riccati_pallas.py:_riccati_kernel (:193),
// reached through riccati_bank (:382).  Every static variant of the Pallas
// kernel is here: optimizing or evaluating (template OPT), slim or full
// outputs, lane-invariant or per-lane noise model, with or without a dl
// stream (runtime flags, uniform across the grid).
//
// Two designs, chosen per shape at compile time (launch()):
//
// One solve per thread (riccati_kernel; n ≤ kUnrollMax, or shapes a team
// does not take): lane b = blockIdx.x·blockDim.x + threadIdx.x, early exit
// past B; the whole T-step backward loop runs inside the thread with the
// value-function carry (s, s⃗, S) and the latched fail flags in
// registers.  A CUDA grid gives no order between blocks, so unlike the
// Pallas grid (tiles, T) time is never a grid axis.  Per-lane arrays are
// lane-minor, (T, ..., B), so the 32 threads of a warp read 32
// consecutive words per element; a shared noise model is one (T, n, n)
// buffer all lanes read (the TPU kept it in SMEM).
//
// One solve per team (riccati_team_kernel; kUnrollMax < n, m ≤ kUnrollMax
// and n + m ≤ kTeamLanes: the quadrotor (12, 4), and shapes such as (6, 3)
// built at first use): the same recursion spread over a team of 16 lanes
// (two teams a warp) with rq::team::dp_step (team_mat.cuh), optimizing or
// evaluating, K = kTeams = 8 teams a block on 8 consecutive lanes b
// (team_stage.cuh).  Each team keeps its working set in shared memory: the
// carry (s⃗, S), dp_step's scratch and outputs (L, dl, g, G, H), θ and μ,
// and the step's streamed blocks (q, q⃗, Q, r, R, P, A, B; evaluating:
// L_t and dl_t; a per-lane noise model: W_t, W⁻¹_t, logdet W_t), which the
// block stages from the lane-minor inputs in one coalesced pass a step.
// With kBuffers = 2 the streamed blocks are double-buffered: while the
// teams run step t, the block's cp.async copies bring step t − 1 into the
// other buffer.  The per-step outputs (L, dl; full: s, s⃗, S, g, G, H)
// leave in one coalesced pass at the top of the next step.  Two block
// barriers a step.  A team past the end of the bank reads lane B − 1,
// keeps every barrier and stores nothing.
//
// Bound on the H100: the slim optimizing pass streams q, q⃗, Q, r, R, P, A,
// B in (1+3+9+2+4+6+9+6 = 40 words/step/lane for the unicycle) and L, dl
// out (8 words), against ~730 scalar operations per step and lane: about
// 4 operations per byte in f32.  At B = 262,144 and T = 100 that is
// ~5 GB moved (1.5 ms at 3.35 TB/s) against ~1.9e10 operations (~0.3 ms
// at the FP32 rate), so this kernel is bound by device memory.  The simple
// design does nothing beyond coalescing; the fused kernels (step.cu,
// candidate.cu) are the answer, since they stream 11-15 words instead.
//
// At n=12, m=4 (the quadrotor) a step streams 417 words in and 52 out
// (1.9 KB per lane in f32) against ~22,600 operations: at B = 16,384 and
// T = 50 that is 1.55 GB (0.46 ms) against 1.85e10 operations (0.28 ms),
// still bound by bytes on paper.  One solve per thread held S, A, Q, W, W⁻¹,
// M and D at 144 words each, far above the 255-register cap, in an 8.8 KB
// stack frame whose local-memory traffic, not the streamed blocks, set
// the time: hence the team design.
//
// At n=4, m=1 (the cartpole) a step streams 47 words in and 5 out against
// ~950 operations: at B = 16,384 and T = 50, 0.17 GB (0.051 ms) against
// 7.8e8 operations (0.012 ms), bound by bytes.  Shapes built at first use
// that a team does not take keep their loops rolled above kUnrollMax, so
// their n x n arrays live in the stack frame; ops/riccati_cuda.py:MAX_DIM
// is the largest n measured to build and agree.
#include <cstdint>
#include <type_traits>

#include "dp_step.cuh"
#include "dtype.cuh"
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

namespace {

using rq::team::kTeamLanes;
using rq::team::kTeams;
constexpr int kBuffers = RQ_STAGE_BUFFERS;
static_assert(kBuffers == 1 || kBuffers == 2, "one or two staging buffers");

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

template <int>
struct Nothing {};

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

// W_t, W⁻¹_t and logdet W_t.
template <typename T, int N>
struct Noise {
  T W[N][N], Wi[N][N], ldW;
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

// One solve per team for the shapes a team takes, one per thread
// otherwise.
template <typename T, int N, int M>
cudaError_t launch(const RiccatiArgs& a, int optimizing, cudaStream_t stream) {
  if constexpr (kTeamShape<N, M>) {
    if (optimizing)
      return a.w_shared ? launch_team<T, N, M, true, false>(a, stream)
                        : launch_team<T, N, M, true, true>(a, stream);
    return a.w_shared ? launch_team<T, N, M, false, false>(a, stream)
                      : launch_team<T, N, M, false, true>(a, stream);
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

// Dynamic shared memory a block of kernel A takes at (n, m) in the
// optimizing or evaluating pass with a shared or per-lane noise model (0
// for one solve per thread, -1 for an (n, m) not instantiated); its teams
// per block and lanes per team.
extern "C" int RQ_ENTRY(ratilqr_riccati_smem)(int n, int m, int optimizing, int w_shared,
                                              int* teams_per_block, int* lanes_per_team) {
  *teams_per_block = kTeams;
  *lanes_per_team = kTeamLanes;
  return with_shape(n, m, [&](auto shape) {
    using S = decltype(shape);
    if (optimizing)
      return w_shared ? team_smem_bytes<Real, S::N, S::M, true, false>()
                      : team_smem_bytes<Real, S::N, S::M, true, true>();
    return w_shared ? team_smem_bytes<Real, S::N, S::M, false, false>()
                    : team_smem_bytes<Real, S::N, S::M, false, true>();
  });
}
