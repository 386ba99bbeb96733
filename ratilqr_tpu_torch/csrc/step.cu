// Kernel B: the fused iLEQG step — open-loop rollout, quadratization and
// the policy-optimizing Riccati pass in one kernel.
//
// Replaces ratilqr_tpu/ops/step_pallas.py:_step_opt_kernel (:81), reached
// through step_optimize_bank (:197).  Per-example meaning: the open-loop
// rollout of l from x0 with Jacobians, approximate_model, and one slim
// optimizing pass (step_pallas.py:341-346).  μ-restarts stay outside, in
// ratilqr_tpu_torch/ops/riccati.py:mu_restart_loop, as on the TPU.
//
// Design: one solve per thread.  The forward phase rolls x forward in
// registers and writes the T+1 states to the output buffer x (lane-minor,
// (T+1, n, B)); the backward phase walks it back, recomputes A, B and the
// cost derivatives from (x_t, l_t) with the device tile model
// (tile_model.cuh) and runs dp_step (dp_step.cuh).  Nothing but x, L, dl
// and the per-lane scalars touches device memory.
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
// the FP32 rate.  The 12x12 working set does not fit the 255 registers of
// a thread, so ptxas spills; a layout that spreads one solve over a warp
// is later work.
//
// At n=4, m=1 (the cartpole) a step moves 1 + 4 + 4 + 1 + 1 words per lane
// against ~950 operations of DP algebra: at B = 16,384 and T = 50 that is
// 0.034 GB (0.010 ms) against 7.8e8 operations (0.012 ms), bound by the
// FP32 rate; the 4x4 algebra unrolls in full and stays in registers.
#include <cstdint>

#include "dp_step.cuh"
#include "dtype.cuh"
#include "tile_model.cuh"

namespace {

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

template <typename T>
int dispatch(int model, const StepArgs& a, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (a.B + threads - 1) / threads;
  if (model == rq::kUnicycle)
    step_kernel<T, rq::Unicycle><<<blocks, threads, 0, stream>>>(a);
  else if (model == rq::kLqr)
    step_kernel<T, rq::Lqr><<<blocks, threads, 0, stream>>>(a);
  else if (model == rq::kQuadrotor)
    step_kernel<T, rq::Quadrotor><<<blocks, threads, 0, stream>>>(a);
  else if (model == rq::kCartpole)
    step_kernel<T, rq::Cartpole><<<blocks, threads, 0, stream>>>(a);
  else
    return -1;
  return cudaGetLastError();
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
