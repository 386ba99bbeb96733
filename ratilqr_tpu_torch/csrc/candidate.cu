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
// Design: one solve per thread.  The forward phase rolls the policy
// u = l_cand + L(x − x̄) out in registers and stores the (T+1)·n states in
// a scratch buffer the wrapper allocates (lane-minor, (T+1, n, B)); the
// backward phase re-reads x_t, x̄_t, l_t and L_t, recomputes u, the model
// blocks and the fold
//   q̄_vec = q_vec + Lᵀr,  Q̄ = sym(Q + LᵀP + PᵀL + LᵀRL + μLᵀL),  Ā = A + BL
// and runs folded_step (dp_step.cuh).  Only value and m_fail are written.
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
#include <cstdint>

#include "dp_step.cuh"
#include "tile_model.cuh"

namespace {

struct CandidateArgs {
  int B, T;
  double p[4];
  const void *x_ref, *l_cand, *L, *W, *W_inv, *logdet_W, *theta, *mu;
  void *x_scratch, *value;
  bool* m_fail;
};

template <typename T, int N, int M>
__device__ __forceinline__ void policy(const T* xr, const T* lc, const T* Lg, int t, int64_t B,
                                       int b, const T (&x)[N], T (&u)[M], T (&L)[M][N]) {
  T dx[N];
#pragma unroll
  for (int i = 0; i < N; ++i) dx[i] = x[i] - xr[(t * N + i) * B + b];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) L[i][j] = Lg[((int64_t(t) * M + i) * N + j) * B + b];
    T acc = L[i][0] * dx[0];
#pragma unroll
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
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = xr[i * B + b];
    xs[i * B + b] = x[i];
  }
  for (int t = 0; t < a.T; ++t) {
    policy<T, N, M>(xr, lc, Lg, t, B, b, x, u, L);
    T xn[N];
    model.f(x, u, xn);
#pragma unroll
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
#pragma unroll
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
#pragma unroll
    for (int i = 0; i < N; ++i) {
      qv[i] = qv[i] + Ltr[i];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        Q[i][j] = Q[i][j] + LtP[i][j] + LtP[j][i] + LtRL[i][j] + mu * LtL[i][j];
        A[i][j] = A[i][j] + BL[i][j];
      }
    }
    rq::sym_inplace<T, N>(Q);

    T W[N][N], Wi[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        W[i][j] = Ws[(t * N + i) * N + j];
        Wi[i][j] = Wis[(t * N + i) * N + j];
      }
    rq::folded_step<T, N>(q, qv, Q, A, W, Wi, ldWs[t], theta, s, sv, S, m_fail);
  }
  static_cast<T*>(a.value)[b] = s;
  a.m_fail[b] = m_fail;
}

template <typename T>
int dispatch(int model, const CandidateArgs& a, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (a.B + threads - 1) / threads;
  if (model == rq::kUnicycle)
    candidate_kernel<T, rq::Unicycle><<<blocks, threads, 0, stream>>>(a);
  else if (model == rq::kLqr)
    candidate_kernel<T, rq::Lqr><<<blocks, threads, 0, stream>>>(a);
  else
    return -1;
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64; model: a rq::ModelId with parameters
// p0..p3.  Arrays are lane-minor; x_scratch holds (T+1)·n·B elements.
// Returns cudaGetLastError() after the launch, or -1 for an unsupported
// (dtype, model).
extern "C" int ratilqr_candidate(int dtype, int model, int B, int T, double p0, double p1,
                                 double p2, double p3, const void* x_ref, const void* l_cand,
                                 const void* L, const void* W, const void* W_inv,
                                 const void* logdet_W, const void* theta, const void* mu,
                                 void* x_scratch, void* value, void* m_fail, void* stream) {
  if (B <= 0) return 0;
  const CandidateArgs a{B,     T,     {p0, p1, p2, p3}, x_ref,    l_cand, L, W, W_inv, logdet_W,
                        theta, mu,    x_scratch,        value,    static_cast<bool*>(m_fail)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(model, a, st);
  if (dtype == 1) return dispatch<double>(model, a, st);
  return -1;
}
