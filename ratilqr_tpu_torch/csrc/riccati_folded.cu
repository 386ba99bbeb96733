// Kernel D: the value-only evaluating Riccati pass over a closed-loop-folded
// stack.
//
// Replaces ratilqr_tpu/ops/riccati_pallas.py:_riccati_folded_kernel (:581),
// reached through riccati_bank_folded (:669).  Per step it reads the folded
// blocks (q, q̄_vec, Q̄, Ā) of ratilqr_tpu/ops/approx.py:FoldedApprox and
// runs folded_step (dp_step.cuh), the step kernel C runs after refolding:
//   M = sym(W⁻¹ − θS) (a failed factor latches m_fail), D = I + θ(M⁻¹S)ᵀ,
//   s ← q + s + risk,  s⃗ ← q̄_vec + ĀᵀD s⃗,  S ← sym(Q̄ + ĀᵀD S Ā).
// The noise model is shared (T, n, n) or per lane (T, n, n, B).
//
// Design: one solve per thread, the T-step backward loop inside the thread
// with the carry (s, s⃗, S, m_fail) in registers; a CUDA grid gives no order
// between blocks, so unlike the Pallas grid (tiles, T) time is never a grid
// axis.  Per-lane arrays are lane-minor, (T, ..., B), so a warp's loads
// coalesce; a shared noise model is one buffer every lane reads (SMEM on
// the TPU, L1/L2-resident here).
//
// Bound on the H100: per step and lane it streams 1 + n + 2n² words (22 for
// the unicycle, 88 bytes in f32) against ~250 scalar operations (the 3x3
// factor, two solves, three 3x3 products): ~3 operations per byte, below
// the card's ~20 FP32 operations per byte of DRAM bandwidth.  At
// B = 262,144 and T = 100 that is ~2.3 GB, ~0.7 ms at 3.35 TB/s, so the
// kernel is bound by device memory; coalescing is all this simple form
// does about it.  Only value and m_fail are written.
//
// At n=12 (the quadrotor) a step streams 301 words (1.2 KB in f32) against
// ~16,200 operations: at B = 16,384 and T = 50, 1.0 GB (0.30 ms) against
// 1.33e10 operations (0.20 ms), bound by bytes on paper, with the 12x12
// carry and factors spilled out of the 255 registers of a thread.
//
// At n=4 (the cartpole) a step streams 37 words against ~750 operations: at
// B = 16,384 and T = 50, 0.12 GB (0.037 ms) against 6.1e8 operations
// (0.009 ms), bound by bytes.
#include <cstdint>

#include "dp_step.cuh"
#include "dtype.cuh"

namespace {

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

// As in riccati.cu: the shipped models' n here, any other n built at its
// first use from this file with -DRQ_SHAPE_N=n, holding that n alone.
template <typename T>
int dispatch(int n, const FoldedArgs& a, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (a.B + threads - 1) / threads;
#if defined(RQ_SHAPE_N)
  if (n == RQ_SHAPE_N)
    riccati_folded_kernel<T, RQ_SHAPE_N><<<blocks, threads, 0, stream>>>(a);
#else
  if (n == 3)
    riccati_folded_kernel<T, 3><<<blocks, threads, 0, stream>>>(a);
  else if (n == 2)
    riccati_folded_kernel<T, 2><<<blocks, threads, 0, stream>>>(a);
  else if (n == 4)
    riccati_folded_kernel<T, 4><<<blocks, threads, 0, stream>>>(a);
  else if (n == 12)
    riccati_folded_kernel<T, 12><<<blocks, threads, 0, stream>>>(a);
#endif
  else
    return -1;
  return cudaGetLastError();
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
  return dispatch<Real>(n, a, static_cast<cudaStream_t>(stream));
}
