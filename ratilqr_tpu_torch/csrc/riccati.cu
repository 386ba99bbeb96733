// Kernel A: the batched risk-sensitive Riccati backward pass.
//
// Replaces ratilqr_tpu/ops/riccati_pallas.py:_riccati_kernel (:193),
// reached through riccati_bank (:382).  Every static variant of the Pallas
// kernel is here: optimizing or evaluating (template OPT), slim or full
// outputs, lane-invariant or per-lane noise model, with or without a dl
// stream (runtime flags, uniform across the grid).
//
// Design: one solve per thread (lane b = blockIdx.x·blockDim.x +
// threadIdx.x, early exit past B); the whole T-step backward loop runs
// inside the thread with the value-function carry (s, s⃗, S) and the
// latched fail flags in registers.  A CUDA grid gives no order between
// blocks, so unlike the Pallas grid (tiles, T) time is never a grid axis.
// Per-lane arrays are lane-minor, (T, ..., B), so the 32 threads of a warp
// read 32 consecutive words per element; a shared noise model is one
// (T, n, n) buffer all lanes read (the TPU kept it in SMEM).
//
// Bound on the H100: the slim optimizing pass streams q, q⃗, Q, r, R, P, A,
// B in (1+3+9+2+4+6+9+6 = 40 words/step/lane for the unicycle) and L, dl
// out (8 words), against ~730 scalar operations per step and lane: about
// 4 operations per byte in f32.  At B = 262,144 and T = 100 that is
// ~5 GB moved (1.5 ms at 3.35 TB/s) against ~1.9e10 operations (~0.3 ms
// at the FP32 rate), so this kernel is bound by device memory.  The simple
// design does nothing beyond coalescing; the fused kernels (step.cu,
// candidate.cu) are the answer, since they stream 11-15 words instead.
#include <cstdint>

#include "dp_step.cuh"

namespace {

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
#pragma unroll
  for (int i = 0; i < N; ++i) {
    sv[i] = static_cast<const T*>(a.q_vec_term)[i * B + b];
#pragma unroll
    for (int j = 0; j < N; ++j) S[i][j] = static_cast<const T*>(a.Q_term)[(i * N + j) * B + b];
  }
  const T theta = static_cast<const T*>(a.theta)[b];
  const T mu = static_cast<const T*>(a.mu)[b];
  bool m_fail = false, h_fail = false;

  for (int t = a.T - 1; t >= 0; --t) {
    T qt = q[t * B + b], qv[N], Q[N][N], r[M], R[M][M], P[M][N], A[N][N], Bm[N][M];
    T W[N][N], Wi[N][N], ldW, L[M][N], dl[M], g[M], G[M][N], H[M][M];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      qv[i] = q_vec[(t * N + i) * B + b];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int64_t e = (int64_t(t) * N + i) * N + j;
        Q[i][j] = Qs[e * B + b];
        A[i][j] = As[e * B + b];
        W[i][j] = a.w_shared ? Ws[e] : Ws[e * B + b];
        Wi[i][j] = a.w_shared ? Wis[e] : Wis[e * B + b];
      }
#pragma unroll
      for (int j = 0; j < M; ++j) Bm[i][j] = Bs[((int64_t(t) * N + i) * M + j) * B + b];
    }
    ldW = a.w_shared ? ldWs[t] : ldWs[t * B + b];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      r[i] = r_[(t * M + i) * B + b];
#pragma unroll
      for (int j = 0; j < M; ++j) R[i][j] = Rs[((int64_t(t) * M + i) * M + j) * B + b];
#pragma unroll
      for (int j = 0; j < N; ++j) P[i][j] = Ps[((int64_t(t) * M + i) * N + j) * B + b];
    }
    if (!OPT) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        dl[i] = a.has_dl ? dl_in[(t * M + i) * B + b] : T(0);
#pragma unroll
        for (int j = 0; j < N; ++j) L[i][j] = L_in[((int64_t(t) * M + i) * N + j) * B + b];
      }
    }

    rq::dp_step<T, N, M, OPT>(qt, qv, Q, r, R, P, A, Bm, W, Wi, ldW, theta, mu, L, dl, g, G,
                              H, s, sv, S, m_fail, h_fail);

    if (OPT || !a.slim) {
      T* Lo = static_cast<T*>(a.L);
      T* dlo = static_cast<T*>(a.dl);
#pragma unroll
      for (int i = 0; i < M; ++i) {
        dlo[(t * M + i) * B + b] = dl[i];
#pragma unroll
        for (int j = 0; j < N; ++j) Lo[((int64_t(t) * M + i) * N + j) * B + b] = L[i][j];
      }
    }
    if (!a.slim) {
      static_cast<T*>(a.s)[t * B + b] = s;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        static_cast<T*>(a.s_vec)[(t * N + i) * B + b] = sv[i];
#pragma unroll
        for (int j = 0; j < N; ++j)
          static_cast<T*>(a.S)[((int64_t(t) * N + i) * N + j) * B + b] = S[i][j];
      }
#pragma unroll
      for (int i = 0; i < M; ++i) {
        static_cast<T*>(a.g)[(t * M + i) * B + b] = g[i];
#pragma unroll
        for (int j = 0; j < N; ++j)
          static_cast<T*>(a.G)[((int64_t(t) * M + i) * N + j) * B + b] = G[i][j];
#pragma unroll
        for (int j = 0; j < M; ++j)
          static_cast<T*>(a.H)[((int64_t(t) * M + i) * M + j) * B + b] = H[i][j];
      }
    }
  }
  static_cast<T*>(a.value)[b] = s;  // the t = 0 value
  a.m_fail[b] = m_fail;
  a.h_fail[b] = h_fail;
}

template <typename T, int N, int M>
cudaError_t launch(const RiccatiArgs& a, int optimizing, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (a.B + threads - 1) / threads;
  if (optimizing)
    riccati_kernel<T, N, M, true><<<blocks, threads, 0, stream>>>(a);
  else
    riccati_kernel<T, N, M, false><<<blocks, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int n, int m, const RiccatiArgs& a, int optimizing, cudaStream_t stream) {
  if (n == 3 && m == 2) return launch<T, 3, 2>(a, optimizing, stream);
  if (n == 2 && m == 2) return launch<T, 2, 2>(a, optimizing, stream);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  Returns cudaGetLastError() after the
// launch, or -1 for an unsupported (dtype, n, m).  All arrays are
// lane-minor; unused pointers may be null.
extern "C" int ratilqr_riccati(int dtype, int n, int m, int B, int T, int optimizing, int slim,
                               int w_shared, int has_dl, const void* q, const void* q_vec,
                               const void* Q, const void* r, const void* R, const void* P,
                               const void* A, const void* Bm, const void* W, const void* W_inv,
                               const void* logdet_W, const void* q_term, const void* q_vec_term,
                               const void* Q_term, const void* theta, const void* mu,
                               const void* L_in, const void* dl_in, void* value, void* s,
                               void* s_vec, void* S, void* g, void* G, void* H, void* L,
                               void* dl, void* m_fail, void* h_fail, void* stream) {
  if (B <= 0) return 0;
  const RiccatiArgs a{B,      T,        slim,     w_shared,   has_dl, q,
                      q_vec,  Q,        r,        R,          P,      A,
                      Bm,     W,        W_inv,    logdet_W,   q_term, q_vec_term,
                      Q_term, theta,    mu,       L_in,       dl_in,  value,
                      s,      s_vec,    S,        g,          G,      H,
                      L,      dl,       static_cast<bool*>(m_fail), static_cast<bool*>(h_fail)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(n, m, a, optimizing, st);
  if (dtype == 1) return dispatch<double>(n, m, a, optimizing, st);
  return -1;
}
