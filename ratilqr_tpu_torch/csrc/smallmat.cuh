// Closed-form small-matrix algebra for one solve per thread.
//
// Device counterpart of ratilqr_tpu_torch/ops/smallmat.py and of the
// Pallas helpers in ratilqr_tpu/ops/riccati_pallas.py:64-180 (_chol,
// _chol_ok_mask, _cho_solve_vec/_mat, _cho_logdet, _trace_prod).  Every
// matrix is a register array whose sizes are template constants, so all
// loops unroll.  The formulas follow smallmat.py in the same operation
// order, and divide by the pivot (no reciprocal diagonal): the kernels and
// their plain PyTorch versions then differ only by fused multiply-adds and
// the library's sqrt/log/sin/cos, which is what the f32 tolerances
// (value rtol 3e-5, gains rtol 1e-4) cover.
//
// Build WITHOUT --use_fast_math: the PSD test relies on sqrt of a negative
// giving NaN, on isfinite, and on pivots compared with 0.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rq {

// Loops over a dimension D of the algebra unroll in full up to
// kUnrollMax (the unicycle and LQR: every array stays in registers) and
// stay rolled above it (the n=12 quadrotor, whose 12x12 working set does
// not fit the 255 registers of a thread either way; rolled, its kernels
// build in seconds).
constexpr int kUnrollMax = 4;

template <int D>
struct Unroll {
  static constexpr int value = D <= kUnrollMax ? D : 1;
};

// Lower Cholesky factor; NaN entries when M is not positive definite.
template <typename T, int N>
__device__ __forceinline__ void chol(const T (&M)[N][N], T (&L)[N][N]) {
#pragma unroll (rq::Unroll<N>::value)
  for (int i = 0; i < N; ++i) {
#pragma unroll (rq::Unroll<N>::value)
    for (int j = 0; j < N; ++j) {
      if (j > i) {
        L[i][j] = T(0);
        continue;
      }
      T acc = M[i][j];
#pragma unroll (rq::Unroll<N>::value)
      for (int k = 0; k < j; ++k) acc = acc - L[i][k] * L[j][k];
      L[i][j] = (i == j) ? sqrt(acc) : acc / L[j][j];
    }
  }
}

// isposdef: every pivot finite and strictly positive.
template <typename T, int N>
__device__ __forceinline__ bool chol_ok(const T (&L)[N][N]) {
  bool ok = true;
#pragma unroll (rq::Unroll<N>::value)
  for (int i = 0; i < N; ++i) ok = ok && isfinite(L[i][i]) && (L[i][i] > T(0));
  return ok;
}

// x = M⁻¹ b from the Cholesky factor L of M.
template <typename T, int N>
__device__ __forceinline__ void cho_solve_vec(const T (&L)[N][N], const T (&b)[N],
                                              T (&x)[N]) {
  T y[N];
#pragma unroll (rq::Unroll<N>::value)
  for (int i = 0; i < N; ++i) {
    T acc = b[i];
#pragma unroll (rq::Unroll<N>::value)
    for (int k = 0; k < i; ++k) acc = acc - L[i][k] * y[k];
    y[i] = acc / L[i][i];
  }
#pragma unroll (rq::Unroll<N>::value)
  for (int i = N - 1; i >= 0; --i) {
    T acc = y[i];
#pragma unroll (rq::Unroll<N>::value)
    for (int k = i + 1; k < N; ++k) acc = acc - L[k][i] * x[k];
    x[i] = acc / L[i][i];
  }
}

// X = M⁻¹ B column by column; B is N×P.
template <typename T, int N, int P>
__device__ __forceinline__ void cho_solve_mat(const T (&L)[N][N], const T (&B)[N][P],
                                              T (&X)[N][P]) {
#pragma unroll (rq::Unroll<P>::value)
  for (int j = 0; j < P; ++j) {
    T b[N], x[N];
#pragma unroll (rq::Unroll<N>::value)
    for (int i = 0; i < N; ++i) b[i] = B[i][j];
    cho_solve_vec<T, N>(L, b, x);
#pragma unroll (rq::Unroll<N>::value)
    for (int i = 0; i < N; ++i) X[i][j] = x[i];
  }
}

// log det M = 2 Σ log L_ii.
template <typename T, int N>
__device__ __forceinline__ T cho_logdet(const T (&L)[N][N]) {
  T acc = T(0);
#pragma unroll (rq::Unroll<N>::value)
  for (int i = 0; i < N; ++i) acc = acc + log(L[i][i]);
  return T(2) * acc;
}

// C = A B  (A: P×Q, B: Q×R).
template <typename T, int P, int Q, int R>
__device__ __forceinline__ void mm(const T (&A)[P][Q], const T (&B)[Q][R], T (&C)[P][R]) {
#pragma unroll (rq::Unroll<P>::value)
  for (int i = 0; i < P; ++i)
#pragma unroll (rq::Unroll<R>::value)
    for (int j = 0; j < R; ++j) {
      T acc = A[i][0] * B[0][j];
#pragma unroll (rq::Unroll<Q>::value)
      for (int k = 1; k < Q; ++k) acc = acc + A[i][k] * B[k][j];
      C[i][j] = acc;
    }
}

// C = Aᵀ B  (A: Q×P, B: Q×R).
template <typename T, int Q, int P, int R>
__device__ __forceinline__ void mtm(const T (&A)[Q][P], const T (&B)[Q][R], T (&C)[P][R]) {
#pragma unroll (rq::Unroll<P>::value)
  for (int i = 0; i < P; ++i)
#pragma unroll (rq::Unroll<R>::value)
    for (int j = 0; j < R; ++j) {
      T acc = A[0][i] * B[0][j];
#pragma unroll (rq::Unroll<Q>::value)
      for (int k = 1; k < Q; ++k) acc = acc + A[k][i] * B[k][j];
      C[i][j] = acc;
    }
}

// y = A v  (A: P×Q).
template <typename T, int P, int Q>
__device__ __forceinline__ void mv(const T (&A)[P][Q], const T (&v)[Q], T (&y)[P]) {
#pragma unroll (rq::Unroll<P>::value)
  for (int i = 0; i < P; ++i) {
    T acc = A[i][0] * v[0];
#pragma unroll (rq::Unroll<Q>::value)
    for (int k = 1; k < Q; ++k) acc = acc + A[i][k] * v[k];
    y[i] = acc;
  }
}

// y = Aᵀ v  (A: Q×P).
template <typename T, int Q, int P>
__device__ __forceinline__ void mtv(const T (&A)[Q][P], const T (&v)[Q], T (&y)[P]) {
#pragma unroll (rq::Unroll<P>::value)
  for (int i = 0; i < P; ++i) {
    T acc = A[0][i] * v[0];
#pragma unroll (rq::Unroll<Q>::value)
    for (int k = 1; k < Q; ++k) acc = acc + A[k][i] * v[k];
    y[i] = acc;
  }
}

template <typename T, int N>
__device__ __forceinline__ T dot(const T (&a)[N], const T (&b)[N]) {
  T acc = a[0] * b[0];
#pragma unroll (rq::Unroll<N>::value)
  for (int k = 1; k < N; ++k) acc = acc + a[k] * b[k];
  return acc;
}

// M ← ½(M + Mᵀ).
template <typename T, int N>
__device__ __forceinline__ void sym_inplace(T (&M)[N][N]) {
#pragma unroll (rq::Unroll<N>::value)
  for (int i = 0; i < N; ++i)
#pragma unroll (rq::Unroll<N>::value)
    for (int j = i + 1; j < N; ++j) {
      const T v = T(0.5) * (M[i][j] + M[j][i]);
      M[i][j] = v;
      M[j][i] = v;
    }
}

}  // namespace rq
