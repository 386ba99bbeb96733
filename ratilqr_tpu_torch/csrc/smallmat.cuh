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
//
// Contraction policy.  nvcc fuses a product and a sum written as a·b + c
// into one multiply-add (one rounding, not two) wherever it likes; the
// plain versions round every product and every sum.  Most of the algebra
// may differ so: the tolerances cover it.  A fail flag may not: on a lane
// near neurotic breakdown the sign of M's last pivot, and so m_fail, comes
// out of those roundings.  So where the PSD decisions are made, the kernels
// round each product and each sum on their own, with the _rn intrinsics,
// which nvcc never contracts (mul_rn, add_rn, sub_rn; madd and msub below):
//   - kFactor, in every design: M = W⁻¹ − θS, formed for its factor
//     (dp_step.cuh:m_factor, small_team.cuh:m_factor, team_mat.cuh:
//     m_factor), and the pivot sums of every Cholesky factor (chol here,
//     which also factors H and so decides h_fail; team_mat.cuh:chol_rows);
//   - kCarry, in the few-lane algebra at n ≤ 4 (small_team.cuh): also
//     the rest of the DP step, whose products carry S_{t+1} into S_t and
//     so into the next step's M: the solves with M's factor, D, DS and
//     AᵀDS·A (and in the optimizing step BᵀDS, G, H, H's solves and the
//     gain terms).
// Each kernel source takes the level its fail flags need (the default
// here, kFactor, or kCarry: candidate.cu), measured on the fixture that
// showed the fault, the cartpole at T = 20, B = 33,793 in float32
// (python -m ratilqr_tpu_torch.team_sweep flags; PERF.md §7): kernel C at
// kFactor kept m_fail False on lane 1062 (θ = 0.05) where the plain
// float32 version and float64 latch it, and agreed at kCarry, as a build
// without any contraction did; kernel B's and A's flags agreed at every
// level.  Kernel D's few-lane kernel (riccati_folded.cu) also kept that
// lane False at kFactor and agreed at kCarry, but at kCarry its float32
// value left the drift rule on a lane of another near-breakdown fixture,
// so it stays at kFactor.  On lane 1062 M's smallest eigenvalue in
// float64 is within float32's rounding of M's entries of 0, which no
// float32 carry decides (PERF.md §7).
// kCarry costs kernel B 2-5% at its widest banks (its whole optimizing
// step loses its multiply-adds), so B stays at kFactor.  The model calls,
// the fold and the value's sums stay nvcc's.  -DRQ_PSD_ROUNDING=0|1|2
// builds a source with the policy off, at kFactor or at kCarry, for
// team_sweep to time and check.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#ifndef RQ_PSD_ROUNDING
#define RQ_PSD_ROUNDING 1
#endif

namespace rq {

// The sites of the contraction policy (kFree: none, as written).
enum Psd { kFree = 0, kFactor = 1, kCarry = 2 };
static_assert(RQ_PSD_ROUNDING >= 0 && RQ_PSD_ROUNDING <= 2, "policy off, kFactor or kCarry");

// Whether the build rounds the products and sums of `site` one by one.
template <int site>
constexpr bool kRounded = site != kFree && site <= RQ_PSD_ROUNDING;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// a + b·c and a − b·c: the product rounded before the sum where the policy
// covers `site`, else as written.
template <int site, typename T>
__device__ __forceinline__ T madd(T a, T b, T c) {
  if constexpr (kRounded<site>)
    return add_rn(a, mul_rn(b, c));
  else
    return a + b * c;
}
template <int site, typename T>
__device__ __forceinline__ T msub(T a, T b, T c) {
  if constexpr (kRounded<site>)
    return sub_rn(a, mul_rn(b, c));
  else
    return a - b * c;
}

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
      for (int k = 0; k < j; ++k) acc = msub<kFactor>(acc, L[i][k], L[j][k]);
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
template <typename T, int N, int site = kFree>
__device__ __forceinline__ void cho_solve_vec(const T (&L)[N][N], const T (&b)[N],
                                              T (&x)[N]) {
  T y[N];
#pragma unroll (rq::Unroll<N>::value)
  for (int i = 0; i < N; ++i) {
    T acc = b[i];
#pragma unroll (rq::Unroll<N>::value)
    for (int k = 0; k < i; ++k) acc = msub<site>(acc, L[i][k], y[k]);
    y[i] = acc / L[i][i];
  }
#pragma unroll (rq::Unroll<N>::value)
  for (int i = N - 1; i >= 0; --i) {
    T acc = y[i];
#pragma unroll (rq::Unroll<N>::value)
    for (int k = i + 1; k < N; ++k) acc = msub<site>(acc, L[k][i], x[k]);
    x[i] = acc / L[i][i];
  }
}

// X = M⁻¹ B column by column; B is N×P.
template <typename T, int N, int P, int site = kFree>
__device__ __forceinline__ void cho_solve_mat(const T (&L)[N][N], const T (&B)[N][P],
                                              T (&X)[N][P]) {
#pragma unroll (rq::Unroll<P>::value)
  for (int j = 0; j < P; ++j) {
    T b[N], x[N];
#pragma unroll (rq::Unroll<N>::value)
    for (int i = 0; i < N; ++i) b[i] = B[i][j];
    cho_solve_vec<T, N, site>(L, b, x);
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
template <typename T, int P, int Q, int R, int site = kFree>
__device__ __forceinline__ void mm(const T (&A)[P][Q], const T (&B)[Q][R], T (&C)[P][R]) {
#pragma unroll (rq::Unroll<P>::value)
  for (int i = 0; i < P; ++i)
#pragma unroll (rq::Unroll<R>::value)
    for (int j = 0; j < R; ++j) {
      T acc = A[i][0] * B[0][j];
#pragma unroll (rq::Unroll<Q>::value)
      for (int k = 1; k < Q; ++k) acc = madd<site>(acc, A[i][k], B[k][j]);
      C[i][j] = acc;
    }
}

// C = Aᵀ B  (A: Q×P, B: Q×R).
template <typename T, int Q, int P, int R, int site = kFree>
__device__ __forceinline__ void mtm(const T (&A)[Q][P], const T (&B)[Q][R], T (&C)[P][R]) {
#pragma unroll (rq::Unroll<P>::value)
  for (int i = 0; i < P; ++i)
#pragma unroll (rq::Unroll<R>::value)
    for (int j = 0; j < R; ++j) {
      T acc = A[0][i] * B[0][j];
#pragma unroll (rq::Unroll<Q>::value)
      for (int k = 1; k < Q; ++k) acc = madd<site>(acc, A[k][i], B[k][j]);
      C[i][j] = acc;
    }
}

// y = A v  (A: P×Q).
template <typename T, int P, int Q, int site = kFree>
__device__ __forceinline__ void mv(const T (&A)[P][Q], const T (&v)[Q], T (&y)[P]) {
#pragma unroll (rq::Unroll<P>::value)
  for (int i = 0; i < P; ++i) {
    T acc = A[i][0] * v[0];
#pragma unroll (rq::Unroll<Q>::value)
    for (int k = 1; k < Q; ++k) acc = madd<site>(acc, A[i][k], v[k]);
    y[i] = acc;
  }
}

// y = Aᵀ v  (A: Q×P).
template <typename T, int Q, int P, int site = kFree>
__device__ __forceinline__ void mtv(const T (&A)[Q][P], const T (&v)[Q], T (&y)[P]) {
#pragma unroll (rq::Unroll<P>::value)
  for (int i = 0; i < P; ++i) {
    T acc = A[0][i] * v[0];
#pragma unroll (rq::Unroll<Q>::value)
    for (int k = 1; k < Q; ++k) acc = madd<site>(acc, A[k][i], v[k]);
    y[i] = acc;
  }
}

template <typename T, int N, int site = kFree>
__device__ __forceinline__ T dot(const T (&a)[N], const T (&b)[N]) {
  T acc = a[0] * b[0];
#pragma unroll (rq::Unroll<N>::value)
  for (int k = 1; k < N; ++k) acc = madd<site>(acc, a[k], b[k]);
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
