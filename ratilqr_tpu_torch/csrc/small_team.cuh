// Small-matrix algebra for one solve per team of K lanes (K ∈ {1, 2, 4})
// at n ≤ kUnrollMax, every matrix in registers.
//
// The few-lane counterpart of dp_step.cuh's folded_step, as team_mat.cuh is
// the 16-lane one at n=12: the same formulas in the same operation order,
// so a team and one thread differ only by fused multiply-adds.  Every lane
// of a team holds the carry (s, s⃗, S), the fold (q̄, Ā, Q̄) and M's
// Cholesky factor in full; what is split is the work with long dependent
// chains or many products.  Lane r owns the rows and columns
// i = r, r + K, r + 2K, ... (slot i / K of its row arrays):
//   - the N + 1 solves with M's factor: column i of M⁻¹S (which is row i
//     of D = I + θ(M⁻¹S)ᵀ) and, as column N, M⁻¹s⃗;
//   - row i of DS, AᵀDS and AᵀDS·A, and entry i of Ds⃗, AᵀDs⃗ and s⃗.
// After each split phase the rows go round by __shfl_sync(…, width = K)
// (gather_rows), so every lane holds the whole result again; at K = 1 the
// gathers are copies and no shuffle is issued.
//
// Conventions: `lane` is the thread's lane in its team (0..K−1), teams never
// straddle a warp, and every lane of the warp calls every function (a team
// past the end of the bank too): the shuffles take the full mask.  A
// register array is indexed at run time only through `pick`, a chain of
// selects over an unrolled loop, so no array lives in a thread's stack
// frame.
//
// Build WITHOUT --use_fast_math, as smallmat.cuh says.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "smallmat.cuh"

namespace rq {
namespace small {

constexpr unsigned kFull = 0xffffffffu;

// Slots of a lane's row arrays: rows i = lane + K·slot below `count`.
template <int count, int K>
constexpr int kSlots = (count + K - 1) / K;

// Value v of lane `src` of the calling lane's team.
template <int K, typename T>
__device__ __forceinline__ T from_lane(T v, int src) {
  if constexpr (K == 1)
    return v;
  else
    return __shfl_sync(kFull, v, src, K);
}

// a[i] for a run-time i < N, by selects.
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&a)[N], int i) {
  T v = a[0];
#pragma unroll
  for (int k = 1; k < N; ++k) v = i == k ? a[k] : v;
  return v;
}

// Row i of a, for a run-time i < P, by selects.
template <typename T, int P, int Q>
__device__ __forceinline__ void pick_row(const T (&a)[P][Q], int i, T (&out)[Q]) {
#pragma unroll
  for (int j = 0; j < Q; ++j) out[j] = a[0][j];
#pragma unroll
  for (int k = 1; k < P; ++k)
#pragma unroll
    for (int j = 0; j < Q; ++j) out[j] = i == k ? a[k][j] : out[j];
}

// Column j of a, for a run-time j < Q, by selects.
template <typename T, int P, int Q>
__device__ __forceinline__ void pick_col(const T (&a)[P][Q], int j, T (&out)[P]) {
#pragma unroll
  for (int i = 0; i < P; ++i) out[i] = pick<T, Q>(a[i], j);
}

// The whole P×C matrix on every lane from its rows, lane r holding rows
// r, r + K, ... in own[slot].
template <typename T, int P, int C, int K>
__device__ __forceinline__ void gather_rows(const T (&own)[kSlots<P, K>][C], T (&full)[P][C]) {
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) full[i][j] = from_lane<K>(own[i / K][j], i % K);
}

// The whole P-vector on every lane from its entries, lane r holding
// entries r, r + K, ... in own[slot].
template <typename T, int P, int K>
__device__ __forceinline__ void gather(const T (&own)[kSlots<P, K>], T (&full)[P]) {
#pragma unroll
  for (int i = 0; i < P; ++i) full[i] = from_lane<K>(own[i / K], i % K);
}

// Evaluating step over the closed-loop fold (q, q̄⃗, Q̄, Ā), as
// dp_step.cuh:folded_step (and its m_factor and risk_term): the carry
// (s, s⃗, S) holds time t+1 on entry and time t on exit, on every lane;
// m_fail latches on any failed M.  Q̄ must be symmetric already.
//   1. every lane: M = sym(W⁻¹ − θS) and its factor;
//   2. lane r: its columns of M⁻¹[S | s⃗], its rows of D, DS and Ds⃗;
//   3. gather M⁻¹s⃗, DS and Ds⃗; every lane: the risk term and s;
//   4. lane r: its rows of AᵀDS, AᵀDS·A, S = Q̄ + AᵀDS·A and s⃗ = q̄⃗ + AᵀDs⃗;
//   5. gather S and s⃗; every lane: S ← sym(S).
template <typename T, int N, int K>
__device__ __forceinline__ void folded_step(int lane, T q, const T (&qv)[N], const T (&Q)[N][N],
                                            const T (&A)[N][N], const T (&W)[N][N],
                                            const T (&Wi)[N][N], T ldW, T theta, T& s,
                                            T (&sv)[N], T (&S)[N][N], bool& m_fail) {
  constexpr int R = kSlots<N, K>, C = kSlots<N + 1, K>;
  T Mc[N][N];
  {
    T Mm[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) Mm[i][j] = Wi[i][j] - theta * S[i][j];
    rq::sym_inplace<T, N>(Mm);
    rq::chol<T, N>(Mm, Mc);
  }
  if (!rq::chol_ok<T, N>(Mc)) m_fail = true;

  // Lane r's solves: column c = r + K·k of M⁻¹S (c < N) or M⁻¹s⃗ (c = N).
  T X[C][N];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int c = lane + K * k;
    T b[N];
#pragma unroll
    for (int i = 0; i < N; ++i) b[i] = c < N ? pick<T, N>(S[i], c) : sv[i];
    if (c <= N) {
      rq::cho_solve_vec<T, N>(Mc, b, X[k]);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) X[k][i] = T(0);   // a slot past the columns
    }
  }
  // Row i of D (D_ik = δ_ik + θ (M⁻¹S)_ki), of DS = D S and of Ds⃗.
  T DSr[R][N], Dsvr[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = lane + K * k;
    T D[N];
#pragma unroll
    for (int j = 0; j < N; ++j) D[j] = (i == j ? T(1) : T(0)) + theta * X[k][j];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T acc = D[0] * S[0][j];
#pragma unroll
      for (int l = 1; l < N; ++l) acc = acc + D[l] * S[l][j];
      DSr[k][j] = acc;
    }
    T acc = D[0] * sv[0];
#pragma unroll
    for (int l = 1; l < N; ++l) acc = acc + D[l] * sv[l];
    Dsvr[k] = acc;
  }

  // The risk term (dp_step.cuh:risk_term) and s, on every lane.
  T Minv_sv[N], DS[N][N], Dsv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) Minv_sv[i] = from_lane<K>(X[N / K][i], N % K);
  gather_rows<T, N, N, K>(DSr, DS);
  gather<T, N, K>(Dsvr, Dsv);
  T tr = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) tr = tr + W[i][j] * S[j][i];
  const T theta_safe = (theta == T(0)) ? T(1) : theta;
  const T sens = T(0.5) * theta * rq::dot<T, N>(sv, Minv_sv) -
                 (ldW + rq::cho_logdet<T, N>(Mc)) / (T(2) * theta_safe);
  const T s_new = q + s + ((theta == T(0)) ? T(0.5) * tr : sens);

  // Row i of AᵀDS and AᵀDS·A; S_i = Q̄_i + (AᵀDS·A)_i, s⃗_i = q̄⃗_i + (AᵀDs⃗)_i.
  T Sr[R][N], svr[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = lane + K * k;
    T a[N], AtDS[N], Qi[N];
    pick_col<T, N, N>(A, i, a);   // column i of Ā
    pick_row<T, N, N>(Q, i, Qi);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T acc = a[0] * DS[0][j];
#pragma unroll
      for (int l = 1; l < N; ++l) acc = acc + a[l] * DS[l][j];
      AtDS[j] = acc;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T acc = AtDS[0] * A[0][j];
#pragma unroll
      for (int l = 1; l < N; ++l) acc = acc + AtDS[l] * A[l][j];
      Sr[k][j] = Qi[j] + acc;
    }
    T acc = a[0] * Dsv[0];
#pragma unroll
    for (int l = 1; l < N; ++l) acc = acc + a[l] * Dsv[l];
    svr[k] = pick<T, N>(qv, i) + acc;
  }
  gather_rows<T, N, N, K>(Sr, S);
  gather<T, N, K>(svr, sv);
  rq::sym_inplace<T, N>(S);
  s = s_new;
}

}  // namespace small
}  // namespace rq
