// Small-matrix algebra for one solve per team of K lanes (K ∈ {1, 2, 4})
// at n ≤ kUnrollMax, every matrix in registers.
//
// The few-lane counterpart of dp_step.cuh's folded_step (kernel C) and of
// its optimizing dp_step (kernel B), as team_mat.cuh is the 16-lane one at
// n=12: the same formulas in the same operation order, so a team and one
// thread differ only by fused multiply-adds, and every K gives the same
// bits.  Every lane of a team holds the carry (s, s⃗, S), the model blocks
// or the fold, M's Cholesky factor and (dp_step) H, H's factor and the
// gains in full; what is split is the work with long dependent chains or
// many products.  Lane r owns the rows and columns i = r, r + K, r + 2K,
// ... (slot i / K of its row arrays):
//   - the N + 1 solves with M's factor: column i of M⁻¹S (which is row i
//     of D = I + θ(M⁻¹S)ᵀ) and, as column N, M⁻¹s⃗;
//   - row i of DS, AᵀDS and AᵀDS·A, and entry i of Ds⃗, AᵀDs⃗ and s⃗;
//   - (dp_step) the N + 1 solves with H's factor: column i of
//     L = −H⁻¹G and, as column N, dl = −H⁻¹g; and row i of
//     LᵀHL + LᵀG + GᵀL.
// After each split phase the rows go round by __shfl_sync(…, width = K)
// (gather_rows), so every lane holds the whole result again; at K = 1 the
// gathers are copies and no shuffle is issued.
//
// Contraction (smallmat.cuh's policy): M and its factor at kFactor, the
// rest of the DP step, from M's factor to S_t, at kCarry (rounded only in
// a source built at that level: kernel C's).
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

// M = sym(W⁻¹ − θS) and its factor, on every lane; lane r's columns of
// M⁻¹[S | s⃗] and its rows of D (D_ik = δ_ik + θ (M⁻¹S)_ki), DS = D S and
// Ds⃗, then gathered: M⁻¹s⃗, DS and Ds⃗ on every lane.  Returns whether M
// is positive definite (dp_step.cuh:m_factor).
template <typename T, int N, int K>
__device__ __forceinline__ bool m_factor(int lane, T theta, const T (&Wi)[N][N],
                                         const T (&S)[N][N], const T (&sv)[N], T (&Mc)[N][N],
                                         T (&Minv_sv)[N], T (&DS)[N][N], T (&Dsv)[N]) {
  constexpr int R = kSlots<N, K>, C = kSlots<N + 1, K>;
  {
    T Mm[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) Mm[i][j] = rq::msub<rq::kFactor>(Wi[i][j], theta, S[i][j]);
    rq::sym_inplace<T, N>(Mm);
    rq::chol<T, N>(Mm, Mc);
  }
  // Lane r's solves: column c = r + K·k of M⁻¹S (c < N) or M⁻¹s⃗ (c = N).
  T X[C][N];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int c = lane + K * k;
    T b[N];
#pragma unroll
    for (int i = 0; i < N; ++i) b[i] = c < N ? pick<T, N>(S[i], c) : sv[i];
    if (c <= N) {
      rq::cho_solve_vec<T, N, rq::kCarry>(Mc, b, X[k]);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) X[k][i] = T(0);   // a slot past the columns
    }
  }
  // Row i of D, of DS = D S and of Ds⃗.
  T DSr[R][N], Dsvr[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = lane + K * k;
    T D[N];
#pragma unroll
    for (int j = 0; j < N; ++j) D[j] = rq::madd<rq::kCarry>(i == j ? T(1) : T(0), theta, X[k][j]);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T acc = D[0] * S[0][j];
#pragma unroll
      for (int l = 1; l < N; ++l) acc = rq::madd<rq::kCarry>(acc, D[l], S[l][j]);
      DSr[k][j] = acc;
    }
    T acc = D[0] * sv[0];
#pragma unroll
    for (int l = 1; l < N; ++l) acc = rq::madd<rq::kCarry>(acc, D[l], sv[l]);
    Dsvr[k] = acc;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) Minv_sv[i] = from_lane<K>(X[N / K][i], N % K);
  gather_rows<T, N, N, K>(DSr, DS);
  gather<T, N, K>(Dsvr, Dsv);
  return rq::chol_ok<T, N>(Mc);
}

// The risk term added to s (dp_step.cuh:risk_term), on every lane.
template <typename T, int N>
__device__ __forceinline__ T risk_term(T theta, const T (&W)[N][N], const T (&S)[N][N],
                                       const T (&sv)[N], const T (&Minv_sv)[N],
                                       const T (&Mc)[N][N], T ldW) {
  T tr = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) tr = tr + W[i][j] * S[j][i];
  const T theta_safe = (theta == T(0)) ? T(1) : theta;
  const T sens = T(0.5) * theta * rq::dot<T, N>(sv, Minv_sv) -
                 (ldW + rq::cho_logdet<T, N>(Mc)) / (T(2) * theta_safe);
  return (theta == T(0)) ? T(0.5) * tr : sens;
}

// Row i of Q + AᵀDS·A into Sr and q⃗_i + (AᵀDs⃗)_i, the first terms of the
// carry's update in dp_step.cuh's order.
template <typename T, int N>
__device__ __forceinline__ T atdsa_row(int i, const T (&qv)[N], const T (&Q)[N][N],
                                       const T (&A)[N][N], const T (&DS)[N][N],
                                       const T (&Dsv)[N], T (&Sr)[N]) {
  T a[N], AtDS[N], Qi[N];
  pick_col<T, N, N>(A, i, a);   // column i of A
  pick_row<T, N, N>(Q, i, Qi);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T acc = a[0] * DS[0][j];
#pragma unroll
    for (int l = 1; l < N; ++l) acc = rq::madd<rq::kCarry>(acc, a[l], DS[l][j]);
    AtDS[j] = acc;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T acc = AtDS[0] * A[0][j];
#pragma unroll
    for (int l = 1; l < N; ++l) acc = rq::madd<rq::kCarry>(acc, AtDS[l], A[l][j]);
    Sr[j] = Qi[j] + acc;
  }
  T acc = a[0] * Dsv[0];
#pragma unroll
  for (int l = 1; l < N; ++l) acc = rq::madd<rq::kCarry>(acc, a[l], Dsv[l]);
  return pick<T, N>(qv, i) + acc;
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
  constexpr int R = kSlots<N, K>;
  T Mc[N][N], Minv_sv[N], DS[N][N], Dsv[N];
  if (!m_factor<T, N, K>(lane, theta, Wi, S, sv, Mc, Minv_sv, DS, Dsv)) m_fail = true;
  const T s_new = q + s + risk_term<T, N>(theta, W, S, sv, Minv_sv, Mc, ldW);
  T Sr[R][N], svr[R];
#pragma unroll
  for (int k = 0; k < R; ++k) svr[k] = atdsa_row<T, N>(lane + K * k, qv, Q, A, DS, Dsv, Sr[k]);
  gather_rows<T, N, N, K>(Sr, S);
  gather<T, N, K>(svr, sv);
  rq::sym_inplace<T, N>(S);
  s = s_new;
}

// Optimizing DP step at one time index, as dp_step.cuh:dp_step with OPT
// (and its m_factor and risk_term): the carry (s, s⃗, S) holds time t+1 on
// entry and time t on exit, on every lane.  Lane r's columns of [L | dl]
// come out in LX (slot k: column c = r + K·k, dl at c = N, zeros past it);
// every lane holds them all inside the step.  m_fail latches only if the
// lane has not failed before; h_fail only if it has not failed before and
// M did not fail at this step (dp_step.cuh:67-93, riccati.py:133-149).
//   1-3. as folded_step, from M's factor to DS and Ds⃗ on every lane;
//   4. every lane: g = r + BᵀDs⃗, G = P + BᵀDS·A, H = sym(R + BᵀDS·B + μI)
//      and H's factor;
//   5. lane r: its columns of −H⁻¹[G | g]; gather L and dl;
//   6. every lane: H dl, H L, the risk term and s;
//   7. lane r: its rows of S = Q + AᵀDS·A + LᵀHL + LᵀG + GᵀL and s⃗ =
//      q⃗ + AᵀDs⃗ + LᵀH dl + Lᵀg + Gᵀdl;
//   8. gather S and s⃗; every lane: S ← sym(S).
template <typename T, int N, int M, int K>
__device__ __forceinline__ void dp_step(
    int lane, T q, const T (&qv)[N], const T (&Q)[N][N], const T (&r)[M], const T (&R)[M][M],
    const T (&P)[M][N], const T (&A)[N][N], const T (&Bm)[N][M], const T (&W)[N][N],
    const T (&Wi)[N][N], T ldW, T theta, T mu, T (&LX)[kSlots<N + 1, K>][M], T& s, T (&sv)[N],
    T (&S)[N][N], bool& m_fail, bool& h_fail) {
  constexpr int Rw = kSlots<N, K>, C = kSlots<N + 1, K>;
  constexpr int site = rq::kCarry;
  const bool failed = m_fail || h_fail;
  T Mc[N][N], Minv_sv[N], DS[N][N], Dsv[N];
  if (!m_factor<T, N, K>(lane, theta, Wi, S, sv, Mc, Minv_sv, DS, Dsv) && !failed)
    m_fail = true;

  T g[M], G[M][N], H[M][M];
  {
    T tmpM[M], BtDS[M][N], tmpMN[M][N], tmpMM[M][M];
    rq::mtv<T, N, M, site>(Bm, Dsv, tmpM);
#pragma unroll
    for (int i = 0; i < M; ++i) g[i] = r[i] + tmpM[i];   // ileqg.jl:368
    rq::mtm<T, N, M, N, site>(Bm, DS, BtDS);
    rq::mm<T, M, N, N, site>(BtDS, A, tmpMN);
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) G[i][j] = P[i][j] + tmpMN[i][j];   // ileqg.jl:369
    rq::mm<T, M, N, M, site>(BtDS, Bm, tmpMM);
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) H[i][j] = R[i][j] + tmpMM[i][j] + (i == j ? mu : T(0));
    rq::sym_inplace<T, M>(H);   // ileqg.jl:370-371
  }
  T Hc[M][M];
  rq::chol<T, M>(H, Hc);
  if (!rq::chol_ok<T, M>(Hc) && !failed && !m_fail) h_fail = true;

  // Lane r's solves: column c = r + K·k of −H⁻¹G (c < N) or −H⁻¹g (c = N),
  // ileqg.jl:379-381.
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int c = lane + K * k;
    T b[M], x[M];
#pragma unroll
    for (int i = 0; i < M; ++i) b[i] = c < N ? pick<T, N>(G[i], c) : g[i];
    rq::cho_solve_vec<T, M, site>(Hc, b, x);
#pragma unroll
    for (int i = 0; i < M; ++i) LX[k][i] = c <= N ? -x[i] : T(0);
  }
  T L[M][N], dl[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) L[i][j] = from_lane<K>(LX[j / K][i], j % K);
    dl[i] = from_lane<K>(LX[N / K][i], N % K);
  }

  T Hdl[M], HL[M][N];
  rq::mv<T, M, M, site>(H, dl, Hdl);
  rq::mm<T, M, M, N, site>(H, L, HL);
  const T s_new = q + s + T(0.5) * rq::dot<T, M>(dl, Hdl) + rq::dot<T, M>(dl, g) +
                  risk_term<T, N>(theta, W, S, sv, Minv_sv, Mc, ldW);   // ileqg.jl:383-387

  // Row i of S = Q + AᵀDS·A + LᵀHL + LᵀG + GᵀL (ileqg.jl:390) and s⃗_i =
  // q⃗_i + (AᵀDs⃗)_i + (LᵀH dl)_i + (Lᵀg)_i + (Gᵀdl)_i (ileqg.jl:389).
  T Sr[Rw][N], svr[Rw];
#pragma unroll
  for (int k = 0; k < Rw; ++k) {
    const int i = lane + K * k;
    const T v = atdsa_row<T, N>(i, qv, Q, A, DS, Dsv, Sr[k]);
    T Li[M], Gi[M];   // column i of L and of G
    pick_col<T, M, N>(L, i, Li);
    pick_col<T, M, N>(G, i, Gi);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T lthl = Li[0] * HL[0][j], ltg = Li[0] * G[0][j], gtl = L[0][j] * Gi[0];
#pragma unroll
      for (int m = 1; m < M; ++m) {
        lthl = rq::madd<site>(lthl, Li[m], HL[m][j]);
        ltg = rq::madd<site>(ltg, Li[m], G[m][j]);
        gtl = rq::madd<site>(gtl, L[m][j], Gi[m]);
      }
      Sr[k][j] = Sr[k][j] + lthl + ltg + gtl;
    }
    T lthdl = Li[0] * Hdl[0], ltg = Li[0] * g[0], gtdl = Gi[0] * dl[0];
#pragma unroll
    for (int m = 1; m < M; ++m) {
      lthdl = rq::madd<site>(lthdl, Li[m], Hdl[m]);
      ltg = rq::madd<site>(ltg, Li[m], g[m]);
      gtdl = rq::madd<site>(gtdl, Gi[m], dl[m]);
    }
    svr[k] = v + lthdl + ltg + gtdl;
  }
  gather_rows<T, N, N, K>(Sr, S);
  gather<T, N, K>(svr, sv);
  rq::sym_inplace<T, N>(S);   // ileqg.jl:391
  s = s_new;
}

}  // namespace small
}  // namespace rq
