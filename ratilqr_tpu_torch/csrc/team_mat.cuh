// Small-matrix algebra for one solve per team of L lanes (half a warp or a
// warp), on matrices in shared memory.
//
// The team counterpart of smallmat.cuh and of dp_step.cuh's dp_step and
// folded_step: the same formulas in the same operation order, spread over
// the lanes of a team.  Lane i owns row i of every N×N product: it keeps
// the row's N sums in registers, reads its own operand once per k and the
// other operand's row k as a broadcast, and sums over k in the order
// smallmat.cuh uses.  The Cholesky factor of M (N×N) keeps lane i's row in
// registers and passes each pivot and column round by shuffles; each lane
// solves one right-hand side in registers.  H (M×M, M ≤ kUnrollMax) is
// small enough for every lane to factor a copy with smallmat.cuh.  So a
// team kernel and its one-solve-per-thread twin differ only by fused
// multiply-adds.
//
// Conventions: every matrix argument is a reference to an array in shared
// memory (vm_row's row is in registers), `lane` is the calling thread's
// lane in its team (0..L−1), teams
// never straddle a warp, and every lane of the warp calls every function
// (the teams of one warp run the same steps).  The *_row helpers compute
// one row into registers and do not synchronize; the team functions end
// with __syncwarp(), so their outputs are visible to the whole team on
// return.  Shared arrays are indexed at run time, register rows only by
// unrolled loops: no array lives in a thread's stack frame.
//
// Build WITHOUT --use_fast_math, as smallmat.cuh says.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "smallmat.cuh"

namespace rq {
namespace team {

constexpr unsigned kFull = 0xffffffffu;

// Row i of A B  (A: P×Q, B: Q×R), as smallmat.cuh:mm.
template <typename T, int P, int Q, int R>
__device__ __forceinline__ void mm_row(const T (&A)[P][Q], const T (&B)[Q][R], int i,
                                       T (&out)[R]) {
  const T a0 = A[i][0];
#pragma unroll
  for (int j = 0; j < R; ++j) out[j] = a0 * B[0][j];
  for (int k = 1; k < Q; ++k) {
    const T a = A[i][k];
#pragma unroll
    for (int j = 0; j < R; ++j) out[j] = out[j] + a * B[k][j];
  }
}

// Row i of Aᵀ B  (A: Q×P, B: Q×R), as smallmat.cuh:mtm.
template <typename T, int Q, int P, int R>
__device__ __forceinline__ void mtm_row(const T (&A)[Q][P], const T (&B)[Q][R], int i,
                                        T (&out)[R]) {
  const T a0 = A[0][i];
#pragma unroll
  for (int j = 0; j < R; ++j) out[j] = a0 * B[0][j];
  for (int k = 1; k < Q; ++k) {
    const T a = A[k][i];
#pragma unroll
    for (int j = 0; j < R; ++j) out[j] = out[j] + a * B[k][j];
  }
}

// (Aᵀ v)[i]  (A: Q×P), as smallmat.cuh:mtv.
template <typename T, int Q, int P>
__device__ __forceinline__ T mtv_at(const T (&A)[Q][P], const T (&v)[Q], int i) {
  T acc = A[0][i] * v[0];
  for (int k = 1; k < Q; ++k) acc = acc + A[k][i] * v[k];
  return acc;
}

// a B for a row a in registers (B: Q×R), as one row of smallmat.cuh:mm.
template <typename T, int Q, int R>
__device__ __forceinline__ void vm_row(const T (&a)[Q], const T (&B)[Q][R], T (&out)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) out[j] = a[0] * B[0][j];
#pragma unroll
  for (int k = 1; k < Q; ++k) {
#pragma unroll
    for (int j = 0; j < R; ++j) out[j] = out[j] + a[k] * B[k][j];
  }
}

// M ← ½(M + Mᵀ); each pair (i < j) belongs to one lane.
template <typename T, int N, int L>
__device__ __forceinline__ void sym_inplace(int lane, T (&M)[N][N]) {
  for (int e = lane; e < N * N; e += L) {
    const int i = e / N, j = e % N;
    if (i < j) {
      const T v = T(0.5) * (M[i][j] + M[j][i]);
      M[i][j] = v;
      M[j][i] = v;
    }
  }
  __syncwarp();
}

// Right-looking Cholesky with each lane's row in registers: lane i holds
// row i of M (entries j ≤ i) in c and leaves row i of the factor there;
// at step j the pivot and column j go round by shuffles.  Entry (i, j)
// takes its updates L_ik L_jk in ascending k and then its division by the
// pivot, the operations of smallmat.cuh:chol in its order (NaN entries
// when M is not positive definite).  Returns whether every pivot is
// finite and positive (smallmat.cuh:chol_ok), and the lane's own pivot in
// `diag` (lanes i < N).
template <typename T, int N, int L>
__device__ __forceinline__ bool chol_rows(int lane, T (&c)[N], T& diag) {
  static_assert(N <= L, "a team factors with one lane per row");
  bool ok = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const T pivot = sqrt(__shfl_sync(kFull, c[j], j, L));
    ok = ok && isfinite(pivot) && (pivot > T(0));
    diag = lane == j ? pivot : diag;
    c[j] = lane == j ? pivot : c[j] / pivot;
#pragma unroll
    for (int k = j + 1; k < N; ++k) {
      const T ckj = __shfl_sync(kFull, c[j], k, L);   // L_kj, from lane k
      if (lane >= k) c[k] = c[k] - c[j] * ckj;
    }
  }
  return ok;
}

// x ← M⁻¹x for one right-hand side in registers, from M's factor C, as
// smallmat.cuh:cho_solve_vec: each row's sum runs over k in ascending
// order and ends with a division by the pivot.  The forward substitution
// goes column by column (the rows below a new entry update at once), the
// back substitution row by row.
template <typename T, int N>
__device__ __forceinline__ void cho_solve_reg(const T (&C)[N][N], T (&x)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    x[k] = x[k] / C[k][k];
#pragma unroll
    for (int i = k + 1; i < N; ++i) x[i] = x[i] - C[i][k] * x[k];
  }
  // The back substitution reads the factor again rather than keep its 78
  // entries live in registers from the forward pass.
  asm volatile("" ::: "memory");
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    T acc = x[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) acc = acc - C[k][i] * x[k];
    x[i] = acc / C[i][i];
  }
}

// log det M = 2 Σ log L_ii (smallmat.cuh:cho_logdet), from the logs of
// the pivots, log_diag[i] = log L_ii, summed in order.
template <typename T, int N>
__device__ __forceinline__ T cho_logdet(const T (&log_diag)[N]) {
  T acc = T(0);
  for (int i = 0; i < N; ++i) acc = acc + log_diag[i];
  return T(2) * acc;
}

// The team's working space for folded_step.  MS holds M's factor, then
// DS; X holds M⁻¹S (D = I + θ(M⁻¹S)ᵀ is formed row by row from it), then
// AᵀDS.
template <typename T, int N>
struct FoldScratch {
  T MS[N][N], X[N][N];
  T Dsv[N], Minv_sv[N], AtDsv[N], log_diag[N];
};

// The risk term added to s (dp_step.cuh:risk_term), on one lane: θ = 0 →
// ½ tr(W S); θ > 0 → θ/2 s⃗ᵀM⁻¹s⃗ − (logdet W + logdet M)/(2θ).  Only the
// branch that is returned is computed.
template <typename T, int N>
__device__ __forceinline__ T risk_term(T theta, const T (&W)[N][N], const T (&S)[N][N],
                                       const T (&sv)[N], const T (&Minv_sv)[N],
                                       const T (&log_diag)[N], T ldW) {
  if (theta == T(0)) {
    T tr = T(0);
    for (int i = 0; i < N; ++i)
      for (int j = 0; j < N; ++j) tr = tr + W[i][j] * S[j][i];
    return T(0.5) * tr;
  }
  T d = sv[0] * Minv_sv[0];
  for (int k = 1; k < N; ++k) d = d + sv[k] * Minv_sv[k];
  return T(0.5) * theta * d - (ldW + cho_logdet<T, N>(log_diag)) / (T(2) * theta);
}

// M = sym(W⁻¹ − θS) and its factor in w.MS, M⁻¹S in w.X, and M⁻¹s⃗ and
// the pivots' logs for the risk term (dp_step.cuh:m_factor).  Returns
// whether M is positive definite (the same on every lane).
template <typename T, int N, int L>
__device__ __forceinline__ bool m_factor(int lane, T theta, const T (&Wi)[N][N],
                                         const T (&S)[N][N], const T (&sv)[N],
                                         FoldScratch<T, N>& w) {
  static_assert(N < L, "M⁻¹s⃗ takes the lane after the last column");
  const int i = lane < N ? lane : N - 1;   // lanes past the rows factor a copy
  T c[N], diag = T(1);
#pragma unroll
  for (int j = 0; j < N; ++j) {   // row i of sym(W⁻¹ − θS), j ≤ i
    const T mij = Wi[i][j] - theta * S[i][j];
    c[j] = j < i ? T(0.5) * (mij + (Wi[j][i] - theta * S[j][i])) : mij;
  }
  const bool ok = chol_rows<T, N, L>(lane, c, diag);
  if (lane < N) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j <= lane) w.MS[lane][j] = c[j];
  }
  __syncwarp();
  if (lane <= N) {   // lane j < N: column j of M⁻¹S; lane N: M⁻¹s⃗
    const T* b = lane < N ? &S[0][lane] : sv;
    T* out = lane < N ? &w.X[0][lane] : w.Minv_sv;
    const int stride = lane < N ? N : 1;
    T x[N];
#pragma unroll
    for (int r = 0; r < N; ++r) x[r] = b[r * stride];
    cho_solve_reg<T, N>(w.MS, x);
#pragma unroll
    for (int r = 0; r < N; ++r) out[r * stride] = x[r];
  }
  if (lane < N) w.log_diag[lane] = log(diag);
  __syncwarp();
  return ok;
}

// Row i of DS = D S (into w.MS, whose factor of M the solves no longer
// need) and (D s⃗)_i, with D_ik = δ_ik + θ (M⁻¹S)_ki from w.X, as
// smallmat.cuh:mm and mv; on lane i < N.
template <typename T, int N>
__device__ __forceinline__ void ds_row(int i, T theta, const T (&S)[N][N], const T (&sv)[N],
                                       FoldScratch<T, N>& w) {
  T row[N];
  T d = (i == 0 ? T(1) : T(0)) + theta * w.X[0][i];
  T dsv = d * sv[0];
#pragma unroll
  for (int j = 0; j < N; ++j) row[j] = d * S[0][j];
  for (int k = 1; k < N; ++k) {
    d = (i == k ? T(1) : T(0)) + theta * w.X[k][i];
    dsv = dsv + d * sv[k];
#pragma unroll
    for (int j = 0; j < N; ++j) row[j] = row[j] + d * S[k][j];
  }
#pragma unroll
  for (int j = 0; j < N; ++j) w.MS[i][j] = row[j];
  w.Dsv[i] = dsv;
}

// Evaluating step over the closed-loop fold (q, q̄_vec, Q̄, Ā), as
// dp_step.cuh:folded_step: the carry (s, s⃗, S) holds time t+1 on entry and
// time t on exit; m_fail latches on any failed M.  s and q are read and
// written on lane 0 only.  Q̄ must be symmetric already.
template <typename T, int N, int L>
__device__ __forceinline__ void folded_step(int lane, T q, const T (&qv)[N], const T (&Q)[N][N],
                                            const T (&A)[N][N], const T (&W)[N][N],
                                            const T (&Wi)[N][N], T ldW, T theta, T& s,
                                            T (&sv)[N], T (&S)[N][N], bool& m_fail,
                                            FoldScratch<T, N>& w) {
  if (!m_factor<T, N, L>(lane, theta, Wi, S, sv, w)) m_fail = true;
  if (lane < N) ds_row<T, N>(lane, theta, S, sv, w);
  __syncwarp();
  if (lane == 0) s = q + s + risk_term<T, N>(theta, W, S, sv, w.Minv_sv, w.log_diag, ldW);
  T row[N];
  if (lane < N) {   // row i of AᵀDS (into X) and (AᵀDs⃗)_i
    mtm_row<T, N, N, N>(A, w.MS, lane, row);
#pragma unroll
    for (int j = 0; j < N; ++j) w.X[lane][j] = row[j];
    w.AtDsv[lane] = mtv_at<T, N, N>(A, w.Dsv, lane);
  }
  __syncwarp();
  if (lane < N) {   // S ← Q̄ + AᵀDSĀ, s⃗ ← q̄ + AᵀDs⃗
    mm_row<T, N, N, N>(w.X, A, lane, row);
#pragma unroll
    for (int j = 0; j < N; ++j) S[lane][j] = Q[lane][j] + row[j];
    sv[lane] = qv[lane] + w.AtDsv[lane];
  }
  __syncwarp();
  sym_inplace<T, N, L>(lane, S);
}

// The team's working space for dp_step: folded_step's, H L, H dl and the
// risk term.
template <typename T, int N, int M>
struct DpScratch {
  FoldScratch<T, N> f;
  T HL[M][N], Hdl[M], risk;
};

// Optimizing (OPT) or evaluating DP step at one time index, as
// dp_step.cuh:dp_step: the carry (s, s⃗, S) holds time t+1 on entry and time
// t on exit; OPT writes the gains L and offsets dl, otherwise they are
// inputs; g, G and H (symmetric) are written for the full-output variant.
// m_fail latches only if the lane has not failed before; h_fail only if it
// has neither failed before nor failed M at this step (riccati.py:133-149).
// s and q are read and written on lane 0 only; the flags are the same on
// every lane.
//
// Phases, each ending with __syncwarp():
//   1. M's factor, M⁻¹S and M⁻¹s⃗ (m_factor);
//   2. lane i < N: row i of DS and (Ds⃗)_i; lane N: the risk term, from the
//      carry on entry;
//   3. lane i < N: row i of AᵀDS and at once row i of AᵀDS·A (into X, of
//      which only lane i reads row i) and (AᵀDs⃗)_i; lane N + i: row i of
//      BᵀDS and at once rows i of G = P + BᵀDS·A and of H = R + BᵀDS·B + μI,
//      and g_i = r_i + (BᵀDs⃗)_i;
//   4. every lane: sym(H) and (OPT) its factor in registers; lane j < N:
//      column j of L = −H⁻¹G and of H L; lane N: dl = −H⁻¹g and H dl;
//   5. lane 0: s; lane i < N: row i of Q + AᵀDS·A + LᵀHL + LᵀG + GᵀL and
//      s⃗_i = q⃗_i + (AᵀDs⃗)_i + (LᵀHdl)_i + (Lᵀg)_i + (Gᵀdl)_i; lane N:
//      sym(H) into H;
//   6. S ← sym(S).
template <typename T, int N, int M, int L, bool OPT>
__device__ __forceinline__ void dp_step(
    int lane, T q, const T (&qv)[N], const T (&Q)[N][N], const T (&r)[M], const T (&R)[M][M],
    const T (&P)[M][N], const T (&A)[N][N], const T (&Bm)[N][M], const T (&W)[N][N],
    const T (&Wi)[N][N], T ldW, T theta, T mu, T (&Lg)[M][N], T (&dl)[M], T (&g)[M],
    T (&G)[M][N], T (&H)[M][M], T& s, T (&sv)[N], T (&S)[N][N], bool& m_fail, bool& h_fail,
    DpScratch<T, N, M>& d) {
  static_assert(N + M <= L, "the rows of BᵀDS take the lanes after the rows of AᵀDS");
  static_assert(M <= kUnrollMax, "every lane factors H in registers");
  FoldScratch<T, N>& w = d.f;
  const bool failed = m_fail || h_fail;
  if (!m_factor<T, N, L>(lane, theta, Wi, S, sv, w) && !failed) m_fail = true;

  if (lane < N) ds_row<T, N>(lane, theta, S, sv, w);
  if (lane == N) d.risk = risk_term<T, N>(theta, W, S, sv, w.Minv_sv, w.log_diag, ldW);
  __syncwarp();

  T row[N], out[N];
  if (lane < N) {
    mtm_row<T, N, N, N>(A, w.MS, lane, row);   // AᵀDS
    vm_row<T, N, N>(row, A, out);
#pragma unroll
    for (int j = 0; j < N; ++j) w.X[lane][j] = out[j];
    w.AtDsv[lane] = mtv_at<T, N, N>(A, w.Dsv, lane);
  }
  for (int i = lane - N; i >= 0 && i < M; i += L - N) {
    mtm_row<T, N, M, N>(Bm, w.MS, i, row);   // BᵀDS
    vm_row<T, N, N>(row, A, out);
#pragma unroll
    for (int j = 0; j < N; ++j) G[i][j] = P[i][j] + out[j];   // ileqg.jl:369
    T hrow[M];
    vm_row<T, N, M>(row, Bm, hrow);
#pragma unroll
    for (int j = 0; j < M; ++j) H[i][j] = R[i][j] + hrow[j] + (i == j ? mu : T(0));
    g[i] = r[i] + mtv_at<T, N, M>(Bm, w.Dsv, i);   // ileqg.jl:368
  }
  __syncwarp();

  T Hs[M][M];   // sym(H), ileqg.jl:370-371
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) Hs[i][j] = H[i][j];
  rq::sym_inplace<T, M>(Hs);
  T Hc[M][M];
  if (OPT) {
    rq::chol<T, M>(Hs, Hc);
    if (!rq::chol_ok<T, M>(Hc) && !failed && !m_fail) h_fail = true;
  }
  if (lane <= N) {   // lane j < N: column j of L and H L; lane N: dl and H dl
    T* gain = lane < N ? &Lg[0][lane] : dl;
    const int stride = lane < N ? N : 1;
    T x[M], hx[M];
    if (OPT) {
      const T* rhs = lane < N ? &G[0][lane] : g;
#pragma unroll
      for (int k = 0; k < M; ++k) hx[k] = rhs[k * stride];
      rq::cho_solve_vec<T, M>(Hc, hx, x);
#pragma unroll
      for (int k = 0; k < M; ++k) {   // L = −H⁻¹G, dl = −H⁻¹g, ileqg.jl:379-381
        x[k] = -x[k];
        gain[k * stride] = x[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < M; ++k) x[k] = gain[k * stride];
    }
    rq::mv<T, M, M>(Hs, x, hx);
    T* hout = lane < N ? &d.HL[0][lane] : d.Hdl;
#pragma unroll
    for (int k = 0; k < M; ++k) hout[k * stride] = hx[k];
  }
  __syncwarp();

  if (lane == 0)   // ileqg.jl:383-387
    s = q + s + T(0.5) * rq::dot<T, M>(dl, d.Hdl) + rq::dot<T, M>(dl, g) + d.risk;
  if (lane == N) {
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) H[i][j] = Hs[i][j];
  }
  if (lane < N) {
    const int i = lane;
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = Q[i][j] + w.X[i][j];
    mtm_row<T, M, N, N>(Lg, d.HL, i, row);   // LᵀHL
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = out[j] + row[j];
    mtm_row<T, M, N, N>(Lg, G, i, row);   // LᵀG
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = out[j] + row[j];
    mtm_row<T, M, N, N>(G, Lg, i, row);   // GᵀL
#pragma unroll
    for (int j = 0; j < N; ++j) S[i][j] = out[j] + row[j];   // ileqg.jl:390
    sv[i] = qv[i] + w.AtDsv[i] + mtv_at<T, M, N>(Lg, d.Hdl, i) + mtv_at<T, M, N>(Lg, g, i) +
            mtv_at<T, M, N>(G, dl, i);   // ileqg.jl:389
  }
  __syncwarp();
  sym_inplace<T, N, L>(lane, S);   // ileqg.jl:391
}

}  // namespace team
}  // namespace rq
