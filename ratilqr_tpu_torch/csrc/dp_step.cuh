// One backward step of the risk-sensitive Riccati recursion, per thread.
//
// The algebra of ratilqr_tpu/ops/riccati_pallas.py:_riccati_kernel (and of
// the plain ratilqr_tpu_torch/ops/riccati.py:_riccati_core), written once
// for the kernels: riccati.cu runs dp_step over streamed blocks, step.cu
// over blocks its tile model recomputes, and riccati_folded.cu runs
// folded_step over the closed-loop fold (candidate.cu runs its few-lane
// twin, small_team.cuh).  References: ileqg.jl:341-465.
#pragma once

#include "smallmat.cuh"

namespace rq {

// Risk term added to s: θ = 0 → ½ tr(W S') (ileqg.jl:385); θ > 0 →
// θ/2 s⃗ᵀM⁻¹s⃗ − (logdet W + logdet M)/(2θ) (ileqg.jl:387).
template <typename T, int N>
__device__ __forceinline__ T risk_term(T theta, const T (&W)[N][N], const T (&S)[N][N],
                                       const T (&sv)[N], const T (&Mc)[N][N], T ldW) {
  T tr = T(0);
#pragma unroll (rq::Unroll<N>::value)
  for (int i = 0; i < N; ++i)
#pragma unroll (rq::Unroll<N>::value)
    for (int j = 0; j < N; ++j) tr = tr + W[i][j] * S[j][i];
  T Minv_sv[N];
  cho_solve_vec<T, N>(Mc, sv, Minv_sv);
  const T theta_safe = (theta == T(0)) ? T(1) : theta;
  const T sens = T(0.5) * theta * dot<T, N>(sv, Minv_sv) -
                 (ldW + cho_logdet<T, N>(Mc)) / (T(2) * theta_safe);
  return (theta == T(0)) ? T(0.5) * tr : sens;
}

// M = sym(W⁻¹ − θS), its factor Mc, and D = I + θ (M⁻¹S)ᵀ.  Returns
// whether M is positive definite.  M and its factor are formed under the
// contraction policy (smallmat.cuh).
template <typename T, int N>
__device__ __forceinline__ bool m_factor(T theta, const T (&Wi)[N][N], const T (&S)[N][N],
                                         T (&Mc)[N][N], T (&D)[N][N]) {
  T Mm[N][N];
#pragma unroll (rq::Unroll<N>::value)
  for (int i = 0; i < N; ++i)
#pragma unroll (rq::Unroll<N>::value)
    for (int j = 0; j < N; ++j) Mm[i][j] = msub<kFactor>(Wi[i][j], theta, S[i][j]);
  sym_inplace<T, N>(Mm);
  chol<T, N>(Mm, Mc);
  T MinvS[N][N];
  cho_solve_mat<T, N, N>(Mc, S, MinvS);
#pragma unroll (rq::Unroll<N>::value)
  for (int i = 0; i < N; ++i)
#pragma unroll (rq::Unroll<N>::value)
    for (int j = 0; j < N; ++j) D[i][j] = (i == j ? T(1) : T(0)) + theta * MinvS[j][i];
  return chol_ok<T, N>(Mc);
}

// Optimizing (OPT) or evaluating DP step at one time index.  The carry
// (s, sv, S) holds time t+1 on entry and time t on exit.  OPT writes the
// gains L and offsets dl; otherwise they are inputs.  g, G, H are written
// for the full-output variant.  Failure latching follows riccati.py:133-149:
// m_fail latches only if the lane has not failed before; h_fail only if it
// has neither failed before nor failed M at this step.
template <typename T, int N, int M, bool OPT>
__device__ __forceinline__ void dp_step(
    T q, const T (&qv)[N], const T (&Q)[N][N], const T (&r)[M], const T (&R)[M][M],
    const T (&P)[M][N], const T (&A)[N][N], const T (&Bm)[N][M], const T (&W)[N][N],
    const T (&Wi)[N][N], T ldW, T theta, T mu, T (&L)[M][N], T (&dl)[M], T (&g)[M],
    T (&G)[M][N], T (&H)[M][M], T& s, T (&sv)[N], T (&S)[N][N], bool& m_fail,
    bool& h_fail) {
  const bool failed = m_fail || h_fail;
  T Mc[N][N], D[N][N];
  if (!m_factor<T, N>(theta, Wi, S, Mc, D) && !failed) m_fail = true;

  T DS[N][N], Dsv[N], BtDS[M][N], tmpM[M], tmpMN[M][N], tmpMM[M][M];
  mm<T, N, N, N>(D, S, DS);
  mv<T, N, N>(D, sv, Dsv);
  mtv<T, N, M>(Bm, Dsv, tmpM);
#pragma unroll (rq::Unroll<M>::value)
  for (int i = 0; i < M; ++i) g[i] = r[i] + tmpM[i];  // ileqg.jl:368
  mtm<T, N, M, N>(Bm, DS, BtDS);
  mm<T, M, N, N>(BtDS, A, tmpMN);
#pragma unroll (rq::Unroll<M>::value)
  for (int i = 0; i < M; ++i)
#pragma unroll (rq::Unroll<N>::value)
    for (int j = 0; j < N; ++j) G[i][j] = P[i][j] + tmpMN[i][j];  // ileqg.jl:369
  mm<T, M, N, M>(BtDS, Bm, tmpMM);
#pragma unroll (rq::Unroll<M>::value)
  for (int i = 0; i < M; ++i)
#pragma unroll (rq::Unroll<M>::value)
    for (int j = 0; j < M; ++j) H[i][j] = R[i][j] + tmpMM[i][j] + (i == j ? mu : T(0));
  sym_inplace<T, M>(H);  // ileqg.jl:370-371

  if (OPT) {
    T Hc[M][M];
    chol<T, M>(H, Hc);
    if (!chol_ok<T, M>(Hc) && !failed && !m_fail) h_fail = true;
    cho_solve_mat<T, M, N>(Hc, G, L);  // L = −H⁻¹G, ileqg.jl:379
    cho_solve_vec<T, M>(Hc, g, dl);    // dl = −H⁻¹g, ileqg.jl:381
#pragma unroll (rq::Unroll<M>::value)
    for (int i = 0; i < M; ++i) {
      dl[i] = -dl[i];
#pragma unroll (rq::Unroll<N>::value)
      for (int j = 0; j < N; ++j) L[i][j] = -L[i][j];
    }
  }

  T Hdl[M];
  mv<T, M, M>(H, dl, Hdl);
  const T s_new = q + s + T(0.5) * dot<T, M>(dl, Hdl) + dot<T, M>(dl, g) +
                  risk_term<T, N>(theta, W, S, sv, Mc, ldW);  // ileqg.jl:383-387

  // s⃗ ← q⃗ + AᵀD s⃗ + LᵀH dl + Lᵀg + Gᵀdl   (ileqg.jl:389)
  T AtDsv[N], LtHdl[N], Ltg[N], Gtdl[N];
  mtv<T, N, N>(A, Dsv, AtDsv);
  mtv<T, M, N>(L, Hdl, LtHdl);
  mtv<T, M, N>(L, g, Ltg);
  mtv<T, M, N>(G, dl, Gtdl);
  // S ← sym(Q + AᵀDS A + LᵀH L + LᵀG + GᵀL)   (ileqg.jl:390-391)
  T AtDS[N][N], AtDSA[N][N], HL[M][N], LtHL[N][N], LtG[N][N];
  mtm<T, N, N, N>(A, DS, AtDS);
  mm<T, N, N, N>(AtDS, A, AtDSA);
  mm<T, M, M, N>(H, L, HL);
  mtm<T, M, N, N>(L, HL, LtHL);
  mtm<T, M, N, N>(L, G, LtG);
#pragma unroll (rq::Unroll<N>::value)
  for (int i = 0; i < N; ++i) {
    sv[i] = qv[i] + AtDsv[i] + LtHdl[i] + Ltg[i] + Gtdl[i];
#pragma unroll (rq::Unroll<N>::value)
    for (int j = 0; j < N; ++j)
      S[i][j] = Q[i][j] + AtDSA[i][j] + LtHL[i][j] + LtG[i][j] + LtG[j][i];
  }
  sym_inplace<T, N>(S);
  s = s_new;
}

// Evaluating step over the closed-loop fold (q, q̄_vec, Q̄, Ā) with dl = 0
// (riccati.py:_riccati_folded_core): m_fail latches on any failed M.
template <typename T, int N>
__device__ __forceinline__ void folded_step(T q, const T (&qv)[N], const T (&Q)[N][N],
                                            const T (&A)[N][N], const T (&W)[N][N],
                                            const T (&Wi)[N][N], T ldW, T theta, T& s,
                                            T (&sv)[N], T (&S)[N][N], bool& m_fail) {
  T Mc[N][N], D[N][N];
  if (!m_factor<T, N>(theta, Wi, S, Mc, D)) m_fail = true;
  T DS[N][N], Dsv[N], AtDsv[N], AtDS[N][N], AtDSA[N][N];
  mm<T, N, N, N>(D, S, DS);
  mv<T, N, N>(D, sv, Dsv);
  const T s_new = q + s + risk_term<T, N>(theta, W, S, sv, Mc, ldW);
  mtv<T, N, N>(A, Dsv, AtDsv);
  mtm<T, N, N, N>(A, DS, AtDS);
  mm<T, N, N, N>(AtDS, A, AtDSA);
#pragma unroll (rq::Unroll<N>::value)
  for (int i = 0; i < N; ++i) {
    sv[i] = qv[i] + AtDsv[i];
#pragma unroll (rq::Unroll<N>::value)
    for (int j = 0; j < N; ++j) S[i][j] = Q[i][j] + AtDSA[i][j];
  }
  sym_inplace<T, N>(S);
  s = s_new;
}

}  // namespace rq
