"""Parallel-in-time (associative scan) risk-sensitive Riccati recursion.

Counterpart of :mod:`ratilqr_tpu.ops.riccati_parallel` over a bank
``(B, T, ...)``.  The sequential backward pass (:mod:`ratilqr_tpu_torch.
ops.riccati`) is O(T) in depth; this module computes the same value
functions in O(log T) depth with a reverse associative scan over the time
axis, batched over the lanes.

Each time step contributes two elements, the control (with the control
and the cost cross-terms eliminated by completing the square) and the risk
transform ``D S' = S'(I − θW S')⁻¹`` (an element with "noise covariance"
``C = −θW``); the terminal value is a pure-``J`` element.  An element
``e = (A, b, C, η, J)`` represents the value-function map

    S_prev = J + Aᵀ (I + S C)⁻¹ S A
    v_prev = η + Aᵀ (I + S C)⁻¹ (v − S b)

and :func:`combine` composes two of them.  The value constants never feed
back into the ``S``/``s⃗`` recursions, so they are recovered per step, all
steps at once, from the scanned suffix values and summed by a reverse
cumulative sum.

``torch`` has no public associative scan, so :func:`_scan` is written
here: the odd/even recursion of ``lax.associative_scan`` (combine adjacent
pairs, scan the pairs, fill in the even positions), one level a round, each
level one batched :func:`combine` over every lane and every pair.  The
general small solves of :func:`combine` are ``torch.linalg.solve_ex``.

Plain PyTorch, with no kernel: the JAX module has no ``pallas_call``.
Like the JAX module it is an alternative backend, off the default solver
path: :func:`dp_optimize_parallel` / :func:`dp_evaluate_parallel` return
what :func:`~ratilqr_tpu_torch.ops.riccati.dp_optimize` /
:func:`~ratilqr_tpu_torch.ops.riccati.dp_evaluate` return (float64 tests
at rtol 1e-8).  In float32 the composed elements lose precision over long
horizons (products of near-singular transforms).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ratilqr_tpu_torch.ops import smallmat
from ratilqr_tpu_torch.ops.riccati import (MAX_MU_RESTARTS, DPResult, _dot,
                                           _lanes, _mv, _risk_terms,
                                           mu_restart_loop)
from ratilqr_tpu_torch.ops.smallmat import sym

Tensor = torch.Tensor


class Element(NamedTuple):
    A: Tensor    # (..., n, n)
    b: Tensor    # (..., n)
    C: Tensor    # (..., n, n)
    eta: Tensor  # (..., n)
    J: Tensor    # (..., n, n)


def _t(M: Tensor) -> Tensor:
    return M.transpose(-1, -2)


def _solve(M: Tensor, B: Tensor) -> Tensor:
    """General (non-symmetric) small solve ``M X = B``, unchecked: a
    singular ``M`` gives non-finite entries, as ``jnp.linalg.solve`` does,
    and no host sync."""
    return torch.linalg.solve_ex(M, B)[0]


def _per_lane(x: Tensor, shared_ndim: int, Bn: int) -> Tensor:
    """A noise-model field over the lanes, shared ``(T, ...)`` or per-lane
    ``(B, T, ...)``."""
    return x if x.dim() > shared_ndim else x.expand(Bn, *x.shape)


def combine(ei: Element, ej: Element) -> Element:
    """Associative composition; ``ei`` earlier in time than ``ej``."""
    eye = torch.eye(ei.A.shape[-1], dtype=ei.A.dtype, device=ei.A.device)
    M1 = eye + ei.C @ ej.J                          # I + C_i J_j
    # C and J stay symmetric under composition, so I + J_j C_i = M1ᵀ.
    Aj_M1inv = _t(_solve(_t(M1), _t(ej.A)))      # A_j (I + C_i J_j)⁻¹
    Ai_T_M2inv = _t(_solve(M1, ei.A))
    return Element(
        A=Aj_M1inv @ ei.A,
        b=_mv(Aj_M1inv, ei.b + _mv(ei.C, ej.eta)) + ej.b,
        C=Aj_M1inv @ ei.C @ _t(ej.A) + ej.C,
        eta=_mv(Ai_T_M2inv, ej.eta - _mv(ej.J, ei.b)) + ei.eta,
        J=Ai_T_M2inv @ ej.J @ ei.A + ei.J)


def _map(fn: Callable, e: Element, *rest: Element) -> Element:
    return Element(*(fn(*xs) for xs in zip(e, *rest)))


def _scan(fn: Callable, elems: Element) -> Element:
    """Inclusive scan of ``fn`` (``fn(earlier, later)``) along axis 1, in
    the odd/even recursion of ``lax.associative_scan``."""
    num = elems.A.shape[1]
    if num < 2:
        return elems
    reduced = fn(_map(lambda x: x[:, 0:-1:2], elems),
                 _map(lambda x: x[:, 1::2], elems))
    odd = _scan(fn, reduced)
    rest = _map(lambda x: x[:, 2::2], elems)
    if num % 2 == 0:
        even = fn(_map(lambda x: x[:, :-1], odd), rest)
    else:
        even = fn(odd, rest)
    even = _map(lambda x, e: torch.cat([x[:, :1], e], 1), elems, even)

    def interleave(e, o):
        out = torch.empty((e.shape[0], num) + e.shape[2:], dtype=e.dtype,
                          device=e.device)
        out[:, 0::2] = e
        out[:, 1::2] = o
        return out

    return _map(interleave, even, odd)


def _suffix_values(elements: Element) -> Tuple[Tensor, Tensor]:
    """Suffix-composed ``(S, s⃗)`` at every element boundary: entry ``2t``
    is the value at time t (before the control of step t), ``2t + 1`` the
    post-control / pre-risk boundary."""
    flip = _map(lambda x: x.flip(1), elements)
    suffix = _map(lambda x: x.flip(1), _scan(lambda a, b: combine(b, a),
                                             flip))
    return suffix.J, suffix.eta


def _build_elements(approx, theta: Tensor, mu: Tensor,
                    L_traj: Optional[Tensor], dl_traj: Optional[Tensor]
                    ) -> Element:
    """Per-step elements interleaved ``[ctrl_0, risk_0, ctrl_1, …]``, then
    the terminal element: axis 1 of length ``2T + 1``."""
    Bn, T, n = approx.A.shape[0], approx.A.shape[1], approx.A.shape[-1]
    m = approx.B.shape[-1]
    dtype, device = approx.A.dtype, approx.A.device
    eye_n = torch.eye(n, dtype=dtype, device=device)
    eye_m = torch.eye(m, dtype=dtype, device=device)
    mu4 = mu[:, None, None, None]
    A, B, P, R = approx.A, approx.B, approx.P, approx.R
    zeros_n = torch.zeros((Bn, T, n), dtype=dtype, device=device)
    zeros_nn = torch.zeros((Bn, T, n, n), dtype=dtype, device=device)
    if L_traj is None:
        # Complete the square in u.  R̃ only needs to be invertible (a
        # general solve, not Cholesky): the sequential pass accepts an
        # indefinite R while H = R̃ + BᵀS̃B is PSD, which the per-step
        # phase still checks.
        R_t = sym(R + mu4 * eye_m)
        Kp = _solve(R_t, P)                                  # R̃⁻¹P
        u_off = _solve(R_t, approx.r.unsqueeze(-1)).squeeze(-1)
        # combine() applies (η_j − J_j b_i): b holds the NEGATED physical
        # dynamics offset (the offset is −B R̃⁻¹ r).
        ctrl = Element(A=A - B @ Kp, b=_mv(B, u_off),
                       C=B @ _solve(R_t, _t(B)),
                       eta=approx.q_vec - _mv(_t(P), u_off),
                       J=sym(approx.Q - _t(P) @ Kp))
    else:
        # The fixed policy u = L δx + dl: closed-loop cost and dynamics.
        L = L_traj
        dl = (torch.zeros((Bn, T, m), dtype=dtype, device=device)
              if dl_traj is None else dl_traj)
        R_t = R + mu4 * eye_m
        ctrl = Element(A=A + B @ L, b=-_mv(B, dl), C=zeros_nn,
                       eta=(approx.q_vec + _mv(_t(L), approx.r)
                            + _mv(_t(P) + _t(L) @ R_t, dl)),
                       J=sym(approx.Q + _t(L) @ R_t @ L + _t(P) @ L
                             + _t(L) @ P))
    risk = Element(A=eye_n.expand(Bn, T, n, n), b=zeros_n,
                   C=-theta[:, None, None, None] * _per_lane(approx.W, 3, Bn),
                   eta=zeros_n,
                   J=zeros_nn)
    term = Element(A=torch.zeros((Bn, 1, n, n), dtype=dtype, device=device),
                   b=torch.zeros((Bn, 1, n), dtype=dtype, device=device),
                   C=torch.zeros((Bn, 1, n, n), dtype=dtype, device=device),
                   eta=approx.q_vec_term[:, None],
                   J=sym(approx.Q_term)[:, None])
    return _map(lambda c, r, e: torch.cat(
        [torch.stack([c, r], 2).flatten(1, 2), e], 1), ctrl, risk, term)


def _per_step(approx, theta: Tensor, mu: Tensor, S: Tensor, s_vec: Tensor,
              L_traj: Optional[Tensor], dl_traj: Optional[Tensor]):
    """Gains and value increments of every step from the known next-step
    values ``S``/``s_vec`` ``(B, T, ...)``: the sequential pass's step,
    all steps at once."""
    Bn, T, n = approx.A.shape[0], approx.A.shape[1], approx.A.shape[-1]
    m = approx.B.shape[-1]
    dtype, device = approx.A.dtype, approx.A.device
    eye_n = torch.eye(n, dtype=dtype, device=device)
    eye_m = torch.eye(m, dtype=dtype, device=device)
    th2, th4 = theta[:, None], theta[:, None, None, None]
    theta_safe = torch.where(th2 == 0.0, torch.ones_like(th2), th2)

    W = _per_lane(approx.W, 3, Bn)
    W_inv = _per_lane(approx.W_inv, 3, Bn)
    logdet_W = _per_lane(approx.logdet_W, 1, Bn)
    M_chol = smallmat.cholesky(sym(W_inv - th4 * S))
    m_ok = smallmat.chol_ok(M_chol)
    D = eye_n + th4 * _t(smallmat.cho_solve_mat(M_chol, S))
    DS = D @ S
    Bt = _t(approx.B)
    g = approx.r + _mv(Bt, _mv(D, s_vec))
    G = approx.P + Bt @ DS @ approx.A
    H = sym(approx.R + Bt @ DS @ approx.B + mu[:, None, None, None] * eye_m)
    if L_traj is None:
        H_chol = smallmat.cholesky(H)
        h_ok = smallmat.chol_ok(H_chol)
        L = -smallmat.cho_solve_mat(H_chol, G)
        dl = -smallmat.cho_solve_vec(H_chol, g)
    else:
        h_ok = torch.ones_like(m_ok)
        L = L_traj
        dl = torch.zeros_like(g) if dl_traj is None else dl_traj
    ds = (approx.q + 0.5 * _dot(dl, _mv(H, dl)) + _dot(dl, g)
          + _risk_terms(th2, theta_safe, W, S, s_vec, M_chol, logdet_W))
    return g, G, H, L, dl, ds, m_ok, h_ok


def _riccati_core_parallel(approx, theta: Tensor, mu: Tensor,
                           L_traj: Optional[Tensor],
                           dl_traj: Optional[Tensor]):
    """Parallel equivalent of :func:`ratilqr_tpu_torch.ops.riccati.
    _riccati_core`: returns ``(dp, L, dl, m_fail, h_fail)``."""
    Bn, T = approx.A.shape[0], approx.A.shape[1]
    S_all, v_all = _suffix_values(_build_elements(approx, theta, mu, L_traj,
                                                  dl_traj))
    # S_t = S_all[2t]; step t's gains need S_{t+1} = S_all[2(t+1)].
    S_bound, v_bound = S_all[:, ::2], v_all[:, ::2]
    g, G, H, L, dl, ds, m_ok, h_ok = _per_step(
        approx, theta, mu, S_bound[:, 1:], v_bound[:, 1:], L_traj, dl_traj)
    s = approx.q_term[:, None] + torch.cat(
        [ds.flip(1).cumsum(1).flip(1), ds.new_zeros((Bn, 1))], 1)
    # The first failure walking backward (the largest failing t) latches;
    # M beats H at the same step, as in the sequential pass.
    t_idx = torch.arange(T, device=ds.device)
    tm = torch.where(~m_ok, t_idx, -1).amax(1)
    th = torch.where(~h_ok, t_idx, -1).amax(1)
    any_fail = (tm >= 0) | (th >= 0)
    m_first = any_fail & (tm >= th)
    dp = DPResult(s=s, s_vec=v_bound, S=S_bound, g=g, G=G, H=H)
    return dp, L, dl, m_first, any_fail & ~m_first


def dp_evaluate_parallel(approx, L_traj: Tensor,
                         dl_traj: Optional[Tensor] = None, *, theta, mu
                         ) -> Tuple[DPResult, Tensor]:
    """O(log T)-depth policy-evaluating pass ≡ :func:`ratilqr_tpu_torch.
    ops.riccati.dp_evaluate`; returns ``(dp, m_fail)``."""
    theta, mu = _lanes(theta, approx.q), _lanes(mu, approx.q)
    dp, _, _, m_fail, _ = _riccati_core_parallel(approx, theta, mu, L_traj,
                                                 dl_traj)
    return dp, m_fail


def dp_optimize_parallel(approx, *, theta, mu, delta, mu_min: float,
                         delta_0: float,
                         max_restarts: int = MAX_MU_RESTARTS):
    """O(log T)-depth policy-optimizing pass ≡ :func:`ratilqr_tpu_torch.
    ops.riccati.dp_optimize`, with the per-lane μ-restart loop around the
    whole pass; returns ``(dp, L, dl, mu, delta, failed)``."""
    theta, mu, delta = (_lanes(v, approx.q) for v in (theta, mu, delta))
    return mu_restart_loop(
        lambda mu_v: _riccati_core_parallel(approx, theta, mu_v, None, None),
        mu, delta, mu_min, delta_0, max_restarts)
