"""Model approximation: linearize dynamics, quadratize costs.

Counterpart of :mod:`ratilqr_tpu.ops.approx` over a bank: the JAX
time-``vmap`` of ``jax.grad``/``jax.hessian``/``jax.jacfwd`` becomes one
``torch.func.vmap`` over the flattened ``(B·T)`` stage axis of the same
``torch.func`` transforms.  The noise model ``W``/``W⁻¹``/``logdet W`` is
lane-invariant and stays UNBATCHED (``(T, n, n)``/``(T,)``); the Riccati
functions broadcast it, and the CUDA kernels read one shared copy.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import grad, hessian, jacfwd, vmap

from ratilqr_tpu_torch.ops import smallmat
from ratilqr_tpu_torch.ops.rollout import (bank_f_jac,
                                           rollout_feedback_with_jac,
                                           rollout_open_loop_with_jac)
from ratilqr_tpu_torch.ops.smallmat import sym
from ratilqr_tpu_torch.problems import RiskSensitiveProblem

Tensor = torch.Tensor


class NoiseModel(NamedTuple):
    """Lane-invariant noise model of a problem over a horizon."""
    W: Tensor         # (T, n, n)
    W_inv: Tensor     # (T, n, n)
    logdet_W: Tensor  # (T,)


def noise_model(problem: RiskSensitiveProblem, T: int, dtype,
                device) -> NoiseModel:
    """``W(k)`` for ``k < T`` with its closed-form inverse and log-det."""
    W = torch.stack([torch.as_tensor(problem.W(k), dtype=dtype,
                                     device=device) for k in range(T)])
    chol = smallmat.cholesky(W)
    return NoiseModel(W, smallmat.cho_inverse(chol),
                      smallmat.cho_logdet(chol))


class Approximation(NamedTuple):
    """Bank of time-stacked Taylor approximations (``ileqg.jl:242-252``).

    Leading axis ``B`` on every field except the noise model, which may be
    shared ``(T, n, n)``/``(T,)`` or per-lane ``(B, T, n, n)``/``(B, T)``.
    """
    q: Tensor          # (B, T)
    q_vec: Tensor      # (B, T, n)
    Q: Tensor          # (B, T, n, n)
    r: Tensor          # (B, T, m)
    R: Tensor          # (B, T, m, m)
    P: Tensor          # (B, T, m, n)  c_ux
    A: Tensor          # (B, T, n, n)
    B: Tensor          # (B, T, n, m)
    W: Tensor          # (T, n, n) or (B, T, n, n)
    W_inv: Tensor      # (T, n, n) or (B, T, n, n)
    logdet_W: Tensor   # (T,) or (B, T)
    q_term: Tensor     # (B,)
    q_vec_term: Tensor  # (B, n)
    Q_term: Tensor     # (B, n, n)


class FoldedApprox(NamedTuple):
    """Closed-loop-folded evaluation stack (see
    :class:`ratilqr_tpu.ops.approx.FoldedApprox` for the algebra):
    ``q̄_vec = q_vec + Lᵀr``, ``Q̄ = sym(Q + LᵀP + PᵀL + LᵀRL + μLᵀL)``,
    ``Ā = A + BL``."""
    q: Tensor          # (B, T)
    q_vec: Tensor      # (B, T, n)
    Q: Tensor          # (B, T, n, n)
    A: Tensor          # (B, T, n, n)
    W: Tensor
    W_inv: Tensor
    logdet_W: Tensor
    q_term: Tensor
    q_vec_term: Tensor
    Q_term: Tensor


def _stage_derivatives(problem, x, u, with_control: bool):
    """``c`` and its derivatives at every ``(b, t)``; ``x``/``u`` are
    ``(B, T, ·)``.  Returns ``(q, q_vec, Q[, r, R, P])`` shaped
    ``(B, T, ·)``."""
    c = problem.c
    Bn, T = u.shape[0], u.shape[1]
    ks = torch.arange(T, device=u.device).repeat(Bn)

    def stage(k, xk, uk):
        out = (c(k, xk, uk), grad(c, argnums=1)(k, xk, uk),
               sym(hessian(c, argnums=1)(k, xk, uk)))
        if with_control:
            out += (grad(c, argnums=2)(k, xk, uk),
                    sym(hessian(c, argnums=2)(k, xk, uk)),
                    jacfwd(grad(c, argnums=2), argnums=1)(k, xk, uk))
        return out

    flat = vmap(stage)(ks, x.reshape(Bn * T, -1), u.reshape(Bn * T, -1))
    return tuple(a.to(x.dtype).reshape((Bn, T) + a.shape[1:]) for a in flat)


def _terminal(problem, x_T):
    h = problem.h

    def term(x):
        return h(x), grad(h)(x), sym(hessian(h)(x))

    return tuple(a.to(x_T.dtype) for a in vmap(term)(x_T))


def approximate_model(problem: RiskSensitiveProblem, u_traj: Tensor,
                      x_traj: Tensor, A: Optional[Tensor] = None,
                      B: Optional[Tensor] = None,
                      noise: Optional[NoiseModel] = None) -> Approximation:
    """Time-stacked linear-quadratic approximation of a bank
    (``ileqg.jl:258-322``).

    ``A``/``B`` may be passed precomputed (``ileqg.jl:302-311``); a missing
    one comes from the problem's ``f_jac`` or from AD of ``f``.  ``noise``
    skips recomputing the lane-invariant noise model.
    """
    xs = x_traj[:, :-1]
    q, q_vec, Q, r, R, P = _stage_derivatives(problem, xs, u_traj, True)
    if A is None or B is None:
        Bn, T = u_traj.shape[0], u_traj.shape[1]
        _, A_ad, B_ad = bank_f_jac(problem)(xs.reshape(Bn * T, -1),
                                            u_traj.reshape(Bn * T, -1))
        A = A_ad.reshape((Bn, T) + A_ad.shape[1:]) if A is None else A
        B = B_ad.reshape((Bn, T) + B_ad.shape[1:]) if B is None else B
    if noise is None:
        noise = noise_model(problem, u_traj.shape[1], u_traj.dtype,
                            u_traj.device)
    q_term, q_vec_term, Q_term = _terminal(problem, x_traj[:, -1])
    return Approximation(q=q, q_vec=q_vec, Q=Q, r=r, R=R, P=P, A=A, B=B,
                         W=noise.W, W_inv=noise.W_inv,
                         logdet_W=noise.logdet_W, q_term=q_term,
                         q_vec_term=q_vec_term, Q_term=Q_term)


def approximate_folded(problem: RiskSensitiveProblem, x_ref: Tensor,
                       l_traj: Tensor, L_traj: Optional[Tensor] = None,
                       mu: Optional[Tensor] = None,
                       noise: Optional[NoiseModel] = None) -> FoldedApprox:
    """Rollout + quadratization + closed-loop fold
    (:func:`ratilqr_tpu.ops.approx.approximate_folded`) — the per-example
    meaning of the fused candidate kernel.

    With ``L_traj`` the policy ``u = l + L(x − x̄)`` is rolled out around
    ``x_ref (B, T+1, n)`` and folded with ``mu (B,)``; without it
    ``x_ref`` is the initial state ``(B, n)`` and the rollout is open loop
    (the fold degenerates to the raw stack).
    """
    fold = L_traj is not None
    if fold and mu is None:
        raise ValueError("approximate_folded: mu is required when L_traj "
                         "is given; pass zeros for an unregularized "
                         "evaluation")
    if fold:
        x_traj, u_traj, A, B = rollout_feedback_with_jac(
            problem, x_ref, l_traj, L_traj)
        q, q_vec, Q, r, R, P = _stage_derivatives(problem, x_traj[:, :-1],
                                                  u_traj, True)
        Lt = smallmat.mt(L_traj)
        q_vec = q_vec + smallmat.mv(Lt, r)
        LtP = smallmat.mm(Lt, P)
        Q = sym(Q + LtP + smallmat.mt(LtP)
                + smallmat.mm(Lt, smallmat.mm(R, L_traj))
                + mu[:, None, None, None] * smallmat.mm(Lt, L_traj))
        A = A + smallmat.mm(B, L_traj)
    else:
        x_traj, A, _ = rollout_open_loop_with_jac(problem, x_ref, l_traj)
        q, q_vec, Q = _stage_derivatives(problem, x_traj[:, :-1], l_traj,
                                         False)
    if noise is None:
        noise = noise_model(problem, l_traj.shape[1], l_traj.dtype,
                            l_traj.device)
    q_term, q_vec_term, Q_term = _terminal(problem, x_traj[:, -1])
    return FoldedApprox(q=q, q_vec=q_vec, Q=Q, A=A, W=noise.W,
                        W_inv=noise.W_inv, logdet_W=noise.logdet_W,
                        q_term=q_term, q_vec_term=q_vec_term, Q_term=Q_term)
