"""Trajectory rollouts — counterpart of :mod:`ratilqr_tpu.ops.rollout`.

Every function takes a bank: one leading axis ``B`` on every tensor
(``x0 (B, n)``, ``u_traj (B, T, m)``, ``L_traj (B, T, m, n)``).  The
``lax.scan`` over time becomes a Python loop over ``T``; each step applies
the problem's unbatched callbacks to the whole bank through
``torch.func.vmap``.  The noisy and generative rollouts are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import jacfwd, vmap

from ratilqr_tpu_torch.problems import RiskSensitiveProblem

Tensor = torch.Tensor


def bank_f(problem: RiskSensitiveProblem) -> Callable:
    """``(x (B, n), u (B, m)) -> x_next (B, n)``."""
    return vmap(problem.f)


def bank_f_jac(problem: RiskSensitiveProblem) -> Callable:
    """``(x, u) -> (x_next, A (B, n, n), B (B, n, m))`` from the problem's
    ``f_jac`` when it has one, else forward-mode AD of ``f``."""
    if problem.has_jacobian:
        return vmap(problem.f_jac)

    def value_and_aux(x, u):
        y = problem.f(x, u)
        return y, y

    jac = jacfwd(value_and_aux, argnums=(0, 1), has_aux=True)

    def fj(x, u):
        (A, B), x_next = jac(x, u)
        # Forward-mode AD can promote float32 tangents to float64 when a
        # Python scalar multiplies a 0-d tensor; keep the working dtype.
        return x_next, A.to(x.dtype), B.to(x.dtype)

    return vmap(fj)


def feedback_control(l_t: Tensor, L_t: Tensor, x: Tensor,
                     x_ref_t: Tensor) -> Tensor:
    """Affine policy ``u = l + L (x − x̄)`` over a bank."""
    return l_t + (L_t * (x - x_ref_t).unsqueeze(-2)).sum(-1)


def rollout_open_loop(problem: RiskSensitiveProblem, x0: Tensor,
                      u_traj: Tensor) -> Tensor:
    """Noiseless open-loop rollout ``x_{t+1} = f(x_t, u_t)``
    (``ileqg.jl:18-38``); returns ``x (B, T+1, n)``."""
    f = bank_f(problem)
    xs = [x0]
    for t in range(u_traj.shape[1]):
        xs.append(f(xs[-1], u_traj[:, t]))
    return torch.stack(xs, 1)


def rollout_open_loop_with_jac(problem: RiskSensitiveProblem, x0: Tensor,
                               u_traj: Tensor
                               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Open-loop rollout collecting ``A_t, B_t`` (``ileqg.jl:24-31``);
    returns ``(x (B, T+1, n), A (B, T, n, n), B (B, T, n, m))``."""
    fj = bank_f_jac(problem)
    xs, As, Bs = [x0], [], []
    for t in range(u_traj.shape[1]):
        x_next, A, B = fj(xs[-1], u_traj[:, t])
        xs.append(x_next)
        As.append(A)
        Bs.append(B)
    return torch.stack(xs, 1), torch.stack(As, 1), torch.stack(Bs, 1)


def rollout_feedback(problem: RiskSensitiveProblem, x_ref: Tensor,
                     l_traj: Tensor, L_traj: Tensor
                     ) -> Tuple[Tensor, Tensor]:
    """Closed-loop rollout under ``u_t = l_t + L_t (x_t − x̄_t)`` from
    ``x̄_0`` (``ileqg.jl:62-87``); returns ``(x (B, T+1, n), u (B, T, m))``.
    """
    f = bank_f(problem)
    x = x_ref[:, 0]
    xs, us = [x], []
    for t in range(l_traj.shape[1]):
        u = feedback_control(l_traj[:, t], L_traj[:, t], x, x_ref[:, t])
        x = f(x, u)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, 1), torch.stack(us, 1)


def rollout_feedback_with_jac(problem: RiskSensitiveProblem, x_ref: Tensor,
                              l_traj: Tensor, L_traj: Tensor
                              ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Closed-loop rollout collecting Jacobians (``ileqg.jl:71-79``);
    returns ``(x, u, A, B)``."""
    fj = bank_f_jac(problem)
    x = x_ref[:, 0]
    xs, us, As, Bs = [x], [], [], []
    for t in range(l_traj.shape[1]):
        u = feedback_control(l_traj[:, t], L_traj[:, t], x, x_ref[:, t])
        x, A, B = fj(x, u)
        xs.append(x)
        us.append(u)
        As.append(A)
        Bs.append(B)
    return (torch.stack(xs, 1), torch.stack(us, 1), torch.stack(As, 1),
            torch.stack(Bs, 1))
