"""Trajectory rollouts — counterpart of :mod:`ratilqr_tpu.ops.rollout`.

Every function takes a bank: one leading axis ``B`` on every tensor
(``x0 (B, n)``, ``u_traj (B, T, m)``, ``L_traj (B, T, m, n)``).  The
``lax.scan`` over time becomes a Python loop over ``T``; each step applies
the problem's unbatched callbacks to the whole bank through
``torch.func.vmap``.  Random draws happen outside ``vmap``, for the whole
bank at once, from an explicit ``torch.Generator`` (on its device, then
placed on the bank's); every noisy rollout also takes the draws from the
caller instead.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.func import jacfwd, vmap

from ratilqr_tpu_torch.problems import GenerativeProblem, RiskSensitiveProblem
from ratilqr_tpu_torch.utils.profiling import spanned

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


def feedback_control_traj(l_traj: Tensor, L_traj: Tensor, x_traj: Tensor,
                          x_ref: Tensor) -> Tensor:
    """:func:`feedback_control` at every step of a bank's trajectories at
    once: ``l (B, T, m)``, ``L (B, T, m, n)``, ``x``/``x_ref (B, T, n)``.
    ``L (x − x̄)`` is accumulated one state component at a time, so no
    ``(B, T, m, n)`` product is made, and on the kernels' lane-minor
    layouts every operation reads whole runs of lanes."""
    dx = x_traj - x_ref
    acc = L_traj[..., 0] * dx[..., :1]
    for c in range(1, dx.shape[-1]):
        acc.addcmul_(L_traj[..., c], dx[..., c:c + 1])
    return l_traj + acc


@spanned("rollout_open_loop")
def rollout_open_loop(problem: RiskSensitiveProblem, x0: Tensor,
                      u_traj: Tensor) -> Tensor:
    """Noiseless open-loop rollout ``x_{t+1} = f(x_t, u_t)``
    (``ileqg.jl:18-38``); returns ``x (B, T+1, n)``."""
    f = bank_f(problem)
    xs = [x0]
    for t in range(u_traj.shape[1]):
        xs.append(f(xs[-1], u_traj[:, t]))
    return torch.stack(xs, 1)


@spanned("rollout_open_loop_with_jac")
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


def _gaussian_noise(problem: RiskSensitiveProblem, x0: Tensor, T: int,
                   generator: Optional[torch.Generator] = None,
                   z: Optional[Tensor] = None) -> Tensor:
    """Process noise ``w_t = chol(W(t)) z_t`` of every lane, ``(B, T,
    n)``: ``z (B, T, n)`` standard normal, given or drawn from
    ``generator``."""
    Bn, n = x0.shape
    if z is None:
        z = torch.randn((Bn, T, n), generator=generator, dtype=x0.dtype,
                        device=generator.device)
    z = torch.as_tensor(z, dtype=x0.dtype, device=x0.device)
    W = torch.stack([torch.as_tensor(problem.W(k), dtype=x0.dtype,
                                     device=x0.device) for k in range(T)])
    return torch.einsum("tij,btj->bti", torch.linalg.cholesky(W), z)


def rollout_open_loop_noisy(problem: RiskSensitiveProblem, x0: Tensor,
                            u_traj: Tensor,
                            generator: Optional[torch.Generator] = None,
                            z: Optional[Tensor] = None) -> Tensor:
    """Noisy open-loop rollout ``x_{t+1} = f(x_t, u_t) + w_t``, ``w_t ~
    N(0, W(t))`` (``ileqg.jl:44-55``), with ``w_t = chol(W(t)) z_t`` from
    standard-normal ``z (B, T, n)`` (given, or drawn from ``generator``);
    returns ``x (B, T+1, n)``."""
    f = bank_f(problem)
    ws = _gaussian_noise(problem, x0, u_traj.shape[1], generator, z)
    xs = [x0]
    for t in range(u_traj.shape[1]):
        xs.append(f(xs[-1], u_traj[:, t]) + ws[:, t])
    return torch.stack(xs, 1)


def integrate_cost(problem: RiskSensitiveProblem, x_traj: Tensor,
                   u_traj: Tensor) -> Tensor:
    """Total trajectory cost ``Σ_k c(k, x_k, u_k) + h(x_T)``
    (``ileqg.jl:115-124``) of each lane: ``x_traj (B, T+1, n)``, ``u_traj
    (B, T, m)`` -> ``(B,)``."""
    c, h = vmap(problem.c), vmap(problem.h)
    Bn, T = u_traj.shape[:2]
    total = h(x_traj[:, T])
    stage = [c(torch.full((Bn,), t, device=x_traj.device), x_traj[:, t],
               u_traj[:, t]) for t in range(T)]
    return torch.stack(stage, 1).sum(1) + total


@spanned("rollout_feedback")
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


@spanned("rollout_feedback_with_jac")
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


def rollout_feedback_noisy(problem: RiskSensitiveProblem, x_ref: Tensor,
                           l_traj: Tensor, L_traj: Tensor,
                           generator: Optional[torch.Generator] = None,
                           z: Optional[Tensor] = None
                           ) -> Tuple[Tensor, Tensor]:
    """Noisy closed-loop rollout under ``u_t = l_t + L_t (x_t − x̄_t)``
    from ``x̄_0`` (``ileqg.jl:94-109``), the noise as in
    :func:`rollout_open_loop_noisy`; returns ``(x, u)``."""
    f = bank_f(problem)
    x = x_ref[:, 0]
    ws = _gaussian_noise(problem, x, l_traj.shape[1], generator, z)
    xs, us = [x], []
    for t in range(l_traj.shape[1]):
        u = feedback_control(l_traj[:, t], L_traj[:, t], x, x_ref[:, t])
        x = f(x, u) + ws[:, t]
        xs.append(x)
        us.append(u)
    return torch.stack(xs, 1), torch.stack(us, 1)


def rollout_generative(problem: GenerativeProblem, x0: Tensor,
                       u_traj: Tensor,
                       generator: Optional[torch.Generator] = None,
                       use_true_model: bool = False,
                       noise: Optional[Sequence] = None
                       ) -> Tuple[Tensor, Tensor]:
    """Stochastic rollouts of a generative problem with their costs (the
    inner loop of PETS' ``compute_cost_worker``, ``pets.jl:84-97``):
    ``x_{t+1} = f_stochastic(x_t, u_t, noise_t)`` accumulating ``Σ c(t,
    x_t, u_t) + h(x_T)``.  ``noise`` is one per-step draw a time step (as
    ``problem.draw_noise`` gives them); without it each step draws from
    ``generator``.  Returns ``(x (B, T+1, n), cost (B,))``."""
    Bn, T = u_traj.shape[:2]
    c = vmap(problem.c)
    f = vmap(lambda x, u, w: problem.f_stochastic(x, u, w, use_true_model))
    x = x0
    xs, cost = [x0], torch.zeros(Bn, dtype=x0.dtype, device=x0.device)
    for t in range(T):
        cost = cost + c(torch.full((Bn,), t, device=x.device), x,
                        u_traj[:, t])
        w = (problem.draw_noise(generator, x, use_true_model)
             if noise is None else noise[t])
        x = f(x, u_traj[:, t], w)
        xs.append(x)
    return torch.stack(xs, 1), cost + vmap(problem.h)(x)
