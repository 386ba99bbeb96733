"""iLQG / iLEQG solver bank — counterpart of :mod:`ratilqr_tpu.solvers.ileqg`.

The JAX solver is one jitted function whose ``lax.while_loop``s get
per-lane termination from ``vmap``'s batching rule.  Here the bank is
explicit: every tensor carries a leading lane axis ``B``, and every loop is
a host loop over per-lane masks with one device sync per round:

  - outer iteration: a lane is ``active`` until ``done``; each round runs
    :func:`step` and then selects every state field with
    ``where(active, new, old)``, so finished lanes freeze;
  - μ-restarts: per-lane μ/Δ escalation and restart count
    (:func:`ratilqr_tpu_torch.ops.riccati.mu_restart_loop`);
  - line search: per-lane ``accepted``/``count`` masks, the acceptance rule
    ``isapprox(new, cur) | new < cur`` and the forced accept below ``ε_min``;
  - adaptive ε_init: the restore loop with its underflow guard ``e > 0``.

Lanes whose results a round discards (finished lanes, lanes whose
optimizing DP failed) are left out of the inner loops, which changes no
result.  On a CUDA device the DP passes run kernel A (default config) or
the fused kernels B and C (``fused_step_optimize`` /
``fused_candidate_eval``); on the CPU they run their plain versions.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ratilqr_tpu_torch.config import ILEQGConfig
from ratilqr_tpu_torch.ops.approx import (NoiseModel, approximate_model,
                                          noise_model)
from ratilqr_tpu_torch.ops.candidate_cuda import candidate_bank
from ratilqr_tpu_torch.ops.riccati import (dp_evaluate, dp_optimize,
                                           select)
from ratilqr_tpu_torch.ops.rollout import (rollout_feedback,
                                           rollout_feedback_with_jac,
                                           rollout_open_loop,
                                           rollout_open_loop_with_jac)
from ratilqr_tpu_torch.ops.step_cuda import step_optimize
from ratilqr_tpu_torch.problems import RiskSensitiveProblem
from ratilqr_tpu_torch.utils.numerics import isapprox, max_control_deviation

Tensor = torch.Tensor


class ILEQGResult(NamedTuple):
    """Same fields as :class:`ratilqr_tpu.solvers.ileqg.ILEQGResult`, with
    a leading lane axis on a bank's result."""
    x: Tensor            # (B, T+1, n)
    l: Tensor            # (B, T, m)
    L: Tensor            # (B, T, m, n)
    value: Tensor        # (B,)  +Inf where failed
    eps_history: Tensor  # (B, cap, 2)
    eps_count: Tensor    # (B,) int32
    iterations: Tensor   # (B,) int32
    d_final: Tensor      # (B,)
    mu_final: Tensor     # (B,)
    failed: Tensor       # (B,) bool


class ILEQGState(NamedTuple):
    """Outer-iteration state of a bank (``ileqg.py:_State``); the nominal
    trajectory is not carried but re-derived from ``(x0, l)``."""
    l: Tensor
    L: Tensor
    value: Tensor
    mu: Tensor
    delta: Tensor
    d_current: Tensor
    eps_init_cur: Tensor
    iterations: Tensor
    eps_hist: Tensor
    eps_count: Tensor
    done: Tensor
    failed: Tensor


def _check_config(config: ILEQGConfig) -> None:
    if config.ls_chunk > 1:
        raise NotImplementedError("ls_chunk > 1 (the batched ε ladder) is "
                                  "not ported yet; use ls_chunk=1")
    if config.fold_candidate_eval:
        raise NotImplementedError("fold_candidate_eval is not ported yet; "
                                  "use fused_candidate_eval or neither")


def _push_hist(hist: Tensor, count: Tensor, valid: Tensor, eps: Tensor,
               dval: Tensor):
    """Append (ε, Δvalue) per lane where ``valid`` to the saturating
    history (first cap−1 trials plus the latest); ``cap == 0`` only
    counts."""
    cap = hist.shape[1]
    new_count = count + valid.to(count.dtype)
    if cap == 0:
        return hist, new_count
    rows = torch.arange(hist.shape[0], device=hist.device)
    idx = torch.clamp(count, max=cap - 1).long()
    entry = torch.stack([eps, dval], -1).to(hist.dtype)
    hist = hist.clone()
    hist[rows, idx] = torch.where(valid[:, None], entry, hist[rows, idx])
    return hist, new_count


def line_search(problem: RiskSensitiveProblem, config: ILEQGConfig,
                state: ILEQGState, x_ref: Tensor, dl: Tensor, theta: Tensor,
                noise: NoiseModel, active: Optional[Tensor] = None
                ) -> ILEQGState:
    """Backtracking line search (``ileqg.jl:494-592``) over a bank."""
    lam = config.lam

    def eval_candidate(eps):
        l_cand = state.l + eps[:, None, None] * dl
        if config.fused_candidate_eval:
            value_new, fail = candidate_bank(problem, x_ref, l_cand, state.L,
                                             state.mu, theta, noise)
        else:
            x_new, u_new, A_new, B_new = rollout_feedback_with_jac(
                problem, x_ref, l_cand, state.L)
            approx = approximate_model(problem, u_new, x_new, A_new, B_new,
                                       noise)
            value_new, fail = dp_evaluate(approx, state.L, None, theta=theta,
                                          mu=state.mu, slim=True)
        return value_new, ~fail

    eps = state.eps_init_cur
    count = torch.zeros_like(state.iterations)
    accepted = torch.zeros_like(state.done)
    eps_acc = torch.zeros_like(eps)
    value_c = state.value
    hist, hist_n = state.eps_hist, state.eps_count
    while True:
        running = ~accepted & (count < config.ls_max_trials)
        if active is not None:
            running = running & active
        if not bool(running.any()):
            break
        value_new, evaluated = eval_candidate(eps)
        hist_new, hist_n_new = _push_hist(hist, hist_n, evaluated, eps,
                                          value_new - state.value)
        accept = evaluated & (isapprox(value_new, state.value)
                              | (value_new < state.value))
        eps_next = torch.where(accept, eps, eps * lam)
        # ε_min reached → accept the already-evaluated candidate anyway.
        forced = evaluated & ~accept & (eps_next < config.eps_min)
        take = running & (accept | forced)
        eps_acc = torch.where(take, eps, eps_acc)
        value_c = torch.where(take, value_new, value_c)
        accepted = accepted | take
        hist = select(running, hist_new, hist)
        hist_n = torch.where(running, hist_n_new, hist_n)
        eps = torch.where(running, eps_next, eps)
        count = count + running.to(count.dtype)

    # Re-materialize the accepted candidate's realized controls (lanes that
    # accepted nothing have eps_acc = 0 and keep the pre-search state).
    l_acc = state.l + eps_acc[:, None, None] * dl
    _, u_n = rollout_feedback(problem, x_ref, l_acc, state.L)
    d_n = max_control_deviation(state.l, u_n)

    if config.adaptive_eps_init:  # ileqg.jl:582-591
        grown = torch.clamp(eps / lam, max=config.eps_init)
        # Bring ε back above ε_min; e > 0 guards f32 underflow to 0.
        restored = eps
        while True:
            low = (restored < config.eps_min) & (restored > 0)
            if not bool(low.any()):
                break
            restored = torch.where(low, restored / lam, restored)
        restored = torch.clamp(restored, min=config.eps_min)
        eps_init_next = torch.where(count == 1, grown, restored)
    else:
        eps_init_next = state.eps_init_cur

    return state._replace(
        l=select(accepted, u_n, state.l), value=value_c,
        d_current=torch.where(accepted, d_n, state.d_current),
        eps_hist=hist, eps_count=hist_n, eps_init_cur=eps_init_next,
        failed=state.failed | ~accepted)


def step(problem: RiskSensitiveProblem, config: ILEQGConfig,
         state: ILEQGState, theta: Tensor, x0: Tensor, noise: NoiseModel,
         active: Optional[Tensor] = None) -> ILEQGState:
    """One iLEQG iteration: rollout + approximation + optimizing DP, then
    the line search (``ileqg.jl:598-613``)."""
    if config.fused_step_optimize:
        x, _, L_new, dl, mu, delta, fail_opt = step_optimize(
            problem, x0, state.l, theta=theta, mu=state.mu, delta=state.delta,
            mu_min=config.mu_min, delta_0=config.delta_0, noise=noise,
            active=active)
    else:
        x, A, B = rollout_open_loop_with_jac(problem, x0, state.l)
        approx = approximate_model(problem, state.l, x, A, B, noise)
        _, L_new, dl, mu, delta, fail_opt = dp_optimize(
            approx, theta=theta, mu=state.mu, delta=state.delta,
            mu_min=config.mu_min, delta_0=config.delta_0, slim=True,
            active=active)
    state = state._replace(L=L_new, mu=mu, delta=delta,
                           iterations=state.iterations + 1,
                           failed=state.failed | fail_opt)
    searching = ~state.failed if active is None else active & ~state.failed
    ls_state = line_search(problem, config, state, x, dl, theta, noise,
                           searching)
    # A failed optimizing DP keeps the pre-search state; failure latches.
    return select(state.failed, state, ls_state)._replace(
        failed=state.failed | ls_state.failed)


def initialize(problem: RiskSensitiveProblem, config: ILEQGConfig,
               x0: Tensor, u_init: Tensor, theta: Tensor,
               noise: NoiseModel) -> ILEQGState:
    """``initialize!`` (``ileqg.jl:214-236``): μ←0, Δ←Δ₀, zero gains, value
    from one policy-evaluating pass of the nominal rollout."""
    Bn, T, m = u_init.shape
    n = x0.shape[-1]
    dtype, device = x0.dtype, x0.device
    L = torch.zeros((Bn, T, m, n), dtype=dtype, device=device)
    zeros = torch.zeros(Bn, dtype=dtype, device=device)
    if config.fused_candidate_eval:
        # With L = 0 the closed-loop candidate is the open-loop rollout of
        # u_init from x̄_0 = x0.
        x_ref0 = x0[:, None, :].expand(Bn, T + 1, n).contiguous()
        value0, fail = candidate_bank(problem, x_ref0, u_init, L, zeros,
                                      theta, noise)
    else:
        x, A, B = rollout_open_loop_with_jac(problem, x0, u_init)
        approx = approximate_model(problem, u_init, x, A, B, noise)
        value0, fail = dp_evaluate(approx, L, None, theta=theta, mu=zeros,
                                   slim=True)
    i0 = torch.zeros(Bn, dtype=torch.int32, device=device)
    return ILEQGState(
        l=u_init, L=L, value=value0, mu=zeros,
        delta=torch.full_like(zeros, config.delta_0),
        d_current=torch.full_like(zeros, float("inf")),
        eps_init_cur=torch.full_like(zeros, config.eps_init),
        iterations=i0,
        eps_hist=torch.zeros((Bn, config.eps_history_cap, 2), dtype=dtype,
                             device=device),
        eps_count=i0.clone(), done=fail, failed=fail)


def solve_bank(problem: RiskSensitiveProblem, config: ILEQGConfig,
               x0: Tensor, u_init: Tensor, theta: Tensor,
               noise: Optional[NoiseModel] = None) -> ILEQGResult:
    """Solve a bank: ``x0 (B, n)``, ``u_init (B, T, m)``, ``theta (B,)``;
    iLQG where θ = 0, iLEQG where θ > 0 (``ileqg.jl:635-659``)."""
    _check_config(config)
    if noise is None:
        noise = noise_model(problem, u_init.shape[1], x0.dtype, x0.device)
    state = initialize(problem, config, x0, u_init, theta, noise)
    while True:
        active = ~state.done
        if not bool(active.any()):
            break
        new = step(problem, config, state, theta, x0, noise, active)
        converged = (new.d_current < config.d_tol) & (new.mu <= config.mu_min)
        done = converged | (new.iterations >= config.iter_max) | new.failed
        state = select(active, new._replace(done=done), state)
        if config.verbose:
            print(f"--iLEQG round: {int(active.sum())} active lanes, "
                  f"max iterations {int(state.iterations.max())}")
    value = torch.where(state.failed, torch.full_like(state.value,
                                                      float("inf")),
                        state.value)
    x_final = rollout_open_loop(problem, x0, state.l)
    return ILEQGResult(x=x_final, l=state.l, L=state.L, value=value,
                       eps_history=state.eps_hist, eps_count=state.eps_count,
                       iterations=state.iterations, d_final=state.d_current,
                       mu_final=state.mu, failed=state.failed)


def make_batched_solver(problem: RiskSensitiveProblem, config: ILEQGConfig,
                        device=None):
    """θ-bank solver ``(x0, u_init, thetas) -> ILEQGResult`` batched over
    ``thetas (B,)``; ``x0 (n,)`` and ``u_init (T, m)`` are shared by every
    lane (or given per lane as ``(B, n)``/``(B, T, m)``).

    Inputs are moved to ``device`` (default: the device of ``thetas``) in
    the dtype of ``x0``.  The only state kept between calls is the
    problem's noise model per (horizon, dtype, device).
    """
    _check_config(config)
    noise_cache = {}

    def bank(x0, u_init, thetas) -> ILEQGResult:
        thetas = torch.as_tensor(thetas)
        dev = torch.device(device) if device is not None else thetas.device
        x0 = torch.as_tensor(x0, device=dev)
        dtype = x0.dtype
        u_init = torch.as_tensor(u_init, dtype=dtype, device=dev)
        thetas = thetas.to(dtype=dtype, device=dev)
        Bn = thetas.shape[0]
        if x0.dim() == 1:
            x0 = x0.expand(Bn, -1).contiguous()
        if u_init.dim() == 2:
            u_init = u_init.expand(Bn, -1, -1).contiguous()
        T = u_init.shape[1]
        key = (T, dtype, dev)
        if key not in noise_cache:
            noise_cache[key] = noise_model(problem, T, dtype, dev)
        return solve_bank(problem, config, x0, u_init, thetas,
                          noise_cache[key])

    return bank


def solve(problem: RiskSensitiveProblem, config: ILEQGConfig, x0, u_init,
          theta) -> ILEQGResult:
    """One solve (``ileqg.jl:635-659``), run as a one-lane bank; the
    result has no lane axis."""
    x0 = torch.as_tensor(x0)
    theta = torch.as_tensor(theta, dtype=x0.dtype, device=x0.device)
    res = make_batched_solver(problem, config)(x0, u_init, theta.reshape(1))
    return ILEQGResult(*(f[0] for f in res))


# The JAX package routes single solves through a one-lane bank to reach its
# kernels; here every solve already is a bank.
solve_via_bank = solve
