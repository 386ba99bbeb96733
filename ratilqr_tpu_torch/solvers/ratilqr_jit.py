"""RAT iLQR with the single-call semantics of :mod:`ratilqr_tpu.solvers.
ratilqr_jit` (``cross_entropy_bilevel_optimization.jl:364-415``).

The JAX module compiles the whole ``solve!`` into one device program, so a
re-plan is one dispatch.  PyTorch has no such program: here the CE
generations, the redraw loop and the θ-backoff are host loops over the
same bank as :mod:`ratilqr_tpu_torch.solvers.ratilqr`, and the device
synchronizes with the host at least as often as on that path (once per
redraw for the costs, plus the bank's own per-round syncs).  What this
module keeps are the JAX module's results, where they differ from the host
path's:

  - the feasibility redraws stop after ``MAX_REDRAWS`` and set
    ``redraws_exhausted`` instead of raising; the generation then refits on
    the last, partly-Inf sample set;
  - the final re-solve retries at most ``MAX_FINAL_RETRIES`` times, the
    last retry forced to θ = 0, and reports ``final_failed`` instead of
    raising;
  - ``kl_bound == 0`` leaves the state's ``iter_current`` at 0, else it is
    ``iter_max``.

Elite ties are broken lower index first, the same elite set as the JAX
module's ``lax.top_k`` and the host path's stable sort.
"""
from __future__ import annotations

import torch

from ratilqr_tpu_torch.config import CrossEntropyConfig
from ratilqr_tpu_torch.problems import RiskSensitiveProblem, problem_device
from ratilqr_tpu_torch.solvers.ratilqr import (CEState, RATiLQRResult,
                                               _scalar, draw_generation,
                                               make_cost_fn, plan_value,
                                               refit, reset, solve_one)

MAX_FINAL_RETRIES = 25   # the last retry forces θ = 0


def solve(problem: RiskSensitiveProblem, config: CrossEntropyConfig,
          state: CEState, x0, u_init, generator: torch.Generator,
          kl_bound: float) -> RATiLQRResult:
    """RAT iLQR ``solve!`` that never raises on an exhausted budget; returns
    the same :class:`RATiLQRResult` as the host path, with its flags set."""
    kl_bound = float(kl_bound)
    x0 = torch.as_tensor(x0, device=problem_device(problem))
    dtype = x0.dtype
    u_init = torch.as_tensor(u_init, dtype=dtype, device=x0.device)
    state = reset(state, dtype)
    cost_fn = make_cost_fn(problem, config)
    exhausted = False
    if kl_bound > 0:
        for _ in range(config.iter_max):
            state, thetas, costs, done = draw_generation(
                config, state, cost_fn, x0, u_init, kl_bound, generator,
                config.verbose)
            exhausted = exhausted or not done
            state = refit(config, state, thetas, costs)
        theta_opt = float(state.theta_max if config.use_theta_max
                          else state.mu)
    else:
        theta_opt = 0.0

    sigma = float(state.sigma)
    res = solve_one(cost_fn.bank, x0, u_init, theta_opt)
    k = 0
    while bool(res.failed) and k < MAX_FINAL_RETRIES:
        theta_opt = max(0.0, theta_opt - sigma)
        if k + 1 >= MAX_FINAL_RETRIES:
            theta_opt = 0.0
        res = solve_one(cost_fn.bank, x0, u_init, theta_opt)
        k += 1

    zero = _scalar(0.0, dtype)
    ce = kl_bound > 0
    return RATiLQRResult(
        theta_opt=_scalar(theta_opt, dtype), x=res.x, l=res.l, L=res.L,
        value=plan_value(res, kl_bound, theta_opt),
        theta_min=state.theta_min if ce else zero,
        theta_max=state.theta_max if ce else zero,
        state=state._replace(iter_current=config.iter_max if ce else 0),
        redraws_exhausted=exhausted, final_failed=bool(res.failed))
