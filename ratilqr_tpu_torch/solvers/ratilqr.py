"""RAT iLQR — Cross-Entropy bilevel optimization over the risk parameter θ.

Counterpart of :mod:`ratilqr_tpu.solvers.ratilqr`
(``cross_entropy_bilevel_optimization.jl:70-415``).  Every CE generation is
one θ-bank solve (:func:`ratilqr_tpu_torch.solvers.ileqg.
make_batched_solver`), each lane one full iLEQG solve; infeasible lanes
surface as ``cost = Inf``.  The outer loop (sample → evaluate → elite
refit) runs on the host, as the reference's master process does: each
generation brings its costs to the host once.

Randomness comes from an explicit ``torch.Generator`` where the JAX code
takes a PRNG key; the warm-start state is an explicit :class:`CEState`
threaded through ``solve`` calls (the reference's mutable
``μ_init``/``σ_init``, ``…:66-68,297-305``).  Its scalars are 0-d CPU
tensors in the working dtype; the bank runs on the problem's device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ratilqr_tpu_torch.config import CrossEntropyConfig
from ratilqr_tpu_torch.problems import RiskSensitiveProblem, problem_device
from ratilqr_tpu_torch.solvers.ileqg import ILEQGResult, make_batched_solver

Tensor = torch.Tensor


class CEState(NamedTuple):
    """CE solver state (``cross_entropy_bilevel_optimization.jl:84-98``),
    threaded through ``solve`` calls."""
    mu_init: Tensor     # adapts across solves (MPC warm start, ref :66-68)
    sigma_init: Tensor
    mu: Tensor
    sigma: Tensor
    theta_min: Tensor   # minimum feasible θ encountered
    theta_max: Tensor   # maximum feasible θ encountered
    iter_current: int


class RATiLQRResult(NamedTuple):
    """``solve!`` return values (``…:348-355``) plus the updated state.

    ``redraws_exhausted``: a CE generation ran out of feasibility redraws
    (the single-call path proceeds with the partly-Inf sample set; the host
    path raises).  ``final_failed``: the final re-solve failed after its
    θ-backoff budget, so ``x``/``l``/``L`` are no usable plan and ``value``
    is +Inf (single-call path only; the host path raises)."""
    theta_opt: Tensor
    x: Tensor
    l: Tensor
    L: Tensor
    value: Tensor
    theta_min: Tensor
    theta_max: Tensor
    state: CEState
    redraws_exhausted: bool = False
    final_failed: bool = False


def _scalar(v, dtype) -> Tensor:
    return torch.tensor(float(v), dtype=dtype)


def init_state(config: CrossEntropyConfig, dtype=torch.float64) -> CEState:
    return CEState(mu_init=_scalar(config.mu_init, dtype),
                   sigma_init=_scalar(config.sigma_init, dtype),
                   mu=_scalar(config.mu_init, dtype),
                   sigma=_scalar(config.sigma_init, dtype),
                   theta_min=_scalar(np.inf, dtype),
                   theta_max=_scalar(0.0, dtype), iter_current=0)


def get_positive_samples(generator: torch.Generator, mu, sigma,
                         num_samples: int, dtype=torch.float64) -> Tensor:
    """``num_samples`` iid draws of θ ~ N(μ, σ) conditioned on θ > 0, on
    the generator's device.

    The reference rejection-samples (``…:233-246``); this draws the
    truncated normal directly by its inverse CDF, in float64 whatever
    ``dtype``: with ``a = −μ/σ`` and ``w ~ U(0, Φ(−a)]``,
    ``z = −Φ⁻¹(w) > a``.  Inverting the upper tail keeps it exact when
    ``a`` is large, where ``Φ(a)`` rounds to 1.
    """
    f64 = torch.float64
    dev = generator.device
    mu = torch.as_tensor(mu, dtype=f64, device=dev)
    sigma = torch.as_tensor(sigma, dtype=f64, device=dev)
    u = torch.rand(num_samples, generator=generator, dtype=f64, device=dev)
    w = (1.0 - u) * torch.special.ndtr(mu / sigma)
    return (mu - sigma * torch.special.ndtri(w)).to(dtype)


def costs_of(res: ILEQGResult, thetas: Tensor, kl_bound) -> Tensor:
    """Outer objective ``value + kl_bound/θ`` (``…:193``) of a bank
    result; a NaN objective is a failed solve and becomes +Inf (ratilqr.py
    :114-122), so elite sorting ranks it last."""
    cost = res.value + kl_bound / thetas
    return torch.where(torch.isnan(cost), torch.full_like(cost, np.inf),
                       cost)


@functools.lru_cache(maxsize=32)
def make_cost_fn(problem: RiskSensitiveProblem, config: CrossEntropyConfig):
    """Batched outer objective ``cost_fn(x0, u_init, thetas, kl_bound)``
    over a θ-bank on the problem's device; ``cost_fn.bank`` is its iLEQG
    bank.

    Cached on the problem's and config's field values (dataclass
    equality), not on object identity: an equal config rebuilt by the
    caller hits the cache.  Nothing is compiled, so a miss costs only the
    bank's noise model.
    """
    bank = make_batched_solver(problem, config.ileqg)
    dev = problem_device(problem)

    def cost_fn(x0, u_init, thetas, kl_bound) -> Tensor:
        x0 = torch.as_tensor(x0, device=dev)
        thetas = torch.as_tensor(thetas, dtype=x0.dtype, device=dev)
        return costs_of(bank(x0, u_init, thetas), thetas, kl_bound)

    cost_fn.bank = bank
    return cost_fn


def _update_theta_range(state: CEState, thetas: np.ndarray,
                        costs: np.ndarray) -> CEState:
    """θ_min/θ_max over feasible samples, in the reference's if/elseif
    order over samples (``…:314-324``)."""
    theta_min = float(state.theta_min)
    theta_max = float(state.theta_max)
    for th, c in zip(thetas, costs):
        if np.isinf(c):
            continue
        if th < theta_min:
            theta_min = th
        elif th > theta_max:
            theta_max = th
    return state._replace(
        theta_min=_scalar(theta_min, state.theta_min.dtype),
        theta_max=_scalar(theta_max, state.theta_max.dtype))


# Feasibility-redraw budget for one CE generation.  The reference's loop
# (``…:265-312``) is unbounded; both paths bound it and surface the failure.
MAX_REDRAWS = 25


def draw_thetas(config: CrossEntropyConfig, state: CEState,
                generator: torch.Generator) -> Tensor:
    """One draw of ``num_samples`` θ for the generation ``state`` is in:
    from ``(μ_init, σ_init)`` in generation 1, else from ``(μ, σ)``."""
    first = state.iter_current == 1
    mu_s, sigma_s = ((state.mu_init, state.sigma_init) if first
                     else (state.mu, state.sigma))
    return get_positive_samples(generator, mu_s, sigma_s,
                                config.num_samples, state.mu.dtype)


def judge_draw(config: CrossEntropyConfig, state: CEState,
               num_valid: int):
    """The verdict on one draw with ``num_valid`` feasible samples
    (``…:265-305``): ``(state, accepted)``.  In generation 1 too few
    feasible lanes shrink ``μ_init/σ_init`` by λ and redraw, and an
    all-feasible draw grows them by 1/λ (both persist to the next MPC
    cycle, ref :293-305); later generations redraw with unchanged (μ, σ)
    while too few are feasible."""
    lam = config.lam
    threshold = max(config.num_elite, config.num_samples * lam)
    first = state.iter_current == 1
    if first and num_valid < threshold:
        return state._replace(mu_init=state.mu_init * lam,
                              sigma_init=state.sigma_init * lam), False
    if first and num_valid == config.num_samples:
        return state._replace(mu_init=state.mu_init / lam,
                              sigma_init=state.sigma_init / lam), True
    return state, num_valid >= threshold


def draw_generation(config: CrossEntropyConfig, state: CEState, cost_fn,
                    x0: Tensor, u_init: Tensor, kl_bound: float,
                    generator: torch.Generator, verbose: bool = False):
    """The sampling half of a CE generation (``…:252-312``): draw positive
    θ samples and evaluate them on the bank, redrawing while too few are
    feasible (:func:`judge_draw`).  Each draw brings its costs to the host
    once.

    Returns ``(state, thetas, costs, done)`` with host arrays of the last
    draw; ``done`` is False when the ``MAX_REDRAWS`` budget ran out."""
    state = state._replace(iter_current=state.iter_current + 1)
    for _ in range(MAX_REDRAWS):
        thetas = draw_thetas(config, state, generator)
        costs = cost_fn(x0, u_init, thetas, kl_bound).cpu().numpy()
        thetas = thetas.cpu().numpy()
        num_valid = int(np.sum(np.isfinite(costs)))
        if verbose:
            print(f"**CE iter {state.iter_current}: "
                  f"{num_valid}/{config.num_samples} valid")
        state, accepted = judge_draw(config, state, num_valid)
        if accepted:
            return state, thetas, costs, True
    return state, thetas, costs, False


def refit(config: CrossEntropyConfig, state: CEState, thetas: np.ndarray,
          costs: np.ndarray) -> CEState:
    """The refit half of a CE generation (``…:314-334``): θ-range
    bookkeeping, stable sort of the costs (lower index first among ties,
    Inf last), and the elite Gaussian with the biased σ."""
    state = _update_theta_range(state, thetas, costs)
    order = np.argsort(costs, kind="stable")
    elite = thetas[order[:config.num_elite]]
    mu_new = float(np.sum(elite) / config.num_elite)
    sigma_new = float(np.sqrt(np.sum((elite - mu_new) ** 2)
                              / config.num_elite))
    dtype = state.mu.dtype
    return state._replace(mu=_scalar(mu_new, dtype),
                          sigma=_scalar(sigma_new, dtype))


def step(config: CrossEntropyConfig, state: CEState, cost_fn, x0: Tensor,
         u_init: Tensor, kl_bound: float, generator: torch.Generator,
         verbose: bool = False) -> CEState:
    """One CE generation (``step!``, ``…:252-335``).  Raises
    ``RuntimeError`` when the feasibility redraws run out."""
    state, thetas, costs, done = draw_generation(
        config, state, cost_fn, x0, u_init, kl_bound, generator, verbose)
    if not done:
        raise RuntimeError(
            f"CE feasibility redraw budget exhausted ({MAX_REDRAWS} "
            f"redraws, {int(np.sum(np.isfinite(costs)))}/"
            f"{config.num_samples} feasible): every sampled θ leads to "
            "neurotic breakdown — the problem is likely infeasible at this "
            "kl_bound")
    return refit(config, state, thetas, costs)


def reset(state: CEState, dtype) -> CEState:
    """``initialize!`` (ref :133-138): (μ, σ) from the warm-started inits,
    an empty θ-range."""
    return state._replace(iter_current=0, mu=state.mu_init,
                          sigma=state.sigma_init,
                          theta_min=_scalar(np.inf, dtype),
                          theta_max=_scalar(0.0, dtype))


def solve_one(bank, x0: Tensor, u_init: Tensor, theta: float
              ) -> ILEQGResult:
    """One iLEQG solve at ``theta`` as a one-lane bank; no lane axis."""
    res = bank(x0, u_init, torch.tensor([theta], dtype=x0.dtype,
                                        device=x0.device))
    return ILEQGResult(*(f[0] for f in res))


def plan_value(res: ILEQGResult, kl_bound: float, theta_opt: float):
    """The final objective: ``value + kl_bound/θ_opt`` for ``kl_bound >
    0``, with ``kl_bound/0 = ∞`` as in Julia (ref :400-408)."""
    if kl_bound <= 0:
        return res.value
    return res.value + (kl_bound / theta_opt if theta_opt > 0.0
                        else float("inf"))


# Safety bound on the final-solve θ-backoff (ref :390-414 is unbounded).
_MAX_FINAL_RETRIES = 100


def solve(problem: RiskSensitiveProblem, config: CrossEntropyConfig,
          state: CEState, x0, u_init, generator: torch.Generator, *,
          kl_bound: float, verbose: bool = False) -> RATiLQRResult:
    """RAT iLQR ``solve!`` (``…:364-415``).

    ``kl_bound == 0`` is pure iLQG (θ_opt = 0, ref :386-389).  The final
    full iLEQG re-solve retries with ``θ_opt ← max(0, θ_opt − σ)`` on
    neurotic breakdown (ref :390-414), jumping to θ = 0 when σ = 0.
    Returns the updated :class:`CEState`, whose ``mu_init/sigma_init``
    seed the next MPC re-plan.
    """
    if kl_bound < 0:
        raise ValueError("KL divergence bound must be non-negative")
    verbose = verbose or config.verbose
    x0 = torch.as_tensor(x0, device=problem_device(problem))
    dtype = x0.dtype
    u_init = torch.as_tensor(u_init, dtype=dtype, device=x0.device)
    state = reset(state, dtype)
    cost_fn = make_cost_fn(problem, config)
    if kl_bound > 0:
        while state.iter_current < config.iter_max:
            state = step(config, state, cost_fn, x0, u_init, kl_bound,
                         generator, verbose)
        theta_opt = float(state.theta_max if config.use_theta_max
                          else state.mu)
    else:
        theta_opt = 0.0

    sigma = float(state.sigma)
    for _ in range(_MAX_FINAL_RETRIES):
        res = solve_one(cost_fn.bank, x0, u_init, theta_opt)
        if not bool(res.failed):
            if kl_bound > 0:
                tmin, tmax = state.theta_min, state.theta_max
            else:
                # The reference returns the literal (0.0, 0.0) θ-range
                # here (ref :408), not the reset fields.
                tmin, tmax = _scalar(0.0, dtype), _scalar(0.0, dtype)
            return RATiLQRResult(
                theta_opt=_scalar(theta_opt, dtype), x=res.x, l=res.l,
                L=res.L, value=plan_value(res, kl_bound, theta_opt),
                theta_min=tmin, theta_max=tmax, state=state)
        if verbose:
            print(f"θ_opt == {theta_opt} resulted in neurotic breakdown. "
                  f"Re-trying with θ_opt == {max(0.0, theta_opt - sigma)}")
        theta_opt = max(0.0, theta_opt - sigma)
        if sigma == 0.0 and theta_opt > 0.0:
            # A collapsed σ makes no progress: go to the terminal θ = 0.
            theta_opt = 0.0
    raise RuntimeError("RAT iLQR final solve failed even at θ = 0")


@dataclasses.dataclass
class RATiLQRSolver:
    """Holds the warm-start state across repeated ``solve`` calls (MPC
    re-planning).  ``solve(x0, u_init, generator, kl_bound=...)``."""
    problem: RiskSensitiveProblem
    config: CrossEntropyConfig = CrossEntropyConfig()
    state: Optional[CEState] = None

    def solve(self, x0, u_init, generator: torch.Generator, *,
              kl_bound: float, verbose: bool = False) -> RATiLQRResult:
        x0 = torch.as_tensor(x0)
        if self.state is None:
            self.state = init_state(self.config, x0.dtype)
        res = solve(self.problem, self.config, self.state, x0, u_init,
                    generator, kl_bound=kl_bound, verbose=verbose)
        self.state = res.state
        return res
