"""RAT iLQR++ — Nelder-Mead bilevel optimization over the risk parameter θ.

Counterpart of :mod:`ratilqr_tpu.solvers.nelder_mead`
(``nelder_mead_bilevel_optimization.jl:71-352``).  Nelder-Mead over a 1-D
simplex ``(θ_low, θ_high)`` is sequential — each vertex evaluation depends
on the previous one — so the outer loop runs on the host, as the
reference's does, and each vertex evaluation is one iLEQG solve as a
one-lane bank on the problem's device (the card's kernels at B=1), whose
``(failed, value)`` comes to the host in one combined fetch.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import torch

from ratilqr_tpu_torch.config import NelderMeadConfig
from ratilqr_tpu_torch.problems import RiskSensitiveProblem, problem_device
from ratilqr_tpu_torch.solvers.ileqg import make_batched_solver
from ratilqr_tpu_torch.solvers.ratilqr import solve_one

Tensor = torch.Tensor

_MAX_BOOTSTRAP = 60  # feasibility-bootstrap halvings (~18 orders of θ)


def _missing_c(c) -> bool:
    """A vertex cost is "missing" if it is None (fresh state) or NaN (the
    single-call path's encoding after a ``kl_bound == 0`` solve on a fresh
    state, see ``nelder_mead_jit``)."""
    if c is None:
        return True
    return math.isnan(float(c))


class NMState(NamedTuple):
    """NM solver state (ref :92-99), threaded through ``solve`` calls.

    ``theta_high_init``/``theta_low_init`` adapt across solves (MPC warm
    start, ref :68-69).  ``c_high``/``c_low`` are ``None`` until the first
    solve's feasibility bootstrap and are then — as in the reference, which
    re-computes them only when missing (ref :283,294) — carried verbatim
    into later solves.  Python floats and an int on both paths.
    """
    theta_high_init: float
    theta_low_init: float
    theta_high: float
    theta_low: float
    c_high: Optional[float]
    c_low: Optional[float]
    iter_current: int


class NMResult(NamedTuple):
    """``solve!`` return values (ref :264-269) plus the updated state:
    ``theta_opt`` a 0-d CPU tensor in the working dtype, the plan and its
    value on the problem's device."""
    theta_opt: Tensor
    x: Tensor
    l: Tensor
    L: Tensor
    value: Tensor
    state: NMState


def host_state(state: NMState) -> NMState:
    """``state`` with Python floats (``None`` kept) and an int, whatever
    the fields held (0-d tensors or numpy scalars of either package)."""
    return NMState(*(None if v is None else float(v)
                     for v in state[:-1]), int(state.iter_current))


def init_state(config: NelderMeadConfig) -> NMState:
    return NMState(theta_high_init=config.theta_high_init,
                   theta_low_init=config.theta_low_init,
                   theta_high=config.theta_high_init,
                   theta_low=config.theta_low_init,
                   c_high=None, c_low=None, iter_current=0)


@functools.lru_cache(maxsize=32)
def vertex_bank(problem: RiskSensitiveProblem, config):
    """The θ-bank every RAT iLQR++ solve runs on (one per problem and
    inner configuration, so its noise model is built once across an MPC
    loop)."""
    return make_batched_solver(problem, config)


def _inputs(problem: RiskSensitiveProblem, x0, u_init):
    x0 = torch.as_tensor(x0, device=problem_device(problem))
    return x0, torch.as_tensor(u_init, dtype=x0.dtype, device=x0.device)


def _make_cost(problem: RiskSensitiveProblem, config: NelderMeadConfig,
               x0, u_init, kl_bound: float):
    """Single-θ outer objective ``ileqg_value(θ) + kl_bound/θ`` with
    failure → Inf masking (``compute_cost_worker``, ref :134-158): one
    one-lane bank solve and one combined host fetch of ``(failed,
    value)``."""
    bank = vertex_bank(problem, config.ileqg)
    x0, u_init = _inputs(problem, x0, u_init)

    def cost(theta: float) -> float:
        res = bank(x0, u_init, torch.tensor([theta], dtype=x0.dtype,
                                            device=x0.device))
        failed, value = torch.stack(
            [res.failed[0].to(res.value.dtype), res.value[0]]).tolist()
        v = value + kl_bound / theta
        if failed or math.isnan(v):
            return math.inf
        return v

    return cost


# Reference-exported name (compute_cost_worker, nm...jl:134).
make_cost = _make_cost


def step(config: NelderMeadConfig, state: NMState, cost,
         verbose: bool = False) -> NMState:
    """One Nelder-Mead iteration (``step!``, ref :174-252): sort, reflect,
    maybe expand; else contract; on a failed contraction shrink θ_high
    toward θ_low.  Every candidate θ is clamped below by
    ``theta_low_init`` (ref :196,205,233)."""
    state = state._replace(iter_current=state.iter_current + 1)
    th_hi, th_lo = state.theta_high, state.theta_low
    c_hi, c_lo = state.c_high, state.c_low
    if c_hi < c_lo:
        th_lo, th_hi = th_hi, th_lo
        c_lo, c_hi = c_hi, c_lo

    theta_m = th_lo
    # reflection
    theta_r = max(state.theta_low_init,
                  theta_m + config.alpha * (theta_m - th_hi))
    c_r = cost(theta_r)
    if verbose:
        print(f"**NM iter {state.iter_current}: reflect "
              f"(θ_r, c_r)=({theta_r:.4g}, {c_r:.4g})")

    if c_r < c_lo:
        # expansion
        theta_e = max(state.theta_low_init,
                      theta_m + config.beta * (theta_r - theta_m))
        c_e = cost(theta_e)
        if c_e < c_r:
            th_hi, c_hi = theta_e, c_e
        else:
            th_hi, c_hi = theta_r, c_r
    else:
        if c_r < c_hi:
            th_hi, c_hi = theta_r, c_r
        # contraction
        theta_c = max(state.theta_low_init,
                      theta_m + config.gamma * (th_hi - theta_m))
        c_c = cost(theta_c)
        if c_c > c_hi:
            # contraction failed: shrink θ_high halfway to θ_low (ref :238-243)
            th_hi = (th_hi + th_lo) / 2.0
            c_hi = cost(th_hi)
        else:
            th_hi, c_hi = theta_c, c_c

    return state._replace(theta_high=th_hi, theta_low=th_lo, c_high=c_hi,
                          c_low=c_lo)


def solve(problem: RiskSensitiveProblem, config: NelderMeadConfig,
          state: NMState, x0, u_init, *, kl_bound: float,
          verbose: bool = False) -> NMResult:
    """RAT iLQR++ ``solve!`` (ref :276-352).

    The feasibility bootstrap halves the θ inits until the objective is
    finite (ref :283-304), bounded at ``_MAX_BOOTSTRAP`` evaluations a
    vertex; iteration stops when the stdev of the two vertex costs drops
    below ε (ref :306-317).  ``θ_opt = θ_low``; the final iLEQG re-solve
    has *no* retry loop, as in the reference.  ``kl_bound == 0`` is pure
    iLQG at θ_opt = 0.
    """
    if kl_bound < 0:
        raise ValueError("KL divergence bound must be non-negative")
    verbose = verbose or config.verbose
    x0, u_init = _inputs(problem, x0, u_init)
    # initialize! (ref :164-168): reset θ from the inits; c values persist.
    state = host_state(state)
    state = state._replace(iter_current=0,
                           theta_low=state.theta_low_init,
                           theta_high=state.theta_high_init)
    cost = _make_cost(problem, config, x0, u_init, kl_bound)

    if kl_bound > 0:
        if config.refresh_carried_costs:
            # Drop the carried vertex costs so the bootstrap re-evaluates
            # both vertices (already reset to the carried inits) at the
            # incoming (x0, u_init); its first rung is the carried θ.
            state = state._replace(c_high=None, c_low=None)
        # Feasibility bootstrap (ref :283-304), bounded: on a problem that
        # fails at every θ the value of the final solve is Inf.
        if _missing_c(state.c_high):
            for i in range(_MAX_BOOTSTRAP):
                c = cost(state.theta_high)
                # On budget exhaustion θ stays at the last evaluated rung.
                if math.isfinite(c) or i == _MAX_BOOTSTRAP - 1:
                    break
                state = state._replace(
                    theta_high=state.theta_high * config.lam,
                    theta_high_init=state.theta_high_init * config.lam)
            state = state._replace(c_high=c)
        if _missing_c(state.c_low):
            for i in range(_MAX_BOOTSTRAP):
                c = cost(state.theta_low)
                if math.isfinite(c) or i == _MAX_BOOTSTRAP - 1:
                    break
                state = state._replace(
                    theta_low=state.theta_low * config.lam,
                    theta_low_init=state.theta_low_init * config.lam)
            state = state._replace(c_low=c)

        while True:
            state = step(config, state, cost, verbose)
            c_mean = (state.c_low + state.c_high) / 2.0
            stdev = math.sqrt(0.5 * ((state.c_high - c_mean) ** 2
                                     + (state.c_low - c_mean) ** 2))
            if stdev < config.eps:
                if verbose:
                    print(f"Nelder-Mead converged. stdev == {stdev:.4g}")
                break
            if state.iter_current >= config.iter_max:
                if verbose:
                    print(f"Maximum iterations. stdev == {stdev:.4g}")
                break
        theta_opt = state.theta_low
    else:
        theta_opt = 0.0

    # Final re-solve, one lane; no retry loop (reference parity, :334-346).
    res = solve_one(vertex_bank(problem, config.ileqg), x0, u_init,
                    theta_opt)
    value = res.value + (kl_bound / theta_opt if kl_bound > 0 else 0.0)
    return NMResult(theta_opt=torch.tensor(theta_opt, dtype=x0.dtype),
                    x=res.x, l=res.l, L=res.L, value=value, state=state)


@dataclasses.dataclass
class NelderMeadSolver:
    """Holds the warm-start state across repeated ``solve`` calls (MPC
    re-planning).  ``solve(x0, u_init, kl_bound=...)``; in
    :class:`~ratilqr_tpu_torch.mpc.MPCDriver` plan with
    ``mpc.plan_without_generator(solver.solve, kl_bound=d)``."""
    problem: RiskSensitiveProblem
    config: NelderMeadConfig = NelderMeadConfig()
    state: Optional[NMState] = None

    def solve(self, x0, u_init, *, kl_bound: float,
              verbose: bool = False) -> NMResult:
        if self.state is None:
            self.state = init_state(self.config)
        res = solve(self.problem, self.config, self.state, x0, u_init,
                    kl_bound=kl_bound, verbose=verbose)
        self.state = res.state
        return res
