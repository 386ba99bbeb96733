"""RAT iLQR with the single-call semantics of :mod:`ratilqr_tpu.solvers.
ratilqr_jit` (``cross_entropy_bilevel_optimization.jl:364-415``), for one
seed or a fleet of seeds.

The JAX module compiles the whole ``solve!`` into one device program, so a
re-plan is one dispatch, and runs a fleet by ``vmap`` of it over PRNG keys
(``mpc_episode.make_fleet_runner``).  PyTorch has no such program: here the
CE generations, the redraw loop and the θ-backoff are host loops over the
same bank as :mod:`ratilqr_tpu_torch.solvers.ratilqr`, and the seeds of a
fleet are lanes (:func:`solve_fleet`):

  - each CE generation draws ``num_samples`` θ for every seed from that
    seed's own generator and evaluates all of them as ONE bank of S ×
    ``num_samples`` lanes, seed s in lanes ``s·K … s·K + K − 1``;
  - only the seeds whose draw was rejected redraw, as one bank of their
    lanes;
  - the final solve is one bank of S lanes at each seed's θ_opt, and each
    θ-backoff round one bank of the seeds that failed.

Every per-seed decision is ``ratilqr``'s own (:func:`~ratilqr_tpu_torch.
solvers.ratilqr.judge_draw`, ``refit``, ``reset``) on that seed's state,
so for any generators the result equals S separate one-seed solves with
them, the order of each seed's draws included.  :func:`solve` is the fleet
of one seed.  What this module keeps are the JAX module's results, where
they differ from the host path's:

  - the feasibility redraws stop after ``MAX_REDRAWS`` and set
    ``redraws_exhausted`` instead of raising; the generation then refits on
    the last, partly-Inf sample set;
  - the final re-solve retries at most ``MAX_FINAL_RETRIES`` times, the
    last retry forced to θ = 0, and reports ``final_failed`` instead of
    raising;
  - ``kl_bound == 0`` leaves the state's ``iter_current`` at 0, else it is
    ``iter_max``.

Elite ties are broken lower index first, the same elite set as the JAX
module's ``lax.top_k`` and the host path's stable sort.  The device
synchronizes with the host once per draw for the costs, plus the bank's
own per-round syncs.

A fleet's :class:`CEState` holds an ``(S,)`` tensor in every field
(``iter_current`` int64), on the CPU as the single state's scalars are;
:func:`stack_states` and :func:`unstack_state` convert.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ratilqr_tpu_torch.config import CrossEntropyConfig
from ratilqr_tpu_torch.problems import RiskSensitiveProblem, problem_device
from ratilqr_tpu_torch.solvers.ratilqr import (MAX_REDRAWS, CEState,
                                               RATiLQRResult, draw_thetas,
                                               judge_draw, make_cost_fn,
                                               refit, reset)

MAX_FINAL_RETRIES = 25   # the last retry forces θ = 0


def stack_states(states: Sequence[CEState]) -> CEState:
    """One fleet state from S single states (0-d fields, an int
    ``iter_current``)."""
    return CEState(*(torch.stack([torch.as_tensor(getattr(s, f))
                                  for s in states])
                     for f in CEState._fields))


def unstack_state(state: CEState) -> List[CEState]:
    """The S single states of a fleet state: 0-d CPU fields in the fleet's
    dtype and an int ``iter_current``."""
    return [CEState(*(f[s].cpu() for f in state[:-1]),
                    iter_current=int(state.iter_current[s]))
            for s in range(state.mu.shape[0])]


def broadcast_state(state: CEState, S: int) -> CEState:
    """A fleet state of S seeds: a single state (0-d fields) is repeated,
    a fleet state of S seeds passes unchanged."""
    if torch.as_tensor(state.mu).dim() == 0:
        return stack_states([state] * S)
    if state.mu.shape[0] != S:
        raise ValueError(f"a fleet state of {state.mu.shape[0]} seeds for "
                         f"{S} seeds")
    return state


def solve_fleet(problem: RiskSensitiveProblem, config: CrossEntropyConfig,
                state: CEState, x0, u_init,
                generators: Sequence[torch.Generator],
                kl_bound: float) -> RATiLQRResult:
    """RAT iLQR ``solve!`` for S seeds at once: ``x0 (S, n)``, ``u_init
    (S, T, m)`` (or one of each, repeated), one generator a seed, ``state``
    a fleet state (or a single state, repeated).  Returns a
    :class:`RATiLQRResult` with a leading seed axis on every field;
    ``redraws_exhausted`` and ``final_failed`` are ``(S,)`` bool
    tensors."""
    kl_bound = float(kl_bound)
    dev = problem_device(problem)
    x0 = torch.as_tensor(x0, device=dev)
    dtype = x0.dtype
    u_init = torch.as_tensor(u_init, dtype=dtype, device=dev)
    S, K = len(generators), config.num_samples
    x0 = x0.expand(S, -1).contiguous()
    u_init = u_init.expand(S, -1, -1).contiguous()
    states = [reset(s, dtype)
              for s in unstack_state(broadcast_state(state, S))]
    cost_fn = make_cost_fn(problem, config)
    exhausted = [False] * S
    ce = kl_bound > 0
    if ce:
        for _ in range(config.iter_max):
            states = [s._replace(iter_current=s.iter_current + 1)
                      for s in states]
            drawn = [None] * S
            pending = list(range(S))
            for _ in range(MAX_REDRAWS):
                if not pending:
                    break
                thetas = torch.cat([draw_thetas(config, states[s],
                                                generators[s])
                                    for s in pending])
                lanes = torch.tensor(pending, device=dev).repeat_interleave(K)
                costs = cost_fn(x0[lanes], u_init[lanes], thetas,
                                kl_bound).cpu().numpy().reshape(-1, K)
                thetas = thetas.cpu().numpy().reshape(-1, K)
                rejected = []
                for j, s in enumerate(pending):
                    drawn[s] = (thetas[j], costs[j])
                    num_valid = int(np.sum(np.isfinite(costs[j])))
                    if config.verbose:
                        print(("" if S == 1 else f"seed {s}: ")
                              + f"**CE iter {states[s].iter_current}: "
                              f"{num_valid}/{K} valid")
                    states[s], accepted = judge_draw(config, states[s],
                                                     num_valid)
                    if not accepted:
                        rejected.append(s)
                pending = rejected
            for s in pending:
                exhausted[s] = True
            states = [refit(config, states[s], *drawn[s]) for s in range(S)]
        theta_opt = [float(s.theta_max if config.use_theta_max else s.mu)
                     for s in states]
    else:
        theta_opt = [0.0] * S

    # The final solve, then θ-backoff rounds over the seeds that failed.
    sigma = [float(s.sigma) for s in states]
    bank = cost_fn.bank
    res = bank(x0, u_init, torch.tensor(theta_opt, dtype=dtype, device=dev))
    res = type(res)(*(f.clone() for f in res))
    pending = res.failed.cpu().nonzero().squeeze(1).tolist()
    k = 0
    while pending and k < MAX_FINAL_RETRIES:
        for s in pending:
            theta_opt[s] = max(0.0, theta_opt[s] - sigma[s])
            if k + 1 >= MAX_FINAL_RETRIES:
                theta_opt[s] = 0.0
        idx = torch.tensor(pending, device=dev)
        retry = bank(x0[idx], u_init[idx],
                     torch.tensor([theta_opt[s] for s in pending],
                                  dtype=dtype, device=dev))
        for f, g in zip(res, retry):
            f[idx] = g
        pending = [s for s, failed in zip(pending, retry.failed.tolist())
                   if failed]
        k += 1

    value = res.value
    if ce:   # the outer objective, kl_bound/0 = ∞ as in Julia (ref :400-408)
        value = value + torch.tensor(
            [kl_bound / th if th > 0.0 else float("inf") for th in theta_opt],
            dtype=dtype, device=dev)
    fleet = stack_states(states)
    zeros = torch.zeros(S, dtype=dtype)
    return RATiLQRResult(
        theta_opt=torch.tensor(theta_opt, dtype=dtype), x=res.x, l=res.l,
        L=res.L, value=value,
        theta_min=fleet.theta_min if ce else zeros,
        theta_max=fleet.theta_max if ce else zeros,
        state=fleet._replace(iter_current=torch.full(
            (S,), config.iter_max if ce else 0, dtype=torch.int64)),
        redraws_exhausted=torch.tensor(exhausted),
        final_failed=res.failed.cpu())


def solve(problem: RiskSensitiveProblem, config: CrossEntropyConfig,
          state: CEState, x0, u_init, generator: torch.Generator,
          kl_bound: float) -> RATiLQRResult:
    """RAT iLQR ``solve!`` that never raises on an exhausted budget: the
    fleet of one seed.  Returns the same :class:`RATiLQRResult` as the host
    path (0-d ``theta_opt`` and ``value``, no lane axis on the plan, a
    single state), with its flags set as Python bools."""
    res = solve_fleet(problem, config, state, x0, u_init, [generator],
                      kl_bound)
    return RATiLQRResult(
        *(f[0] for f in res[:7]), state=unstack_state(res.state)[0],
        redraws_exhausted=bool(res.redraws_exhausted[0]),
        final_failed=bool(res.final_failed[0]))
