"""Closed-loop MPC episodes and seed-batched fleets, counterpart of
:mod:`ratilqr_tpu.mpc_episode`.

An episode is the receding-horizon loop of :class:`~ratilqr_tpu_torch.mpc.
MPCDriver` (the reference's usage pattern, ``docs/source/
getting-started.md:96-115``): plan from the current state with the
shifted warm start, apply the first step of the affine policy ``π_k(x) =
L_k(x − x̄_k) + l_k`` (``ileqg.jl:632-633``), step the true world, shift.
The JAX package compiles it into one ``lax.scan`` and runs a fleet of
seeds by ``vmap``.  Here **seeds are lanes**: every step of a fleet of S
seeds is one call of a batched plan step over ``(S, ...)`` tensors (for
iLEQG one bank of S lanes, for RAT iLQR one bank of S × ``num_samples``
lanes a CE generation), then the batched policy, stage cost, simulator
and warm-start shift.  :func:`make_episode_runner` is the fleet at S = 1.

Randomness: JAX's key schedule (``key, k_plan, k_sim = split(key, 3)`` a
step) has no PyTorch counterpart.  The port's rule is ``MPCDriver``'s: one
``torch.Generator`` a seed, used by the plan step and then by the
simulator in turn, so an episode reproduces ``MPCDriver.run`` with that
generator, seed for seed.

Solver warm-start state (CE's ``μ_init/σ_init``, NM's θ inits) is the
explicit ``plan_state``, threaded through the steps; a fleet's holds every
seed's (for RAT iLQR a :class:`~ratilqr_tpu_torch.solvers.ratilqr.
CEState` of ``(S,)`` tensors, for RAT iLQR++ a list of S ``NMState``s).
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import torch

from ratilqr_tpu_torch.config import (CrossEntropyConfig, ILEQGConfig,
                                      NelderMeadConfig, PETSConfig)
from ratilqr_tpu_torch.mpc import affine_policy_control, shift_warm_start
from ratilqr_tpu_torch.problems import GenerativeProblem, RiskSensitiveProblem
from ratilqr_tpu_torch.solvers import nelder_mead_jit, pets, ratilqr_jit
from ratilqr_tpu_torch.solvers.ileqg import make_batched_solver
from ratilqr_tpu_torch.utils.tree import tree_map

Tensor = torch.Tensor
Generators = Sequence[torch.Generator]


class PlanOut(NamedTuple):
    """A plan step's output for S seeds: the affine policy ``(x̄, l, L)``
    and its objective value.  ``aux`` is a per-re-plan diagnostic (e.g. the
    bilevel solvers' ``{"theta_opt": (S,)}``), stacked into
    ``EpisodeResult.aux``; the fallback does not touch it."""
    x: Tensor       # (S, T+1, n) nominal trajectory the gains are about
    l: Tensor       # (S, T, m)   feedforward controls
    L: Tensor       # (S, T, m, n) feedback gains
    value: Tensor   # (S,)        planner objective; +Inf = infeasible
    aux: Any = ()


class EpisodeResult(NamedTuple):
    """Closed-loop episodes: a fleet's fields lead with the seed axis S, an
    episode's have none."""
    xs: Tensor          # (S, steps+1, n) realized states (incl. terminal)
    us: Tensor          # (S, steps, m)   controls actually applied
    values: Tensor      # (S, steps)      planner objective per re-plan
    fallbacks: Tensor   # (S, steps)      primary plan was infeasible
    total_cost: Tensor  # (S,)            Σ_k stage_cost(k, x_k, u_k)
    plan_state: Any     # final warm-start state (for episode chaining)
    aux: Any = ()       # per-re-plan PlanOut.aux, stacked on axis 1


# ----------------------------------------------------------------------
# Plan steps: (plan_state, x (S, n), u_warm (S, T, m), generators)
#             -> (plan_state, PlanOut)
# ----------------------------------------------------------------------

def make_ileqg_plan(problem: RiskSensitiveProblem, config: ILEQGConfig,
                    theta: float):
    """Fixed-θ iLQG/iLEQG plan step: all S seeds as one bank of S lanes
    (per-lane ``x0`` and warm start, θ repeated); ``plan_state = ()``."""
    bank = make_batched_solver(problem, config)

    def plan_step(state, x, u_warm, generators):
        thetas = torch.full((x.shape[0],), float(theta), dtype=x.dtype,
                            device=x.device)
        res = bank(x, u_warm, thetas)
        return state, PlanOut(x=res.x, l=res.l, L=res.L, value=res.value)

    return plan_step


def make_ratilqr_plan(problem: RiskSensitiveProblem,
                      config: CrossEntropyConfig, kl_bound: float):
    """RAT iLQR plan step over seeds (:func:`ratilqr_jit.solve_fleet
    <ratilqr_tpu_torch.solvers.ratilqr_jit.solve_fleet>`): one bank of S ×
    ``num_samples`` lanes a CE generation.  ``plan_state`` is a
    ``CEState``, a single one (repeated over the seeds) or a fleet's; the
    step returns the fleet's and ``aux = {"theta_opt": (S,)}``."""

    def plan_step(state, x, u_warm, generators):
        res = ratilqr_jit.solve_fleet(problem, config, state, x, u_warm,
                                      generators, kl_bound)
        return res.state, PlanOut(x=res.x, l=res.l, L=res.L,
                                  value=res.value,
                                  aux={"theta_opt": res.theta_opt})

    return plan_step


def make_nm_plan(problem: RiskSensitiveProblem, config: NelderMeadConfig,
                 kl_bound: float):
    """RAT iLQR++ plan step: :func:`nelder_mead_jit.solve
    <ratilqr_tpu_torch.solvers.nelder_mead_jit.solve>` for each seed in
    turn (its speculative banks are not yet merged across seeds).
    ``plan_state`` is an ``NMState`` (repeated over the seeds) or a list of
    S; start from ``nelder_mead_jit.bootstrap_state(problem, config, x0,
    u0, kl_bound=...)``, as the JAX adapter does.  NM draws nothing, so the
    generators are not used.  ``aux = {"theta_opt": (S,)}``."""

    def plan_step(state, x, u_warm, generators):
        S = x.shape[0]
        states = state if isinstance(state, list) else [state] * S
        outs = [nelder_mead_jit.solve(problem, config, st, x[s], u_warm[s],
                                      kl_bound=kl_bound)
                for s, st in enumerate(states)]
        return [r.state for r in outs], PlanOut(
            x=torch.stack([r.x for r in outs]),
            l=torch.stack([r.l for r in outs]),
            L=torch.stack([r.L for r in outs]),
            value=torch.stack([torch.as_tensor(r.value) for r in outs]),
            aux={"theta_opt": torch.stack([r.theta_opt for r in outs])})

    return plan_step


def make_pets_plan(problem: GenerativeProblem, config: PETSConfig,
                   sigma_init: Tensor, use_true_model: bool = False):
    """PETS plan step, each seed in turn (not yet one rollout batch over
    seeds); ``plan_state = ()``.  Each re-plan starts the CEM from the
    seed's shifted warm start and ``Σ = sigma_init`` (``pets.jl:70-74``)
    and runs ``iter_max`` generations on the seed's generator.  The policy
    is open loop: zero gains and ``x̄ = 0``.  ``value`` is the Monte-Carlo
    cost of the returned mean (:func:`pets.compute_cost
    <ratilqr_tpu_torch.solvers.pets.compute_cost>`) on the generator's next
    draws, where the JAX adapter folds the plan key."""

    def plan_step(state, x, u_warm, generators):
        mus, values = [], []
        for s, g in enumerate(generators):
            out = pets.solve(problem, config, x[s],
                             pets.init_state(u_warm[s], sigma_init), g,
                             use_true_model)
            mus.append(out.mu)
            values.append(pets.compute_cost(problem, config, x[s],
                                            out.mu[None], g,
                                            use_true_model)[0])
        l = torch.stack(mus)
        S, N, m = l.shape
        n = x.shape[1]
        return state, PlanOut(x=l.new_zeros((S, N + 1, n)), l=l,
                              L=l.new_zeros((S, N, m, n)),
                              value=torch.stack(values))

    return plan_step


# ----------------------------------------------------------------------
# Simulator and runners
# ----------------------------------------------------------------------

def make_gaussian_simulator(problem: RiskSensitiveProblem):
    """True-world step of S seeds ``x⁺ = f(x, u) + w, w ~ N(0, W(k))``:
    ``simulate(k, x (S, n), u (S, m), generators) -> (S, n)``.  Seed s
    draws its ``n`` standard normals from its own generator, as
    :func:`ratilqr_tpu_torch.mpc.make_gaussian_simulator` draws them; the
    draws are stacked on the generators' device and copied to ``x``'s
    once."""
    f = torch.func.vmap(problem.f)

    def simulate(k, x, u, generators: Generators):
        W = torch.as_tensor(problem.W(k), dtype=x.dtype, device=x.device)
        z = torch.stack([torch.randn(x.shape[1:], generator=g,
                                     dtype=x.dtype, device=g.device)
                         for g in generators]).to(x.device)
        chol = torch.linalg.cholesky(W)
        return f(x, u) + torch.einsum("ij,sj->si", chol, z)

    return simulate


def _seed(tree: Any, s: int) -> Any:
    """Seed ``s`` of a fleet's plan state or aux: the seed axis is the
    leading axis of a tensor and the index of a list."""
    if isinstance(tree, list):
        return tree[s]
    if isinstance(tree, torch.Tensor):
        return tree[s] if tree.dim() else tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_seed(x, s) for x in tree))
    if isinstance(tree, tuple):
        return tuple(_seed(x, s) for x in tree)
    if isinstance(tree, dict):
        return {k: _seed(v, s) for k, v in tree.items()}
    return tree


def make_fleet_runner(
        plan_step: Callable[[Any, Tensor, Tensor, Generators], tuple],
        simulate: Callable[[int, Tensor, Tensor, Generators], Tensor],
        num_steps: int,
        stage_cost: Callable[[Tensor, Tensor, Tensor], Tensor],
        fallback: Optional[Callable[[Tensor, Tensor], PlanOut]] = None):
    """Build a runner of S closed-loop episodes, one a seed, whose every
    step is one call of the batched ``plan_step``.

    Args:
      plan_step: ``(plan_state, x (S, n), u_warm (S, T, m), generators) ->
        (plan_state, PlanOut)``; use the ``make_*_plan`` adapters.
      simulate: true-world transition ``(k, x (S, n), u (S, m),
        generators) -> (S, n)`` (``k`` the closed-loop step index, an int),
        e.g. :func:`make_gaussian_simulator`.
      num_steps: episode length.
      stage_cost: realized running cost of one seed, ``(k, x, u) ->
        scalar`` with ``k`` a 0-d integer tensor, applied over the seeds by
        ``torch.func.vmap`` and summed into ``total_cost`` (no terminal
        cost).
      fallback: optional ``(x (S', n), u_warm (S', T, m)) -> PlanOut`` for
        the S' seeds whose primary plan value is not finite (the paper
        experiment's risk-neutral fallback), called only when there are
        any.  It takes no generator, so it cannot shift a seed's draws
        (JAX's fallback gets the plan key, which every fallback of the repo
        ignores: each is a deterministic θ = 0 solve).  The primary's
        ``plan_state`` and ``aux`` are kept either way.

    Returns ``run(x0, u_init, generators, plan_state=()) ->
    EpisodeResult``: ``x0 (n,)`` or ``(S, n)``, ``u_init (T, m)`` or ``(S,
    T, m)``, one ``torch.Generator`` a seed (S = ``len(generators)``).
    """
    policy = torch.func.vmap(affine_policy_control)
    shift = torch.func.vmap(shift_warm_start)
    cost = torch.func.vmap(stage_cost, in_dims=(None, 0, 0))

    def run(x0: Tensor, u_init: Tensor, generators: Generators,
            plan_state: Any = ()) -> EpisodeResult:
        S = len(generators)
        x = x0.expand(S, -1).contiguous()
        u_warm = u_init.expand(S, -1, -1).contiguous()
        state = plan_state
        xs: List[Tensor] = []
        us, values, bads, costs, auxes = [], [], [], [], []
        for k in range(num_steps):
            state, out = plan_step(state, x, u_warm, generators)
            bad = ~torch.isfinite(out.value)
            if fallback is not None:
                idx = bad.nonzero().squeeze(1)
                if idx.numel():
                    fb = fallback(x[idx], u_warm[idx])
                    out = out._replace(
                        x=out.x.index_put((idx,), fb.x),
                        l=out.l.index_put((idx,), fb.l),
                        L=out.L.index_put((idx,), fb.L),
                        value=out.value.index_put((idx,), fb.value))
            u = policy(x, out.x, out.l, out.L)
            xs.append(x)
            us.append(u)
            values.append(out.value)
            bads.append(bad)
            costs.append(cost(torch.tensor(k), x, u))
            auxes.append(out.aux)
            x = simulate(k, x, u, generators)
            u_warm = shift(out.l)
        aux = (tree_map(lambda *a: torch.stack(a, 1), *auxes) if auxes
               else ())
        return EpisodeResult(
            xs=torch.stack(xs + [x], 1), us=torch.stack(us, 1),
            values=torch.stack(values, 1), fallbacks=torch.stack(bads, 1),
            total_cost=torch.stack(costs, 1).sum(1), plan_state=state,
            aux=aux)

    return run


def make_episode_runner(plan_step, simulate, num_steps, stage_cost,
                        fallback=None):
    """One closed-loop episode: the fleet runner at S = 1 with the seed
    axis squeezed.  Returns ``run(x0 (n,), u_init (T, m), generator,
    plan_state=()) -> EpisodeResult``; ``plan_state`` is the single-seed
    state, and so is the result's.  With the same generator it reproduces
    :meth:`MPCDriver.run <ratilqr_tpu_torch.mpc.MPCDriver.run>`."""
    fleet = make_fleet_runner(plan_step, simulate, num_steps, stage_cost,
                              fallback)

    def run(x0: Tensor, u_init: Tensor, generator: torch.Generator,
            plan_state: Any = ()) -> EpisodeResult:
        return EpisodeResult(*(_seed(f, 0) for f in fleet(
            x0, u_init, [generator], plan_state)))

    return run
