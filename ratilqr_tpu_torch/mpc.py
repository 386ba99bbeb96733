"""MPC driver: closed-loop re-planning with cross-call warm starts.

Counterpart of :mod:`ratilqr_tpu.mpc` (the reference's usage pattern,
``docs/source/getting-started.md:96-115``): per re-plan, solve from the
current state with a shifted warm start, apply the first step of the affine
policy ``π_k(x) = L_k(x − x̄_k) + l_k`` (``ileqg.jl:632-633``), step the
true world, repeat.  Randomness comes from one ``torch.Generator`` passed to
the planner and the simulator in turn.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, NamedTuple, Optional

import torch

from ratilqr_tpu_torch.problems import RiskSensitiveProblem

Tensor = torch.Tensor


class MPCStep(NamedTuple):
    """Record of one closed-loop MPC step."""
    x: Tensor           # state at which the plan was made
    u: Tensor           # control actually applied (first policy step)
    value: Tensor       # solver objective value
    plan_time_s: float  # wall-clock re-plan latency, device work included
    info: Any           # solver-specific extras (θ_opt, ...)


def shift_warm_start(l_traj: Tensor) -> Tensor:
    """Shift the accepted control schedule one step and hold the last
    control — the standard MPC warm start for the next re-plan."""
    return torch.cat([l_traj[1:], l_traj[-1:]], 0)


def affine_policy_control(x: Tensor, x_ref: Tensor, l: Tensor,
                          L: Tensor) -> Tensor:
    """First-step control of the affine policy ``π_0(x) = L_0(x − x̄_0) +
    l_0`` (``ileqg.jl:632-633``)."""
    return l[0] + L[0] @ (x - x_ref[0])


def make_gaussian_simulator(problem: RiskSensitiveProblem):
    """True-world step ``x⁺ = f(x, u) + w, w ~ N(0, W(k))``, the noise drawn
    from the generator passed in (on its device) — the default simulator of
    :class:`MPCDriver`."""

    def simulate(k, x, u, generator: torch.Generator):
        W = torch.as_tensor(problem.W(k), dtype=x.dtype, device=x.device)
        z = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                        device=generator.device).to(x.device)
        return problem.f(x, u) + torch.linalg.cholesky(W) @ z

    return simulate


def plan_without_generator(solve: Callable, **kwargs) -> Callable:
    """Adapt a planner that draws nothing, e.g.
    ``NelderMeadSolver.solve`` with ``kl_bound=...`` in ``kwargs``, to
    :class:`MPCDriver`'s ``plan(x, u_warm, generator)``: the generator is
    ignored."""
    return lambda x, u_warm, generator: solve(x, u_warm, **kwargs)


def _sync(x: Tensor) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


@dataclasses.dataclass
class MPCDriver:
    """Closed-loop MPC executor.

    Args:
      problem: the planning problem (the solver's model).
      plan: ``plan(x, u_warm, generator) -> result`` where ``result`` has
        ``.x``, ``.l``, ``.L`` and ``.value``; ``RATiLQRSolver.solve``
        (with ``kl_bound`` bound) satisfies it, and
        :func:`plan_without_generator` adapts ``NelderMeadSolver.solve``.
        Warm-start solver state lives inside the planner.
      simulate: true-world transition ``simulate(k, x, u, generator) ->
        x_next`` (``k`` the closed-loop step index); by default the planning
        model plus noise ``w ~ N(0, W(k))``.
    """
    problem: RiskSensitiveProblem
    plan: Callable[[Tensor, Tensor, torch.Generator], Any]
    simulate: Optional[Callable] = None

    def run(self, x0: Tensor, u_init: Tensor, generator: torch.Generator,
            num_steps: int) -> List[MPCStep]:
        """Run ``num_steps`` closed-loop steps; returns the step records.
        ``plan_time_s`` runs from a synchronized device to the plan's
        return with the device synchronized again, so it covers the device
        work of the whole plan."""
        sim = self.simulate or make_gaussian_simulator(self.problem)
        x, u_warm = x0, u_init
        steps: List[MPCStep] = []
        for k in range(num_steps):
            _sync(x)
            t0 = time.perf_counter()
            res = self.plan(x, u_warm, generator)
            _sync(x)
            dt = time.perf_counter() - t0
            u = affine_policy_control(x, res.x, res.l, res.L)
            steps.append(MPCStep(x=x, u=u, value=res.value, plan_time_s=dt,
                                 info=getattr(res, "theta_opt", None)))
            x = sim(k, x, u, generator)
            u_warm = shift_warm_start(res.l)
        return steps
