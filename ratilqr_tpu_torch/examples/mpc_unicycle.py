"""Closed-loop MPC demo on the port: drive a stochastic unicycle to a goal
with all four controllers (iLQG, iLEQG, RAT iLQR, RAT iLQR++) and compare.

Twin of ``examples/mpc_unicycle.py`` of the JAX package, the reference's
docs-level usage pattern (``docs/source/getting-started.md:96-115``) end to
end: per re-plan, solve from the current state with a shifted warm start,
apply the first step of the affine policy, repeat.  Each controller runs
through :class:`~ratilqr_tpu_torch.mpc.MPCDriver` with its own
``torch.Generator`` seeded 0 (the JAX demo's ``key(0)``), in float32.

Usage: ``python -m ratilqr_tpu_torch.examples.mpc_unicycle [--steps 20]
[--horizon 30] [--kl-bound 0.05] [--cpu]`` (the card unless ``--cpu``).
"""
import argparse
from typing import Optional, Sequence

import torch

from ratilqr_tpu_torch.config import (CrossEntropyConfig, ILEQGConfig,
                                      NelderMeadConfig)
from ratilqr_tpu_torch.models import unicycle
from ratilqr_tpu_torch.mpc import MPCDriver, plan_without_generator
from ratilqr_tpu_torch.solvers.ileqg import solve as ileqg_solve
from ratilqr_tpu_torch.solvers.nelder_mead import NelderMeadSolver
from ratilqr_tpu_torch.solvers.ratilqr import RATiLQRSolver

GOAL = (5.0, 5.0)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--horizon", type=int, default=30)
    ap.add_argument("--kl-bound", type=float, default=0.05)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")

    dtype = torch.float32
    T = args.horizon
    problem = unicycle(N=T, noise=2e-3, dtype=dtype, device=device)
    ileqg_cfg = ILEQGConfig(iter_max=30)
    x0 = torch.zeros(3, dtype=dtype, device=device)
    u0 = torch.zeros((T, 2), dtype=dtype, device=device)

    def ileqg_plan(theta):
        return lambda x, u_warm, generator: ileqg_solve(
            problem, ileqg_cfg, x, u_warm, theta)

    rat = RATiLQRSolver(problem, CrossEntropyConfig(
        num_samples=10, mu_init=0.005, sigma_init=0.01, ileqg=ileqg_cfg))
    nm = NelderMeadSolver(problem, NelderMeadConfig(
        iter_max=20, theta_high_init=0.02, theta_low_init=1e-8,
        ileqg=ileqg_cfg))
    controllers = {
        "iLQG (θ=0)": ileqg_plan(0.0),
        "iLEQG (θ=0.01)": ileqg_plan(0.01),
        "RAT iLQR": lambda x, u, g: rat.solve(x, u, g,
                                              kl_bound=args.kl_bound),
        "RAT iLQR++": plan_without_generator(nm.solve,
                                             kl_bound=args.kl_bound),
    }

    goal = torch.tensor(GOAL, dtype=torch.float64)
    print(f"{'controller':<16} {'final dist':>10} {'total cost':>11} "
          f"{'p50 plan ms':>12}")
    for name, plan in controllers.items():
        generator = torch.Generator(device=device).manual_seed(0)
        steps = MPCDriver(problem=problem, plan=plan).run(
            x0, u0, generator, num_steps=args.steps)
        final_dist = float(torch.linalg.norm(
            steps[-1].x[:2].double().cpu() - goal))
        # The problem's own stage cost (the heading term included): the
        # objective the controllers optimize.
        total_cost = float(sum(problem.c(torch.tensor(i), s.x, s.u)
                               for i, s in enumerate(steps)))
        lat = sorted(s.plan_time_s for s in steps[1:])
        p50 = 1e3 * lat[len(lat) // 2]
        print(f"{name:<16} {final_dist:>10.3f} {total_cost:>11.2f} "
              f"{p50:>12.1f}")


if __name__ == "__main__":
    main()
