"""The RAT iLQR paper's core experiment in miniature, on the port's fleet
runner: closed-loop control under stochastic model mismatch.

Twin of ``examples/model_mismatch.py --fleet`` of the JAX package: the
same plan problem, barrier costs, GMM true world and controllers.  The
planners' internal model is the integrator with Gaussian noise ``N(0, 0.5
I)``; the true world follows the mixture ``0.5·N(0, 0.5 I) + 0.5·N(1, I)``
(``optimal_control_problems.jl:102-116``), a biased, heavier-tailed
disturbance the model-based planners never see.  All controllers optimize
the same objective (quadratic + soft barrier at x₁ > 1):

  - iLQG            risk-neutral, trusts the wrong Gaussian model
  - iLEQG (θ=0.01)  risk-sensitive with a hand-picked θ
  - RAT iLQR        tunes θ from the KL ambiguity budget
  - PETS            sampling-based CEM on the same wrong internal model

Each controller's seeds run as one fleet (``ratilqr_tpu_torch.
mpc_episode``): every re-plan of iLQG and iLEQG is one bank over the
seeds, every CE generation of RAT iLQR one bank of seeds × samples; PETS
plans each seed in turn.  The model-based controllers fall back to the
risk-neutral plan where their plan breaks down.  Prints the mean ± stderr
of the realized closed-loop cost over seeds, the fallbacks and the mean
θ_opt.

Usage: ``python -m ratilqr_tpu_torch.examples.model_mismatch [--seeds 8]
[--episode 15] [--kl-bound 1.0] [--cpu]`` (the card unless ``--cpu``).
"""
import argparse

import numpy as np
import torch

from ratilqr_tpu_torch.config import (CrossEntropyConfig, ILEQGConfig,
                                      PETSConfig)
from ratilqr_tpu_torch.models import gmm_integrator
from ratilqr_tpu_torch.mpc_episode import (make_fleet_runner,
                                           make_ileqg_plan, make_pets_plan,
                                           make_ratilqr_plan)
from ratilqr_tpu_torch.problems import GenerativeProblem, RiskSensitiveProblem
from ratilqr_tpu_torch.solvers import ratilqr
from ratilqr_tpu_torch.utils.tree import tree_map

N = 10   # planning horizon


def make_problems(device, dtype):
    """The planners' Gaussian model with the barrier cost, its generative
    twin for PETS, and the true world (``gmm_integrator``)."""
    world = gmm_integrator(N=N, dtype=dtype, device=device)

    def c(k, x, u):
        return 0.5 * (x @ x) + 0.5 * (u @ u) + torch.exp(4.0 * (x[0] - 1.0))

    def h(x):
        return 5.0 * (x @ x) + torch.exp(4.0 * (x[0] - 1.0))

    W = 0.5 * torch.eye(2, dtype=dtype, device=device)
    plan = RiskSensitiveProblem(f=lambda x, u: x + u, c=c, h=h,
                                W=lambda k: W, N=N)
    gen_plan = GenerativeProblem(f_stochastic=world.f_stochastic,
                                 draw_noise=world.draw_noise, c=c, h=h, N=N,
                                 device=device)
    return plan, gen_plan, world


def true_world(world: GenerativeProblem):
    """``simulate(k, x (S, n), u (S, m), generators)``: the GMM world, each
    seed's noise drawn from its generator, the draws copied to ``x``'s
    device once."""
    step = torch.func.vmap(
        lambda x, u, w: world.f_stochastic(x, u, w, True))

    def simulate(k, x, u, generators):
        draws = [world.draw_noise(g, torch.empty((1,) + x.shape[1:],
                                                 dtype=x.dtype,
                                                 device=g.device), True)
                 for g in generators]
        noise = tree_map(lambda *d: torch.cat(d).to(x.device), *draws)
        return step(x, u, noise)

    return simulate


def run_study(seeds: int, episode: int, kl_bound: float, device,
              dtype=torch.float32) -> dict:
    """Every controller's fleet of ``seeds`` episodes; returns
    ``{controller: (EpisodeResult, has a fallback)}``."""
    plan_prob, gen_plan, world = make_problems(device, dtype)
    ileqg_cfg = ILEQGConfig(iter_max=20)
    ce_cfg = CrossEntropyConfig(num_samples=10, ileqg=ileqg_cfg)
    pets_cfg = PETSConfig(num_control_samples=64, num_trajectory_samples=16,
                          num_elite=8, iter_max=5)
    risk_neutral = make_ileqg_plan(plan_prob, ileqg_cfg, 0.0)

    def fallback(x, u_warm):
        return risk_neutral((), x, u_warm, None)[1]

    sig0 = torch.eye(2, dtype=dtype, device=device).expand(N, 2, 2)
    fleets = {
        "iLQG": (risk_neutral, (), fallback),
        "iLEQG (θ=0.01)": (make_ileqg_plan(plan_prob, ileqg_cfg, 0.01), (),
                           fallback),
        "RAT iLQR": (make_ratilqr_plan(plan_prob, ce_cfg, kl_bound),
                     ratilqr.init_state(ce_cfg, dtype), fallback),
        "PETS": (make_pets_plan(gen_plan, pets_cfg, sig0), (), None),
    }
    x0 = torch.tensor([-2.0, -2.0], dtype=dtype, device=device)
    u0 = torch.zeros((N, 2), dtype=dtype, device=device)
    out = {}
    for name, (plan, state0, fb) in fleets.items():
        run = make_fleet_runner(plan, true_world(world), episode,
                                plan_prob.c, fallback=fb)
        generators = [torch.Generator().manual_seed(100 + s)
                      for s in range(seeds)]
        out[name] = (run(x0, u0, generators, state0), fb is not None)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--episode", type=int, default=15)
    ap.add_argument("--kl-bound", type=float, default=1.0)
    args = ap.parse_args()
    device = torch.device("cpu" if args.cpu else "cuda")
    print(f"{'controller':<16} {'mean cost':>10} {'stderr':>8} "
          f"{'θ-fallbacks':>12} {'mean θ_opt':>11}")
    for name, (ep, has_fb) in run_study(args.seeds, args.episode,
                                        args.kl_bound, device).items():
        costs = ep.total_cost.double().cpu().numpy()
        fb = f"{int(ep.fallbacks.sum())}" if has_fb else "—"
        th = (f"{float(ep.aux['theta_opt'].double().mean()):>11.4f}"
              if isinstance(ep.aux, dict) and "theta_opt" in ep.aux
              else f"{'—':>11}")
        print(f"{name:<16} {costs.mean():>10.2f} "
              f"{costs.std() / np.sqrt(len(costs)):>8.2f} {fb:>12} {th}")


if __name__ == "__main__":
    main()
