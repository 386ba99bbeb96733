"""PETS — the Cross-Entropy Method directly over control sequences.

Counterpart of :mod:`ratilqr_tpu.solvers.pets`
(``CrossEntropyDirectOptimizationSolver``, ``pets.jl:35-281``).  One
generation is one bank of K·M stochastic rollouts (K control sequences ×
M trajectory samples, a Python loop over the horizon, each step's noise
drawn for the whole bank outside ``vmap``), then the elite refit.  The JAX
package has no Pallas kernel here (its rollout grid is XLA), and neither
has the port: every step is plain PyTorch on the problem's device.

Randomness comes from an explicit ``torch.Generator`` (on its own device;
draws are placed on the problem's), where the JAX code takes a PRNG key;
the standard-normal control draws can be supplied instead.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ratilqr_tpu_torch.config import PETSConfig
from ratilqr_tpu_torch.ops.rollout import rollout_generative
from ratilqr_tpu_torch.problems import GenerativeProblem, problem_device

Tensor = torch.Tensor


class PETSState(NamedTuple):
    """Per-timestep Gaussian control distribution (``pets.jl:44-49``):
    ``u_k ~ N(mu[k], sigma[k])``."""
    mu: Tensor          # (N, m)
    sigma: Tensor       # (N, m, m)
    iter_current: int


def init_state(mu_init, sigma_init) -> PETSState:
    """``initialize!`` (``pets.jl:70-74``)."""
    return PETSState(mu=torch.as_tensor(mu_init),
                     sigma=torch.as_tensor(sigma_init), iter_current=0)


def sample_control_sequences(state: PETSState, generator: torch.Generator,
                             num_samples: int,
                             z: Optional[Tensor] = None) -> Tensor:
    """``num_samples`` control sequences ``u_t ~ MvNormal(μ_t, Σ_t)``
    (``pets.jl:208-216``) as one reparameterized draw ``μ_t + chol(Σ_t)
    z_t``; ``z (num_samples, N, m)`` standard normal, given or drawn from
    ``generator``."""
    mu = state.mu
    N, m = mu.shape
    if z is None:
        z = torch.randn((num_samples, N, m), generator=generator,
                        dtype=mu.dtype, device=generator.device)
    z = torch.as_tensor(z, dtype=mu.dtype, device=mu.device)
    chol = torch.linalg.cholesky(state.sigma)               # (N, m, m)
    return mu[None] + torch.einsum("nij,knj->kni", chol, z)


def compute_cost(problem: GenerativeProblem, config: PETSConfig, x0: Tensor,
                 control_sequences: Tensor,
                 generator: Optional[torch.Generator] = None,
                 use_true_model: bool = False,
                 noise: Optional[Sequence] = None) -> Tensor:
    """Mean Monte-Carlo rollout cost of each of the K sequences over
    ``num_trajectory_samples`` stochastic rollouts (``compute_cost``,
    ``pets.jl:100-157``): one bank of K·M rollouts, sequence k's samples
    in lanes ``k·M … k·M + M − 1``.  ``noise``: per-step draws for that
    bank (see :func:`~ratilqr_tpu_torch.ops.rollout.rollout_generative`)."""
    K = control_sequences.shape[0]
    M = config.num_trajectory_samples
    us = control_sequences.repeat_interleave(M, 0)
    x0s = x0.expand(K * M, -1)
    _, cost = rollout_generative(problem, x0s, us, generator,
                                 use_true_model, noise)
    return cost.reshape(K, M).mean(1)


def get_elite_samples(control_sequences: Tensor, costs: Tensor,
                      num_elite: int) -> Tuple[Tensor, Tensor]:
    """The ``num_elite`` lowest-cost sequences (``pets.jl:159-171``), ties
    to the lower index (as the JAX module's ``lax.top_k``); returns
    ``(elites, indices)``."""
    idx = torch.sort(costs, stable=True).indices[:num_elite]
    return control_sequences[idx], idx


def compute_new_distribution(state: PETSState, elites: Tensor,
                             smoothing_factor: float) -> PETSState:
    """Refit the per-timestep Gaussian to the elites with exponential
    smoothing (``pets.jl:173-191``): a diagonal covariance of the unbiased
    elite variance (Julia ``var``), mean and covariance smoothed toward the
    previous distribution."""
    s = smoothing_factor
    mean_e = elites.mean(0)                                   # (N, m)
    cov_e = torch.diag_embed(elites.var(0, correction=1))     # (N, m, m)
    return state._replace(mu=(1.0 - s) * mean_e + s * state.mu,
                          sigma=(1.0 - s) * cov_e + s * state.sigma)


def step(problem: GenerativeProblem, config: PETSConfig, x0, state: PETSState,
         generator: torch.Generator, use_true_model: bool = False,
         z: Optional[Tensor] = None) -> PETSState:
    """One CEM generation (``step!``, ``pets.jl:193-245``); ``z``: the
    standard-normal control draws, ``(num_control_samples, N, m)``."""
    dev = problem_device(problem)
    state = state._replace(mu=state.mu.to(dev), sigma=state.sigma.to(dev))
    x0 = torch.as_tensor(x0, dtype=state.mu.dtype, device=dev)
    us = sample_control_sequences(state, generator,
                                  config.num_control_samples, z)
    costs = compute_cost(problem, config, x0, us, generator, use_true_model)
    elites, _ = get_elite_samples(us, costs, config.num_elite)
    state = compute_new_distribution(state, elites, config.smoothing_factor)
    return state._replace(iter_current=state.iter_current + 1)


def solve(problem: GenerativeProblem, config: PETSConfig, x0,
          state: PETSState, generator: torch.Generator,
          use_true_model: bool = False) -> PETSState:
    """PETS ``solve!`` (``pets.jl:270-281``): ``iter_max`` CEM generations
    on the problem's device, returning the final control distribution
    ``(μ, Σ)``, the open-loop policy."""
    for _ in range(config.iter_max):
        state = step(problem, config, x0, state, generator, use_true_model)
    return state


@dataclasses.dataclass
class PETSSolver:
    """Holds the initial distribution and re-solves from it each MPC
    re-plan (``pets.jl:52-74``)."""
    problem: GenerativeProblem
    mu_init: Tensor
    sigma_init: Tensor
    config: PETSConfig = PETSConfig()

    def solve(self, x0, generator: torch.Generator,
              use_true_model: bool = False) -> Tuple[Tensor, Tensor]:
        state = init_state(self.mu_init, self.sigma_init)
        out = solve(self.problem, self.config, x0, state, generator,
                    use_true_model)
        return out.mu, out.sigma
