"""Solver configuration for the PyTorch port.

Copies of :class:`ratilqr_tpu.config.ILEQGConfig` and
:class:`ratilqr_tpu.config.CrossEntropyConfig` (same fields, defaults and
validation) that import nothing of JAX, so configurations carry across the
two packages by field name (``convert.config_from_dict``,
``convert.ce_config_from_dict``).
"""
from __future__ import annotations

import dataclasses


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


@dataclasses.dataclass(frozen=True)
class ILEQGConfig:
    """iLQG/iLEQG solver parameters (``ileqg.jl:191-208``).

    Attributes:
      mu_min: minimum Hessian regularization μ (> 0).
      delta_0: minimum multiplicative modification factor Δ₀ (> 0) for μ.
      lam: line-search step shrink factor λ ∈ (0, 1).
      d_tol: convergence threshold on max ‖Δl_t‖₂ (> 0).
      iter_max: maximum iLEQG iterations.
      eps_init: initial line-search step ε ∈ (ε_min, 1].
      adaptive_eps_init: warm-start ε_init from the previous iteration
        (``ileqg.jl:582-591``).
      eps_min: minimum line-search step; reaching it accepts the candidate
        unconditionally (``ileqg.jl:558-575``).
      ls_max_trials: hard cap on line-search trials per iteration; lanes
        exhausting it are declared failed (cost = Inf).
      eps_history_cap: length of the saturating (ε, Δvalue) diagnostics
        buffer; ``0`` disables recording (``eps_count`` still counts).
      scan_unroll: accepted for configuration parity with the JAX package;
        the port's time loops are Python loops or in-kernel loops, so it
        changes nothing.
      ls_chunk: line-search candidates per batched round: the ladder ε,
        ελ, …, ελ^(c−1) of every running lane is evaluated as one bank and
        each lane commits its first acceptable rung, trial for trial equal
        to the sequential search (``1``, the default).  Cuts the line
        search's host syncs by up to ``ls_chunk`` per round.
      fold_candidate_eval: evaluate line-search candidates and the
        ``initialize!`` value through the closed-loop-folded stack
        (``ops/approx.approximate_folded``) and the folded evaluating pass,
        kernel D (``ops/riccati_cuda.riccati_bank_folded``) on CUDA banks.
        ``fused_candidate_eval`` takes precedence over it.
      fused_candidate_eval: evaluate line-search candidates and the
        ``initialize!`` value with the fused candidate kernel
        (``ops/candidate_cuda.py``) on CUDA banks; on the CPU the same
        per-example composition runs in plain PyTorch.
      fused_step_optimize: run rollout + quadratization + optimizing DP as
        the fused step kernel (``ops/step_cuda.py``) on CUDA banks; on the
        CPU the same composition runs in plain PyTorch.
      verbose: print per-iteration progress from the host loop.
    """
    mu_min: float = 1e-6
    delta_0: float = 2.0
    lam: float = 0.5
    d_tol: float = 1e-2
    iter_max: int = 100
    eps_init: float = 1.0
    adaptive_eps_init: bool = False
    eps_min: float = 1e-6
    ls_max_trials: int = 64
    eps_history_cap: int = 256
    scan_unroll: int = 1
    ls_chunk: int = 1
    fold_candidate_eval: bool = False
    fused_candidate_eval: bool = False
    fused_step_optimize: bool = False
    verbose: bool = False

    def __post_init__(self):
        _check(self.ls_chunk >= 1, "ls_chunk must be >= 1")
        _check(self.eps_history_cap >= 0, "eps_history_cap must be >= 0")
        _check(0 < self.lam < 1, "lam must be in (0, 1)")
        _check(self.d_tol > 0, "d_tol > 0 is necessary")
        _check(self.mu_min > 0, "mu_min > 0 is necessary")
        _check(self.delta_0 > 0, "delta_0 > 0 is necessary")
        _check(0 < self.eps_init <= 1, "eps_init must be in (0, 1]")
        _check(self.eps_init > self.eps_min, "eps_init > eps_min is necessary")
        _check(0 < self.eps_min < 1, "eps_min must be in (0, 1)")


@dataclasses.dataclass(frozen=True)
class CrossEntropyConfig:
    """RAT iLQR outer Cross-Entropy parameters
    (``cross_entropy_bilevel_optimization.jl:84-127``).

    ``mu_init``/``sigma_init`` live in the *state* (they adapt across MPC
    re-plans, ``cross_entropy_bilevel_optimization.jl:66-68``), not here;
    only their initial values are configured.  ``verbose`` prints the
    per-generation progress from the host loop.
    """
    num_samples: int = 10
    num_elite: int = 3
    iter_max: int = 5
    lam: float = 0.5
    use_theta_max: bool = False
    mu_init: float = 1.0
    sigma_init: float = 2.0
    verbose: bool = False
    ileqg: ILEQGConfig = ILEQGConfig()

    def __post_init__(self):
        _check(0 < self.lam < 1, "lam must be in (0, 1)")
        _check(self.num_elite <= self.num_samples,
               "num_elite must be <= num_samples")
