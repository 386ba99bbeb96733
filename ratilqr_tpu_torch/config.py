"""Solver configuration for the PyTorch port.

Copies of :class:`ratilqr_tpu.config.ILEQGConfig`,
:class:`ratilqr_tpu.config.CrossEntropyConfig`,
:class:`ratilqr_tpu.config.NelderMeadConfig` and
:class:`ratilqr_tpu.config.PETSConfig` (same fields, defaults and
validation) that import nothing of JAX, so configurations carry across the
two packages by field name (``convert.config_from_dict``,
``convert.ce_config_from_dict``, ``convert.nm_config_from_dict``,
``convert.pets_config_from_dict``).
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


@dataclasses.dataclass(frozen=True)
class NelderMeadConfig:
    """RAT iLQR++ outer Nelder-Mead parameters
    (``nelder_mead_bilevel_optimization.jl:85-128``).

    ``verbose`` prints the per-iteration simplex traces (the reference's
    verbose-gated prints, ``nelder_mead_bilevel_optimization.jl:181-249``)
    on both paths.

    ``refresh_carried_costs`` opts out of the reference's cross-solve
    c-persistence quirk: ``solve!`` re-computes the simplex vertex costs
    only when they are missing (``nelder_mead_bilevel_optimization.jl:283,
    294``), so on every warm MPC re-plan a stale ``c_low`` from the
    previous state sits on the simplex; fresh costs at the new state never
    close the gap to it, the vertex-cost-stdev convergence test (ref
    :306-317) never fires, and the solver runs all ``iter_max`` iterations
    per re-plan.  With ``True`` the carried vertex costs are discarded and
    re-evaluated at the incoming ``(x0, u_init)`` through the feasibility
    bootstrap, and warm re-plans converge in a few iterations.  Default
    ``False`` for decision-for-decision reference parity.

    ``speculation_depth`` (single-call path only) evaluates that many NM
    iterations' candidate trees as ONE iLEQG bank per round.  An NM step
    can only ever query 6 θs computable up front from the sorted simplex;
    chaining the hypotheses over the 6 possible new vertices × 2 sort
    orders gives 6 / 78 / 942 lanes at depth 1 / 2 / 3.  On the card a
    942-lane bank of a small model is one partly filled launch of each
    kernel, so depth 3 buys three sequentially dependent rounds for about
    the time of one.  The decision replay is exact, so results are equal
    at any depth.  On the CPU the speculative lanes are real work: keep 1.
    """
    alpha: float = 1.0    # reflection
    beta: float = 2.0     # expansion
    gamma: float = 0.5    # contraction
    eps: float = 1e-2     # convergence on vertex-cost stdev
    lam: float = 0.5      # feasibility-bootstrap shrink factor
    iter_max: int = 100
    theta_high_init: float = 3.0
    theta_low_init: float = 1e-8
    refresh_carried_costs: bool = False
    speculation_depth: int = 1
    verbose: bool = False
    ileqg: ILEQGConfig = ILEQGConfig()

    def __post_init__(self):
        _check(1 <= self.speculation_depth <= 3,
               "speculation_depth must be in {1, 2, 3} (6, 78 or 942 "
               "lanes a speculation bank)")


@dataclasses.dataclass(frozen=True)
class PETSConfig:
    """PETS (CEM over control sequences) parameters (``pets.jl:35-68``).

    ``scan_unroll`` is accepted for configuration parity with the JAX
    package; the port's rollout is a Python loop over the horizon, so it
    changes nothing (as ``ILEQGConfig.scan_unroll``).
    """
    num_control_samples: int = 10
    num_trajectory_samples: int = 10
    num_elite: int = 3
    iter_max: int = 5
    smoothing_factor: float = 0.1
    scan_unroll: int = 1

    def __post_init__(self):
        _check(0.0 <= self.smoothing_factor <= 1.0,
               "smoothing_factor must be in [0, 1]")
        _check(self.num_elite <= self.num_control_samples,
               "num_elite must be <= num_control_samples")
