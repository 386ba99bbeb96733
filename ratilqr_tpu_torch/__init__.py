"""ratilqr_tpu_torch — the PyTorch/CUDA port of ratilqr_tpu.

The warm-started iLEQG solver bank, RAT iLQR (the cross-entropy bilevel
solver) and RAT iLQR++ (the Nelder-Mead bilevel solver) over it, PETS (the
cross-entropy method over control sequences), the MPC driver, closed-loop
episodes and seed-batched MPC fleets (``mpc_episode``: seeds as bank
lanes, one ``torch.Generator`` a seed), the bank server
(``utils.serving``), solver-state checkpoints in the JAX package's format
(``utils.checkpoint``) and the timing helpers (``utils.profiling``) run
here in PyTorch, with the TPU kernels of their paths rewritten by hand in
CUDA C++ for Hopper (``csrc/``, built with ``nvcc`` at first use on a
CUDA device).  On the CPU every kernel runs its plain PyTorch version.
This package never imports JAX.
"""

from ratilqr_tpu_torch.config import (CrossEntropyConfig, ILEQGConfig,
                                      NelderMeadConfig, PETSConfig)
from ratilqr_tpu_torch.mpc import MPCDriver, plan_without_generator
from ratilqr_tpu_torch.mpc_episode import (EpisodeResult, PlanOut,
                                           make_episode_runner,
                                           make_fleet_runner,
                                           make_gaussian_simulator,
                                           make_ileqg_plan, make_nm_plan,
                                           make_pets_plan, make_ratilqr_plan)
from ratilqr_tpu_torch.ops import (Approximation, DPResult, approximate_model,
                                   decrease_mu_delta, dp_evaluate, dp_optimize,
                                   increase_mu_delta, integrate_cost,
                                   rollout_feedback, rollout_feedback_noisy,
                                   rollout_generative, rollout_open_loop,
                                   rollout_open_loop_noisy)
from ratilqr_tpu_torch.problems import (GenerativeProblem,
                                        OptimalControlProblem,
                                        RiskSensitiveProblem, problem_device)
from ratilqr_tpu_torch.solvers.ileqg import (ILEQGResult, make_batched_solver,
                                             solve, solve_bank, solve_value,
                                             solve_via_bank)
from ratilqr_tpu_torch.solvers.ileqg import solve as ileqg_solve
from ratilqr_tpu_torch.solvers.nelder_mead import NelderMeadSolver
from ratilqr_tpu_torch.solvers.pets import PETSSolver
from ratilqr_tpu_torch.solvers.ratilqr import RATiLQRSolver
from ratilqr_tpu_torch.utils.checkpoint import load_state, save_state
from ratilqr_tpu_torch.utils.serving import ILEQGBankServer, pipelined_map

__version__ = "0.1.0"
