"""ratilqr_tpu_torch — the PyTorch/CUDA port of ratilqr_tpu.

The warm-started iLEQG solver bank runs here in PyTorch, with its three
TPU kernels rewritten by hand in CUDA C++ for Hopper (``csrc/``, built with
``nvcc`` at first use on a CUDA device).  On the CPU every kernel runs its
plain PyTorch version.  This package never imports JAX.
"""

from ratilqr_tpu_torch.config import ILEQGConfig
from ratilqr_tpu_torch.problems import RiskSensitiveProblem
from ratilqr_tpu_torch.solvers.ileqg import (ILEQGResult, make_batched_solver,
                                             solve, solve_bank,
                                             solve_via_bank)

__version__ = "0.1.0"
