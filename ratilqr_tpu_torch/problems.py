"""Optimal-control problem definition for the PyTorch port.

Counterpart of :mod:`ratilqr_tpu.problems`.  Callbacks are plain torch
functions of UNBATCHED tensors (state ``x (n,)``, control ``u (m,)``, time
index ``k`` a 0-d integer tensor), so ``torch.func`` can differentiate and
batch them; the port's bank functions apply them over an explicit leading
bank axis with ``torch.func.vmap``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class RiskSensitiveProblem:
    """Finite-horizon risk-sensitive optimal control problem
    (``optimal_control_problems.jl:67-73``).

    Attributes:
      f: dynamics ``f(x, u) -> x_next``.
      c: stage cost ``c(k, x, u) -> scalar``.
      h: terminal cost ``h(x) -> scalar``.
      W: noise covariance ``W(k) -> (n, n)`` symmetric positive definite.
      N: horizon length.
      f_jac: optional ``f_jac(x, u) -> (x_next, A, B)`` with analytic
        Jacobians; when absent, Jacobians come from ``torch.func.jacfwd``.
      tile_model: optional :class:`~ratilqr_tpu_torch.ops.tile_model.
        TileModel` — closed-form model pieces plus the device model the
        fused CUDA kernels run; must agree with ``f``/``c``/``h``.
    """

    f: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    c: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
    h: Callable[[torch.Tensor], torch.Tensor]
    W: Callable[[int], torch.Tensor]
    N: int
    f_jac: Optional[Callable] = None
    tile_model: Optional[object] = None

    def __post_init__(self):
        if self.N <= 0:
            raise ValueError(f"horizon N must be positive, got {self.N}")

    @property
    def has_jacobian(self) -> bool:
        return self.f_jac is not None


def problem_device(problem: RiskSensitiveProblem) -> torch.device:
    """The device of the problem's noise model ``problem.W(0)``: where its
    constants live, and where a solver on it runs unless the caller names
    another device."""
    return torch.as_tensor(problem.W(0)).device
