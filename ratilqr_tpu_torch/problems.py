"""Optimal-control problem definition for the PyTorch port.

Counterpart of :mod:`ratilqr_tpu.problems`.  Callbacks are plain torch
functions of UNBATCHED tensors (state ``x (n,)``, control ``u (m,)``, time
index ``k`` a 0-d integer tensor), so ``torch.func`` can differentiate and
batch them; the port's bank functions apply them over an explicit leading
bank axis with ``torch.func.vmap``.

A generative problem's stochastic step is a deterministic function of
drawn noise, ``f_stochastic(x, u, noise, use_true_model)``: a generator
cannot draw inside ``vmap`` (it fails, or draws the same noise for every
lane), so ``draw_noise`` draws a whole bank's noise for one step outside
it, and a caller can supply the draws instead.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


class OptimalControlProblem:
    """Abstract base of the optimal control problems — counterpart of
    :class:`ratilqr_tpu.problems.OptimalControlProblem` and the reference's
    ``abstract type OptimalControlProblem``
    (``optimal_control_problems.jl:12``)."""


@dataclasses.dataclass(frozen=True)
class RiskSensitiveProblem(OptimalControlProblem):
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


@dataclasses.dataclass(frozen=True)
class GenerativeProblem(OptimalControlProblem):
    """Finite-horizon generative stochastic optimal control problem
    (``optimal_control_problems.jl:126-131``), counterpart of
    :class:`ratilqr_tpu.problems.GenerativeProblem`.

    Attributes:
      f_stochastic: ``f_stochastic(x, u, noise, use_true_model) ->
        x_next`` on unbatched tensors, ``noise`` one lane's draw (a tensor
        or a tuple of tensors); ``use_true_model`` switches between the
        solver's internal (possibly wrong) model and the true simulator.
      draw_noise: ``draw_noise(generator, x, use_true_model) -> noise``:
        one step's noise for the bank ``x (B, n)``, every leaf with the
        leading lane axis ``B``, one independent draw a lane, drawn on the
        generator's device and placed on ``x``'s.
      c: stage cost ``c(k, x, u) -> scalar``.
      h: terminal cost ``h(x) -> scalar``.
      N: horizon length.
      device: where the problem's solvers run (the card unless the caller
        asks for ``"cpu"``).
    """

    f_stochastic: Callable
    draw_noise: Callable
    c: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
    h: Callable[[torch.Tensor], torch.Tensor]
    N: int
    device: object = "cuda"

    def __post_init__(self):
        if self.N <= 0:
            raise ValueError(f"horizon N must be positive, got {self.N}")


def problem_device(problem) -> torch.device:
    """The device of the problem's noise model ``problem.W(0)`` (a
    generative problem's ``device``): where its constants live, and where a
    solver on it runs unless the caller names another device."""
    if isinstance(problem, GenerativeProblem):
        return torch.device(problem.device)
    return torch.as_tensor(problem.W(0)).device
