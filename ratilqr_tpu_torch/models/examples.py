"""Example problems — counterparts of :mod:`ratilqr_tpu.models.examples`.

Each constructor takes the JAX version's arguments plus ``device``; the
same arguments build the same problem in both packages.  Callbacks act on
unbatched tensors and keep their constants on the problem's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ratilqr_tpu_torch.ops.tile_model import (lqr_tile_model,
                                              unicycle_tile_model)
from ratilqr_tpu_torch.problems import RiskSensitiveProblem


def _const_W(mat, dtype, device):
    W = torch.as_tensor(mat, dtype=dtype, device=device)
    return lambda k: W


def double_integrator(N: int = 10, noise: float = 0.1,
                      dtype=torch.float64, device="cpu"
                      ) -> RiskSensitiveProblem:
    """2-D single integrator with time-weighted quadratic costs
    (``docs/source/getting-started.md:52-62``)."""
    eye = torch.eye(2, dtype=dtype, device=device)

    def c(k, x, u):
        kf = k.to(x.dtype)
        return kf / 2.0 * (x @ x) + kf / 2.0 * (u @ u)

    return RiskSensitiveProblem(
        f=lambda x, u: x + u, c=c,
        h=lambda x: N / 2.0 * (x @ x),
        W=_const_W(noise * np.eye(2), dtype, device), N=N,
        f_jac=lambda x, u: (x + u, eye, eye))


def lqr_problem(N: int = 10, noise: float = 1.0, dtype=torch.float64,
                device="cpu") -> RiskSensitiveProblem:
    """Linear dynamics + time-invariant quadratic costs
    (``test/ileqg_test.jl:68-69``)."""
    return RiskSensitiveProblem(
        f=lambda x, u: x + u,
        c=lambda k, x, u: 0.5 * (x @ x) + 1.0 * (u @ u),
        h=lambda x: 0.5 * (x @ x),
        W=_const_W(noise * np.eye(2), dtype, device), N=N,
        tile_model=lqr_tile_model())


def nonlinear_toy(N: int = 10, noise: float = 0.01, dtype=torch.float64,
                  device="cpu") -> RiskSensitiveProblem:
    """``f = x^1.3 + u^1.5``, ``c = Σ(x^2.5 + u^2.5)``, ``h = 1``
    (``test/ileqg_test.jl:151-155``); valid for non-negative x and u."""
    return RiskSensitiveProblem(
        f=lambda x, u: x ** 1.3 + u ** 1.5,
        c=lambda k, x, u: torch.sum(x ** 2.5 + u ** 2.5),
        h=lambda x: 0.0 * x.sum() + 1.0,
        W=_const_W(noise * np.eye(2), dtype, device), N=N)


def unicycle(N: int = 100, dt: float = 0.1, noise: float = 1e-3,
             goal=(5.0, 5.0), dtype=torch.float64, device="cpu",
             analytic_jacobians: bool = False) -> RiskSensitiveProblem:
    """Stochastic unicycle regulation: state ``(px, py, heading)``, control
    ``(v, ω)``.  ``analytic_jacobians=True`` supplies closed-form ``A/B``
    through ``f_jac``."""
    g = torch.as_tensor(list(goal) + [0.0], dtype=dtype, device=device)

    def f(x, u):
        px, py, th = x[0], x[1], x[2]
        v, om = u[0], u[1]
        return torch.stack([px + dt * v * torch.cos(th),
                            py + dt * v * torch.sin(th),
                            th + dt * om])

    def f_jac(x, u):
        th, v = x[2], u[0]
        s, co = torch.sin(th), torch.cos(th)
        one = torch.ones_like(th)
        zero = torch.zeros_like(th)
        x_next = torch.stack([x[0] + dt * v * co, x[1] + dt * v * s,
                              th + dt * u[1]])
        A = torch.stack([torch.stack([one, zero, -dt * v * s]),
                         torch.stack([zero, one, dt * v * co]),
                         torch.stack([zero, zero, one])])
        B = torch.stack([torch.stack([dt * co, zero]),
                         torch.stack([dt * s, zero]),
                         torch.stack([zero, dt * one])])
        return x_next, A, B

    def c(k, x, u):
        dx = x - g
        return 0.05 * (dx @ dx) + 0.05 * (u @ u)

    def h(x):
        dx = x - g
        return 10.0 * (dx @ dx)

    return RiskSensitiveProblem(
        f=f, c=c, h=h, W=_const_W(noise * np.eye(3), dtype, device), N=N,
        f_jac=f_jac if analytic_jacobians else None,
        tile_model=unicycle_tile_model(dt, goal))
