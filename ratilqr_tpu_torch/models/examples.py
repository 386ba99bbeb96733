"""Example problems — counterparts of :mod:`ratilqr_tpu.models.examples`.

Each constructor takes the JAX version's arguments plus ``device``, which
defaults to ``"cuda"``: the port's problems live on the card unless the
caller asks for the CPU (``device="cpu"``).  The same arguments build the
same problem in both packages.  Callbacks act on unbatched tensors and keep
their constants on the problem's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ratilqr_tpu_torch.ops.tile_model import (cartpole_tile_model,
                                              lqr_tile_model,
                                              quadrotor_tile_model,
                                              unicycle_tile_model)
from ratilqr_tpu_torch.problems import GenerativeProblem, RiskSensitiveProblem


def _const_W(mat, dtype, device):
    W = torch.as_tensor(mat, dtype=dtype, device=device)
    return lambda k: W


def double_integrator(N: int = 10, noise: float = 0.1,
                      dtype=torch.float64, device="cuda"
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
                device="cuda") -> RiskSensitiveProblem:
    """Linear dynamics + time-invariant quadratic costs
    (``test/ileqg_test.jl:68-69``)."""
    return RiskSensitiveProblem(
        f=lambda x, u: x + u,
        c=lambda k, x, u: 0.5 * (x @ x) + 1.0 * (u @ u),
        h=lambda x: 0.5 * (x @ x),
        W=_const_W(noise * np.eye(2), dtype, device), N=N,
        tile_model=lqr_tile_model())


def nonlinear_toy(N: int = 10, noise: float = 0.01, dtype=torch.float64,
                  device="cuda") -> RiskSensitiveProblem:
    """``f = x^1.3 + u^1.5``, ``c = Σ(x^2.5 + u^2.5)``, ``h = 1``
    (``test/ileqg_test.jl:151-155``); valid for non-negative x and u."""
    return RiskSensitiveProblem(
        f=lambda x, u: x ** 1.3 + u ** 1.5,
        c=lambda k, x, u: torch.sum(x ** 2.5 + u ** 2.5),
        h=lambda x: 0.0 * x.sum() + 1.0,
        W=_const_W(noise * np.eye(2), dtype, device), N=N)


def unicycle(N: int = 100, dt: float = 0.1, noise: float = 1e-3,
             goal=(5.0, 5.0), dtype=torch.float64, device="cuda",
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


def cartpole(N: int = 50, dt: float = 0.05, noise: float = 1e-4,
             dtype=torch.float64, device="cuda") -> RiskSensitiveProblem:
    """Cart-pole swing-up/balance (n=4, m=1): state ``(x, ẋ, φ, φ̇)`` with
    φ = 0 upright (unstable), control = horizontal force."""
    mc, mp, lp, grav = 1.0, 0.1, 0.5, 9.81

    def f(x, u):
        pos, vel, phi, om = x[0], x[1], x[2], x[3]
        force = u[0]
        sin, cos = torch.sin(phi), torch.cos(phi)
        temp = (force + mp * lp * om ** 2 * sin) / (mc + mp)
        phi_acc = ((grav * sin - cos * temp)
                   / (lp * (4.0 / 3.0 - mp * cos ** 2 / (mc + mp))))
        acc = temp - mp * lp * phi_acc * cos / (mc + mp)
        return torch.stack([pos + dt * vel, vel + dt * acc,
                            phi + dt * om, om + dt * phi_acc])

    def c(k, x, u):
        return 0.1 * (x[0] ** 2 + x[1] ** 2 + 10.0 * x[2] ** 2
                      + x[3] ** 2) + 0.05 * u[0] ** 2

    def h(x):
        return 10.0 * (x[0] ** 2 + x[1] ** 2 + 10.0 * x[2] ** 2
                       + x[3] ** 2)

    return RiskSensitiveProblem(
        f=f, c=c, h=h, W=_const_W(noise * np.eye(4), dtype, device), N=N,
        tile_model=cartpole_tile_model(dt, mc, mp, lp, grav))


def quadrotor(N: int = 50, dt: float = 0.02, noise: float = 1e-5,
              goal=(1.0, 1.0, 1.0), dtype=torch.float64, device="cuda"
              ) -> RiskSensitiveProblem:
    """Simplified 12-state quadrotor (n=12, m=4): position, velocity,
    attitude (roll/pitch/yaw) and body rates with small-angle rotational
    kinematics; controls = total thrust offset + body torques."""
    grav = 9.81
    g = torch.zeros(12, dtype=dtype, device=device)
    g[0:3] = torch.as_tensor(goal, dtype=dtype, device=device)

    def f(x, u):
        pos, vel = x[0:3], x[3:6]
        att, rate = x[6:9], x[9:12]          # roll, pitch, yaw + body rates
        thrust = grav + u[0]
        phi, th = att[0], att[1]
        acc = torch.stack([
            thrust * torch.sin(th),
            -thrust * torch.sin(phi) * torch.cos(th),
            thrust * torch.cos(phi) * torch.cos(th) - grav,
        ])
        return torch.cat([pos + dt * vel, vel + dt * acc, att + dt * rate,
                          rate + dt * u[1:4] * 20.0])

    def c(k, x, u):
        dx = x - g
        return 0.05 * (dx @ dx) + 0.1 * (u @ u)

    def h(x):
        dx = x - g
        return 20.0 * (dx @ dx)

    return RiskSensitiveProblem(
        f=f, c=c, h=h, W=_const_W(noise * np.eye(12), dtype, device), N=N,
        tile_model=quadrotor_tile_model(dt, grav, goal))


def gmm_integrator(N: int = 10, dtype=torch.float64, device="cuda"
                   ) -> GenerativeProblem:
    """Generative 2-D integrator with model mismatch
    (``optimal_control_problems.jl:102-116``): the solver's internal model
    adds ``w ~ N(0, 0.5 I)``, the true simulator the mixture ``0.5·N(0,
    0.5 I) + 0.5·N(1, I)``.  A lane's noise is ``(z, pick)``: a standard
    normal ``z`` and a fair Bernoulli ``pick`` choosing the mixture's
    second component (used by the true model only).  ``dtype`` is that of
    the states the solvers pass (the JAX constructor's argument)."""
    sqrt_half = 0.5 ** 0.5

    def f_stochastic(x, u, noise, use_true_model=False):
        z, pick = noise
        if use_true_model:
            w = torch.where(pick, 1.0 + z, sqrt_half * z)
        else:
            w = sqrt_half * z
        return x + u + w

    def draw_noise(generator, x, use_true_model=False):
        dev = generator.device
        z = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                        device=dev)
        pick = torch.rand(x.shape[0], generator=generator, dtype=x.dtype,
                          device=dev) < 0.5
        return z.to(x.device), pick.to(x.device)

    def c(k, x, u):
        kf = k.to(x.dtype)
        return kf / 2.0 * (x @ x) + kf / 2.0 * (u @ u)

    return GenerativeProblem(f_stochastic=f_stochastic,
                             draw_noise=draw_noise, c=c,
                             h=lambda x: N / 2.0 * (x @ x), N=N,
                             device=device)
