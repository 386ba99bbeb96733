"""Stochastic unicycle regulation (n=3, m=2): state ``(px, py, heading)``,
control ``(v, ω)``, Euler step ``dt``, noise ``W = noise·I``; stage cost
``0.05|x − g|² + 0.05|u|²``, terminal ``10|x − g|²``.  The dynamics and
their Jacobians act on a bank ``x (B, 3)``, ``u (B, 2)``; the costs on one
lane."""
from __future__ import annotations

import torch

from portbench.reference.ileqg import Problem


def build(params: dict, dtype, device) -> Problem:
    dt, noise, N = params["dt"], params["noise"], params["N"]
    g = torch.tensor(list(params["goal"]) + [0.0], dtype=dtype, device=device)

    def f(x, u):
        th, v = x[:, 2], u[:, 0]
        return torch.stack([x[:, 0] + dt * v * torch.cos(th),
                            x[:, 1] + dt * v * torch.sin(th),
                            th + dt * u[:, 1]], -1)

    def f_jac(x, u):
        th, v = x[:, 2], u[:, 0]
        s, c = torch.sin(th), torch.cos(th)
        one, zero = torch.ones_like(th), torch.zeros_like(th)
        A = torch.stack([torch.stack([one, zero, -dt * v * s], -1),
                         torch.stack([zero, one, dt * v * c], -1),
                         torch.stack([zero, zero, one], -1)], -2)
        B = torch.stack([torch.stack([dt * c, zero], -1),
                         torch.stack([dt * s, zero], -1),
                         torch.stack([zero, dt * one], -1)], -2)
        return f(x, u), A, B

    def c(k, x, u):
        dx = x - g
        return 0.05 * (dx @ dx) + 0.05 * (u @ u)

    def h(x):
        dx = x - g
        return 10.0 * (dx @ dx)

    W = noise * torch.eye(3, dtype=dtype, device=device)
    return Problem(f=f, f_jac=f_jac, c=c, h=h, W=W, N=N)
