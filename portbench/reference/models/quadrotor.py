"""Small-angle 12-state quadrotor (n=12, m=4): position, velocity,
roll/pitch/yaw and body rates; controls are the thrust offset from hover
and three body torques (rate gain 20).  Stage cost ``0.05|x − g|² +
0.1|u|²``, terminal ``20|x − g|²``, ``g`` the goal position at rest.  The
dynamics and their Jacobians act on a bank ``x (B, 12)``, ``u (B, 4)``;
the costs on one lane."""
from __future__ import annotations

import torch

from portbench.reference.ileqg import Problem

GRAVITY = 9.81
RATE_GAIN = 20.0


def build(params: dict, dtype, device) -> Problem:
    dt, noise, N = params["dt"], params["noise"], params["N"]
    g = torch.zeros(12, dtype=dtype, device=device)
    g[0:3] = torch.tensor(params["goal"], dtype=dtype, device=device)
    eye3 = torch.eye(3, dtype=dtype, device=device)

    def f(x, u):
        pos, vel, att, rate = x[:, 0:3], x[:, 3:6], x[:, 6:9], x[:, 9:12]
        thrust = GRAVITY + u[:, 0]
        phi, th = att[:, 0], att[:, 1]
        acc = torch.stack([thrust * torch.sin(th),
                           -thrust * torch.sin(phi) * torch.cos(th),
                           thrust * torch.cos(phi) * torch.cos(th) - GRAVITY],
                          -1)
        return torch.cat([pos + dt * vel, vel + dt * acc, att + dt * rate,
                          rate + dt * u[:, 1:4] * RATE_GAIN], -1)

    def f_jac(x, u):
        Bn = x.shape[0]
        thrust = GRAVITY + u[:, 0]
        phi, th = x[:, 6], x[:, 7]
        sp, cp, st, ct = (torch.sin(phi), torch.cos(phi), torch.sin(th),
                          torch.cos(th))
        zero = torch.zeros_like(phi)
        A = torch.eye(12, dtype=x.dtype, device=x.device).repeat(Bn, 1, 1)
        A[:, 0:3, 3:6] += dt * eye3
        A[:, 6:9, 9:12] += dt * eye3
        # d acc / d (roll, pitch)
        A[:, 3:6, 6:8] = dt * torch.stack([
            torch.stack([zero, thrust * ct], -1),
            torch.stack([-thrust * cp * ct, thrust * sp * st], -1),
            torch.stack([-thrust * sp * ct, -thrust * cp * st], -1)], -2)
        B = torch.zeros((Bn, 12, 4), dtype=x.dtype, device=x.device)
        B[:, 3:6, 0] = dt * torch.stack([st, -sp * ct, cp * ct], -1)
        B[:, 9:12, 1:4] = dt * RATE_GAIN * eye3
        return f(x, u), A, B

    def c(k, x, u):
        dx = x - g
        return 0.05 * (dx @ dx) + 0.1 * (u @ u)

    def h(x):
        dx = x - g
        return 20.0 * (dx @ dx)

    W = noise * torch.eye(12, dtype=dtype, device=device)
    return Problem(f=f, f_jac=f_jac, c=c, h=h, W=W, N=N)
