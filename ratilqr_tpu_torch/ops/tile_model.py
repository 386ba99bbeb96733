"""Tile models: closed-form model pieces for the fused CUDA kernels.

Counterpart of :mod:`ratilqr_tpu.ops.tile_model`.  A :class:`TileModel`
carries two things:

  - plain-torch versions of the three closed-form pieces the fused step
    and candidate kernels evaluate in-kernel (``f_jac``, ``quad``,
    ``term``), written component-wise over ``(..., n)`` lane tensors — the
    tests hold them against ``torch.func`` derivatives of the problem's
    ``f``/``c``/``h``;
  - the device model the kernels run: ``model_id`` names a ``__device__``
    model in ``csrc/tile_model.cuh`` and ``params`` are its scalar
    parameters, passed to the kernel by value (at most
    ``_build.MAX_PARAMS`` of them).

The unicycle, the quadratic integrator (LQR), the cartpole and the
quadrotor have device models.  A problem with no tile model takes the
composition of plain pieces and kernels A and D on CUDA (as JAX runs its
XLA composition); a tile model without a device model raises
``NotImplementedError`` there.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

# Device model ids, shared with csrc/tile_model.cuh.
UNICYCLE = 0
LQR = 1
QUADROTOR = 2
CARTPOLE = 3
DEVICE_MODELS = {UNICYCLE: "unicycle", LQR: "LQR", QUADROTOR: "quadrotor",
                 CARTPOLE: "cartpole"}


def _mat(rows):
    """Stack a nested list of (...) tensors into a (..., p, q) block."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


@dataclasses.dataclass(frozen=True)
class TileModel:
    """Closed-form model pieces plus the device model descriptor.

    Attributes:
      f_jac: ``(x, u) -> (x_next, A, B)``.
      quad: ``(k, x, u) -> (q, q_vec, Q, r, R, P)`` — stage cost and its
        exact derivatives (``P = c_ux``).
      term: ``x -> (q, q_vec, Q)`` — terminal cost and derivatives.
      model_id: device model id (a key of ``DEVICE_MODELS``).
      params: the device model's scalar parameters.
      n, m: state and control dimensions.
    """
    f_jac: Callable
    quad: Callable
    term: Callable
    model_id: int
    params: Tuple[float, ...]
    n: int
    m: int


def device_model(problem) -> TileModel:
    """The problem's tile model, if the fused CUDA kernels have its device
    model; raises ``NotImplementedError`` otherwise (never a silent plain
    path).  Callers route a problem with no tile model to the composition
    before they get here."""
    tm = problem.tile_model
    if tm is None or tm.model_id not in DEVICE_MODELS:
        raise NotImplementedError(
            "the fused CUDA kernels need a tile model with a device model ("
            + ", ".join(DEVICE_MODELS.values()) + "); this problem's tile "
            "model has none")
    return tm


def unicycle_tile_model(dt: float, goal) -> TileModel:
    """Tile model of :func:`ratilqr_tpu_torch.models.unicycle`; device
    parameters ``(dt, goal_x, goal_y)``."""
    gx, gy = float(goal[0]), float(goal[1])

    def f_jac(x, u):
        px, py, th = x[..., 0], x[..., 1], x[..., 2]
        v, om = u[..., 0], u[..., 1]
        s, co = torch.sin(th), torch.cos(th)
        one = torch.ones_like(th)
        zero = torch.zeros_like(th)
        x_next = torch.stack([px + dt * v * co, py + dt * v * s,
                              th + dt * om], -1)
        A = _mat([[one, zero, -dt * v * s],
                  [zero, one, dt * v * co],
                  [zero, zero, one]])
        B = _mat([[dt * co, zero],
                  [dt * s, zero],
                  [zero, dt * one]])
        return x_next, A, B

    def quad(k, x, u):
        del k
        dx = torch.stack([x[..., 0] - gx, x[..., 1] - gy, x[..., 2]], -1)
        q = (0.05 * (dx[..., 0] * dx[..., 0] + dx[..., 1] * dx[..., 1]
                     + dx[..., 2] * dx[..., 2])
             + 0.05 * (u[..., 0] * u[..., 0] + u[..., 1] * u[..., 1]))
        one = torch.ones_like(q)
        zero = torch.zeros_like(q)
        Q = _mat([[0.1 * one, zero, zero],
                  [zero, 0.1 * one, zero],
                  [zero, zero, 0.1 * one]])
        R = _mat([[0.1 * one, zero], [zero, 0.1 * one]])
        P = _mat([[zero, zero, zero], [zero, zero, zero]])
        return q, 0.1 * dx, Q, 0.1 * u, R, P

    def term(x):
        dx = torch.stack([x[..., 0] - gx, x[..., 1] - gy, x[..., 2]], -1)
        q = 10.0 * (dx[..., 0] * dx[..., 0] + dx[..., 1] * dx[..., 1]
                    + dx[..., 2] * dx[..., 2])
        one = torch.ones_like(q)
        zero = torch.zeros_like(q)
        Q = _mat([[20.0 * one, zero, zero],
                  [zero, 20.0 * one, zero],
                  [zero, zero, 20.0 * one]])
        return q, 20.0 * dx, Q

    return TileModel(f_jac=f_jac, quad=quad, term=term, model_id=UNICYCLE,
                     params=(float(dt), gx, gy), n=3, m=2)


def cartpole_tile_model(dt: float, mc: float, mp: float, lp: float,
                        grav: float) -> TileModel:
    """Tile model of :func:`ratilqr_tpu_torch.models.cartpole` (n=4, m=1):
    closed-form Jacobians of the φ-from-upright cart-pole, with the
    quotient-rule expansion of ``phi_acc = N(φ)/D(φ)``.  Device parameters
    ``(dt, mc, mp, lp, grav)``."""
    M = mc + mp
    k1 = mp * lp / M

    def f_jac(x, u):
        pos, vel, phi, om = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
        force = u[..., 0]
        s, c = torch.sin(phi), torch.cos(phi)
        one = torch.ones_like(phi)
        zero = torch.zeros_like(phi)

        temp = (force + mp * lp * om * om * s) / M
        D = lp * (4.0 / 3.0 - mp * c * c / M)
        N = grav * s - c * temp
        phi_acc = N / D
        acc = temp - k1 * phi_acc * c
        x_next = torch.stack([pos + dt * vel, vel + dt * acc,
                              phi + dt * om, om + dt * phi_acc], -1)

        dtemp_dphi = k1 * om * om * c
        dtemp_dom = 2.0 * k1 * om * s
        dtemp_dF = one / M
        dN_dphi = grav * c + s * temp - c * dtemp_dphi
        dD_dphi = 2.0 * lp * mp * c * s / M
        dpa_dphi = (dN_dphi * D - N * dD_dphi) / (D * D)
        dpa_dom = -c * dtemp_dom / D
        dpa_dF = -c * dtemp_dF / D
        dacc_dphi = dtemp_dphi - k1 * (dpa_dphi * c - phi_acc * s)
        dacc_dom = dtemp_dom - k1 * c * dpa_dom
        dacc_dF = dtemp_dF - k1 * c * dpa_dF

        A = _mat([[one, dt * one, zero, zero],
                  [zero, one, dt * dacc_dphi, dt * dacc_dom],
                  [zero, zero, one, dt * one],
                  [zero, zero, dt * dpa_dphi, one + dt * dpa_dom]])
        B = _mat([[zero], [dt * dacc_dF], [zero], [dt * dpa_dF]])
        return x_next, A, B

    def quad(k, x, u):
        del k
        q = (0.1 * (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
                    + 10.0 * x[..., 2] * x[..., 2] + x[..., 3] * x[..., 3])
             + 0.05 * u[..., 0] * u[..., 0])
        one = torch.ones_like(q)
        zero = torch.zeros_like(q)
        q_vec = torch.stack([0.2 * x[..., 0], 0.2 * x[..., 1],
                             2.0 * x[..., 2], 0.2 * x[..., 3]], -1)
        Q = _mat([[0.2 * one, zero, zero, zero],
                  [zero, 0.2 * one, zero, zero],
                  [zero, zero, 2.0 * one, zero],
                  [zero, zero, zero, 0.2 * one]])
        R = _mat([[0.1 * one]])
        P = _mat([[zero, zero, zero, zero]])
        return q, q_vec, Q, 0.1 * u, R, P

    def term(x):
        q = 10.0 * (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
                    + 10.0 * x[..., 2] * x[..., 2] + x[..., 3] * x[..., 3])
        one = torch.ones_like(q)
        zero = torch.zeros_like(q)
        q_vec = torch.stack([20.0 * x[..., 0], 20.0 * x[..., 1],
                             200.0 * x[..., 2], 20.0 * x[..., 3]], -1)
        Q = _mat([[20.0 * one, zero, zero, zero],
                  [zero, 20.0 * one, zero, zero],
                  [zero, zero, 200.0 * one, zero],
                  [zero, zero, zero, 20.0 * one]])
        return q, q_vec, Q

    return TileModel(f_jac=f_jac, quad=quad, term=term, model_id=CARTPOLE,
                     params=(float(dt), float(mc), float(mp), float(lp),
                             float(grav)), n=4, m=1)


def quadrotor_tile_model(dt: float, grav: float, goal) -> TileModel:
    """Tile model of :func:`ratilqr_tpu_torch.models.quadrotor` (n=12,
    m=4): the closed-form Jacobians of the small-angle quadrotor, where only
    the acceleration rows (thrust through roll/pitch trigonometry) are
    nonlinear.  Device parameters ``(dt, grav, goal_x, goal_y, goal_z)``."""
    goals = [float(g) for g in goal] + [0.0] * 9

    def f_jac(x, u):
        phi, th = x[..., 6], x[..., 7]
        one = torch.ones_like(phi)
        zero = torch.zeros_like(phi)
        sph, cph = torch.sin(phi), torch.cos(phi)
        sth, cth = torch.sin(th), torch.cos(th)
        thrust = grav + u[..., 0]
        acc = [thrust * sth, -thrust * sph * cth, thrust * cph * cth - grav]
        x_next = torch.stack(
            [x[..., i] + dt * x[..., 3 + i] for i in range(3)]
            + [x[..., 3 + i] + dt * acc[i] for i in range(3)]
            + [x[..., 6 + i] + dt * x[..., 9 + i] for i in range(3)]
            + [x[..., 9 + i] + dt * 20.0 * u[..., 1 + i] for i in range(3)],
            -1)
        A = [[one if i == j else zero for j in range(12)] for i in range(12)]
        for i in range(3):   # pos <- vel, att <- rate
            A[i][3 + i] = dt * one
            A[6 + i][9 + i] = dt * one
        # d acc / d(phi, theta), acc = thrust·(sinθ, −sinφ cosθ, cosφ cosθ)
        A[3][7] = dt * thrust * cth
        A[4][6] = -dt * thrust * cph * cth
        A[4][7] = dt * thrust * sph * sth
        A[5][6] = -dt * thrust * sph * cth
        A[5][7] = -dt * thrust * cph * sth
        B = [[zero] * 4 for _ in range(12)]
        B[3][0] = dt * sth   # d acc / d u0: the thrust direction
        B[4][0] = -dt * sph * cth
        B[5][0] = dt * cph * cth
        for i in range(3):   # rate <- 20·torque
            B[9 + i][1 + i] = dt * 20.0 * one
        return x_next, _mat(A), _mat(B)

    def delta(x):
        return torch.stack([x[..., i] - goals[i] for i in range(12)], -1)

    def quad(k, x, u):
        del k
        dx = delta(x)
        q = (0.05 * sum(dx[..., i] * dx[..., i] for i in range(12))
             + 0.1 * sum(u[..., j] * u[..., j] for j in range(4)))
        one = torch.ones_like(q)
        zero = torch.zeros_like(q)
        Q = _mat([[0.1 * one if i == j else zero for j in range(12)]
                  for i in range(12)])
        R = _mat([[0.2 * one if i == j else zero for j in range(4)]
                  for i in range(4)])
        P = _mat([[zero] * 12 for _ in range(4)])
        return q, 0.1 * dx, Q, 0.2 * u, R, P

    def term(x):
        dx = delta(x)
        q = 20.0 * sum(dx[..., i] * dx[..., i] for i in range(12))
        one = torch.ones_like(q)
        zero = torch.zeros_like(q)
        Q = _mat([[40.0 * one if i == j else zero for j in range(12)]
                  for i in range(12)])
        return q, 40.0 * dx, Q

    return TileModel(f_jac=f_jac, quad=quad, term=term, model_id=QUADROTOR,
                     params=(float(dt), float(grav), *goals[:3]), n=12, m=4)


def lqr_tile_model(x_weight: float = 1.0, u_weight: float = 1.0,
                   term_weight: float = 1.0) -> TileModel:
    """Tile model of the 2-D quadratic integrator ``f = x + u``,
    ``c = ½·x_weight·x·x + u_weight·u·u``, ``h = ½·term_weight·x·x``.

    The defaults are :func:`ratilqr_tpu_torch.models.lqr_problem`; device
    parameters ``(x_weight, u_weight, term_weight)``.
    """
    wx, wu, wh = float(x_weight), float(u_weight), float(term_weight)

    def f_jac(x, u):
        one = torch.ones_like(x[..., 0])
        zero = torch.zeros_like(one)
        eye = _mat([[one, zero], [zero, one]])
        return x + u, eye, eye.clone()

    def quad(k, x, u):
        del k
        q = (0.5 * wx * (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1])
             + wu * (u[..., 0] * u[..., 0] + u[..., 1] * u[..., 1]))
        one = torch.ones_like(q)
        zero = torch.zeros_like(q)
        Q = _mat([[wx * one, zero], [zero, wx * one]])
        R = _mat([[2.0 * wu * one, zero], [zero, 2.0 * wu * one]])
        P = _mat([[zero, zero], [zero, zero]])
        return q, wx * x, Q, 2.0 * wu * u, R, P

    def term(x):
        q = 0.5 * wh * (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1])
        one = torch.ones_like(q)
        zero = torch.zeros_like(q)
        Q = _mat([[wh * one, zero], [zero, wh * one]])
        return q, wh * x, Q

    return TileModel(f_jac=f_jac, quad=quad, term=term, model_id=LQR,
                     params=(wx, wu, wh), n=2, m=2)
