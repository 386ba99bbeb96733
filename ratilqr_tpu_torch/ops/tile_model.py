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
    parameters, passed to the kernel by value.

Only the unicycle and the quadratic integrator (LQR) have device models so
far; on CUDA the fused kernels raise ``NotImplementedError`` for any other
problem.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

# Device model ids, shared with csrc/tile_model.cuh.
UNICYCLE = 0
LQR = 1


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
      model_id: device model id (``UNICYCLE`` or ``LQR``).
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
    path)."""
    tm = problem.tile_model
    if tm is None or tm.model_id not in (UNICYCLE, LQR):
        raise NotImplementedError(
            "the fused CUDA kernels need a tile model with a device model "
            "(unicycle or LQR); this problem has none")
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
