"""Kernel B wrapper: the fused step (rollout + quadratization + optimizing
DP) on CUDA.

Counterpart of :mod:`ratilqr_tpu.ops.step_pallas`.  :func:`step_optimize_bank`
launches ``csrc/step.cu`` for a bank on a CUDA device and runs
:func:`step_optimize_bank_plain` — open-loop rollout with Jacobians,
``approximate_model`` and the slim optimizing core, the JAX per-example
semantics (``step_pallas.py:341-346``) — for a bank on the CPU.
:func:`step_optimize` adds the per-lane μ-restart loop outside the kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ratilqr_tpu_torch.ops import _build
from ratilqr_tpu_torch.ops.approx import NoiseModel, approximate_model
from ratilqr_tpu_torch.ops.riccati import MAX_MU_RESTARTS, mu_restart_loop
from ratilqr_tpu_torch.ops.riccati_cuda import riccati_bank_plain
from ratilqr_tpu_torch.ops.rollout import rollout_open_loop_with_jac
from ratilqr_tpu_torch.ops.tile_model import device_model

Tensor = torch.Tensor
KERNEL = "step"


class StepOut(NamedTuple):
    x: Tensor       # (B, T+1, n) open-loop rollout of l from x0
    value: Tensor   # (B,)
    L: Tensor       # (B, T, m, n)
    dl: Tensor      # (B, T, m)
    m_fail: Tensor  # (B,) bool
    h_fail: Tensor  # (B,) bool


def step_optimize_bank_plain(problem, x0: Tensor, l: Tensor, theta: Tensor,
                             mu: Tensor, noise: NoiseModel) -> StepOut:
    """Plain PyTorch version of the fused step."""
    x, A, B = rollout_open_loop_with_jac(problem, x0, l)
    approx = approximate_model(problem, l, x, A, B, noise)
    bank = riccati_bank_plain(approx, theta, mu, slim=True)
    return StepOut(x, bank.value, bank.L, bank.dl, bank.m_fail, bank.h_fail)


def step_optimize_bank(problem, x0: Tensor, l: Tensor, theta: Tensor,
                       mu: Tensor, noise: NoiseModel) -> StepOut:
    """Fused step for a bank: ``x0 (B, n)``, ``l (B, T, m)``, ``theta``/
    ``mu (B,)``, lane-invariant ``noise``.  CUDA needs a problem whose tile
    model has a device model."""
    if x0.device.type == "cpu":
        return step_optimize_bank_plain(problem, x0, l, theta, mu, noise)
    if x0.device.type != "cuda":
        raise NotImplementedError(f"no step kernel for device {x0.device}")
    return _step_bank_cuda(problem, x0, l, theta, mu, noise)


def _step_bank_cuda(problem, x0, l, theta, mu, noise):
    tm = device_model(problem)
    Bn, T, m = l.shape
    n = x0.shape[-1]
    dtype, device = x0.dtype, x0.device
    code = _build.dtype_code(dtype)
    for name, x, shape in (("x0", x0, (Bn, tm.n)), ("l", l, (Bn, T, tm.m)),
                           ("theta", theta, (Bn,)), ("mu", mu, (Bn,)),
                           ("W", noise.W, (T, n, n)),
                           ("W_inv", noise.W_inv, (T, n, n)),
                           ("logdet_W", noise.logdet_W, (T,))):
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != device:
            raise ValueError(f"step kernel: {name} is {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}, expected {shape} "
                             f"{dtype} on {device}")
    lm = _build.lane_minor
    ins = [lm(l), lm(x0), noise.W.contiguous(), noise.W_inv.contiguous(),
           noise.logdet_W.contiguous(), theta.contiguous(), mu.contiguous()]
    x = torch.empty((T + 1, n, Bn), dtype=dtype, device=device)
    value = torch.empty(Bn, dtype=dtype, device=device)
    L = torch.empty((T, m, n, Bn), dtype=dtype, device=device)
    dl = torch.empty((T, m, Bn), dtype=dtype, device=device)
    m_fail = torch.empty(Bn, dtype=torch.bool, device=device)
    h_fail = torch.empty(Bn, dtype=torch.bool, device=device)
    params = (tuple(tm.params) + (0.0,) * 4)[:4]
    lib = _build.library()
    with torch.cuda.device(device):
        rc = lib.ratilqr_step(code, tm.model_id, Bn, T, *params,
                              *map(_build.ptr, ins),
                              *map(_build.ptr, (x, value, L, dl, m_fail,
                                                h_fail)),
                              _build.stream_of(value))
    _build.check(rc, KERNEL)
    _build.launch_counts[KERNEL] += 1
    return StepOut(x.movedim(-1, 0), value, L.movedim(-1, 0),
                   dl.movedim(-1, 0), m_fail, h_fail)


def step_optimize(problem, x0: Tensor, l: Tensor, *, theta: Tensor,
                  mu: Tensor, delta: Tensor, mu_min: float, delta_0: float,
                  noise: NoiseModel, max_restarts: int = MAX_MU_RESTARTS,
                  active: Optional[Tensor] = None):
    """Fused step with the per-lane μ-restart loop (``step_pallas.py:399``):
    returns ``(x, value, L, dl, mu, delta, failed)``.  A restart re-runs the
    whole fused step; its rollout does not depend on μ."""
    def run(mu_v):
        return tuple(step_optimize_bank(problem, x0, l, theta, mu_v, noise))

    return mu_restart_loop(run, mu, delta, mu_min, delta_0, max_restarts,
                           active)
