"""Kernel B wrapper: the fused step (rollout + quadratization + optimizing
DP) on CUDA.

Counterpart of :mod:`ratilqr_tpu.ops.step_pallas`.  The kernel runs one
solve per team of 4 or 1 lanes on the small models (the launch picks from
the bank's width and the SM count, by the rule kernel C shares) and one
solve per team of 16 lanes on the quadrotor (``csrc/step.cu``); the
wrapper is the same for both.
:func:`step_optimize_bank` launches ``csrc/step.cu`` for a bank on a CUDA
device and runs
:func:`step_optimize_bank_plain` — open-loop rollout with Jacobians,
``approximate_model`` and the slim optimizing core, the JAX per-example
semantics (``step_pallas.py:341-346``) — for a bank on the CPU.  A problem
with no tile model runs that composition with the Riccati dispatch
(kernel A on CUDA), as JAX runs its XLA composition without a tile model
(``step_pallas.py:353-364``).  :func:`step_optimize` adds the per-lane
μ-restart loop outside the kernel.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ratilqr_tpu_torch.ops import _build, riccati_cuda
from ratilqr_tpu_torch.ops.approx import NoiseModel, approximate_model
from ratilqr_tpu_torch.ops.riccati import MAX_MU_RESTARTS, mu_restart_loop
from ratilqr_tpu_torch.ops.rollout import rollout_open_loop_with_jac
from ratilqr_tpu_torch.ops.tile_model import device_model
from ratilqr_tpu_torch.utils.profiling import span, spanned

Tensor = torch.Tensor
KERNEL = "step"


class StepOut(NamedTuple):
    x: Tensor       # (B, T+1, n) open-loop rollout of l from x0
    value: Tensor   # (B,)
    L: Tensor       # (B, T, m, n)
    dl: Tensor      # (B, T, m)
    m_fail: Tensor  # (B,) bool
    h_fail: Tensor  # (B,) bool


def _composition(dp, problem, x0, l, theta, mu, noise) -> StepOut:
    x, A, B = rollout_open_loop_with_jac(problem, x0, l)
    approx = approximate_model(problem, l, x, A, B, noise)
    bank = dp(approx, theta, mu, slim=True)
    return StepOut(x, bank.value, bank.L, bank.dl, bank.m_fail, bank.h_fail)


def step_optimize_bank_plain(problem, x0: Tensor, l: Tensor, theta: Tensor,
                             mu: Tensor, noise: NoiseModel) -> StepOut:
    """Plain PyTorch version of the fused step."""
    return _composition(riccati_cuda.riccati_bank_plain, problem, x0, l,
                        theta, mu, noise)


def step_optimize_bank(problem, x0: Tensor, l: Tensor, theta: Tensor,
                       mu: Tensor, noise: NoiseModel) -> StepOut:
    """Fused step for a bank: ``x0 (B, n)``, ``l (B, T, m)``, ``theta``/
    ``mu (B,)``, lane-invariant ``noise``.  A problem with no tile model
    takes the composition through :func:`~ratilqr_tpu_torch.ops.
    riccati_cuda.riccati_bank`; on CUDA a tile model needs a device
    model."""
    if problem.tile_model is None:
        return _composition(riccati_cuda.riccati_bank, problem, x0, l, theta,
                            mu, noise)
    if x0.device.type == "cpu":
        return step_optimize_bank_plain(problem, x0, l, theta, mu, noise)
    if x0.device.type != "cuda":
        raise NotImplementedError(f"no step kernel for device {x0.device}")
    return launch_step(*step_layout(problem, x0, l, theta, mu, noise))


def step_layout(problem, x0: Tensor, l: Tensor, theta: Tensor, mu: Tensor,
                noise: NoiseModel):
    """Check a bank against what kernel B takes and copy it to the kernel's
    lane-minor layout; returns the arguments of :func:`launch_step`."""
    tm = device_model(problem)
    Bn, T, m = l.shape
    n = x0.shape[-1]
    dtype, device = x0.dtype, x0.device
    _build.dtype_suffix(dtype)   # raises for a type the kernel does not take
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
    with span("layout"):
        ins = [lm(l), lm(x0), noise.W.contiguous(), noise.W_inv.contiguous(),
               noise.logdet_W.contiguous(), theta.contiguous(),
               mu.contiguous()]
    return tm, ins


def block_shared_memory(model_id: int, dtype, B: int
                        ) -> Tuple[int, int, int]:
    """``(bytes, solves, lanes)`` of kernel B's launch on a device model for
    a bank of ``B`` lanes on the current card: the dynamic shared memory a
    block takes, its solves a block and lanes a solve (n ≤ 4: 4 or 1,
    picked from B and the SM count by the rule kernel C shares; the
    quadrotor: 16)
    (:func:`~ratilqr_tpu_torch.ops._build.block_shared_memory`)."""
    return _build.block_shared_memory(KERNEL, model_id, dtype, B)


def first_widths(model_id: int, dtype, B_max: int = 1 << 30
                 ) -> Dict[int, int]:
    """``{lanes a solve: the narrowest width B ≤ B_max whose launch takes
    it}`` of kernel B on a device model on the current card
    (:func:`~ratilqr_tpu_torch.ops._build.first_widths`)."""
    return _build.first_widths(KERNEL, model_id, dtype, B_max)


def launch_step(tm, ins, entry=None) -> StepOut:
    """Launch kernel B on arguments prepared by :func:`step_layout`;
    ``entry`` is another build's C entry point of the same type (the
    shipped library's by default)."""
    (T, m, Bn), n = ins[0].shape, tm.n
    dtype, device = ins[0].dtype, ins[0].device
    x = torch.empty((T + 1, n, Bn), dtype=dtype, device=device)
    value = torch.empty(Bn, dtype=dtype, device=device)
    L = torch.empty((T, m, n, Bn), dtype=dtype, device=device)
    dl = torch.empty((T, m, Bn), dtype=dtype, device=device)
    m_fail = torch.empty(Bn, dtype=torch.bool, device=device)
    h_fail = torch.empty(Bn, dtype=torch.bool, device=device)
    params = _build.params_array(tm.params)
    launch = entry or _build.entry(KERNEL, dtype)
    with span("launch.step"), torch.cuda.device(device):
        rc = launch(tm.model_id, Bn, T, params, *map(_build.ptr, ins),
                    *map(_build.ptr, (x, value, L, dl, m_fail, h_fail)),
                    _build.stream_of(value))
    _build.check(rc, KERNEL)
    _build.launch_counts[KERNEL] += 1
    return StepOut(x.movedim(-1, 0), value, L.movedim(-1, 0),
                   dl.movedim(-1, 0), m_fail, h_fail)


@spanned("step_optimize")
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
