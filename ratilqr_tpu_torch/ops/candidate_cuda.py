"""Kernel C wrapper: one fused line-search trial on CUDA.

Counterpart of :mod:`ratilqr_tpu.ops.candidate_pallas` (both its stored and
its recompute variant, which compute the same value).  The kernel runs one
solve per team of 4 or 1 lanes on the small models (the launch picks
from the bank's width and the SM count) and one solve per team of 16
lanes on the quadrotor (``csrc/candidate.cu``); the wrapper is the same
for both.
:func:`candidate_bank` launches ``csrc/candidate.cu`` for a bank on a CUDA
device and runs :func:`candidate_bank_plain` — ``approximate_folded``
followed by the folded evaluating core (``candidate_pallas.py:427-432``) —
for a bank on the CPU.  A problem with no tile model runs that composition
with the folded Riccati dispatch (kernel D on CUDA), as JAX runs its XLA
folded path without a tile model (``candidate_pallas.py:442-458``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ratilqr_tpu_torch.ops import _build, riccati_cuda
from ratilqr_tpu_torch.ops.approx import NoiseModel, approximate_folded
from ratilqr_tpu_torch.ops.tile_model import device_model

Tensor = torch.Tensor
KERNEL = "candidate"


class CandidateOut(NamedTuple):
    value: Tensor   # (B,)
    m_fail: Tensor  # (B,) bool: neurotic breakdown


def _composition(dp, problem, x_ref, l_cand, L, mu, theta, noise
                 ) -> CandidateOut:
    folded = approximate_folded(problem, x_ref, l_cand, L, mu, noise)
    return CandidateOut(*dp(folded, theta))


def candidate_bank_plain(problem, x_ref: Tensor, l_cand: Tensor, L: Tensor,
                         mu: Tensor, theta: Tensor,
                         noise: NoiseModel) -> CandidateOut:
    """Plain PyTorch version of the fused candidate evaluation."""
    return _composition(riccati_cuda.riccati_bank_folded_plain, problem,
                        x_ref, l_cand, L, mu, theta, noise)


def candidate_bank(problem, x_ref: Tensor, l_cand: Tensor, L: Tensor,
                   mu: Tensor, theta: Tensor,
                   noise: NoiseModel) -> CandidateOut:
    """Evaluate a bank of candidates: closed-loop rollout of ``l_cand
    (B, T, m)`` under gains ``L (B, T, m, n)`` around ``x_ref (B, T+1, n)``,
    quadratize, fold with ``mu (B,)``, folded evaluating DP with ``theta
    (B,)``.  A problem with no tile model takes the composition through
    :func:`~ratilqr_tpu_torch.ops.riccati_cuda.riccati_bank_folded`; on
    CUDA a tile model needs a device model."""
    if problem.tile_model is None:
        return _composition(riccati_cuda.riccati_bank_folded, problem, x_ref,
                            l_cand, L, mu, theta, noise)
    if x_ref.device.type == "cpu":
        return candidate_bank_plain(problem, x_ref, l_cand, L, mu, theta,
                                    noise)
    if x_ref.device.type != "cuda":
        raise NotImplementedError(f"no candidate kernel for device "
                                  f"{x_ref.device}")
    return launch_candidate(*candidate_layout(problem, x_ref, l_cand, L, mu,
                                              theta, noise))


def candidate_layout(problem, x_ref: Tensor, l_cand: Tensor, L: Tensor,
                     mu: Tensor, theta: Tensor, noise: NoiseModel):
    """Check a bank against what kernel C takes and copy it to the kernel's
    lane-minor layout; returns the arguments of :func:`launch_candidate`."""
    tm = device_model(problem)
    Bn, T, m = l_cand.shape
    n = tm.n
    dtype, device = x_ref.dtype, x_ref.device
    _build.dtype_suffix(dtype)   # raises for a type the kernel does not take
    for name, x, shape in (("x_ref", x_ref, (Bn, T + 1, n)),
                           ("l_cand", l_cand, (Bn, T, tm.m)),
                           ("L", L, (Bn, T, tm.m, n)),
                           ("mu", mu, (Bn,)), ("theta", theta, (Bn,)),
                           ("W", noise.W, (T, n, n)),
                           ("W_inv", noise.W_inv, (T, n, n)),
                           ("logdet_W", noise.logdet_W, (T,))):
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != device:
            raise ValueError(f"candidate kernel: {name} is "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}, "
                             f"expected {shape} {dtype} on {device}")
    lm = _build.lane_minor
    ins = [lm(x_ref), lm(l_cand), lm(L), noise.W.contiguous(),
           noise.W_inv.contiguous(), noise.logdet_W.contiguous(),
           theta.contiguous(), mu.contiguous()]
    return tm, ins


def block_shared_memory(model_id: int, dtype, B: int
                        ) -> Tuple[int, int, int]:
    """``(bytes, solves, lanes)`` of kernel C's launch on a device model for
    a bank of ``B`` lanes on the current card: the dynamic shared memory a
    block takes, its solves a block and lanes a solve (n ≤ 4: 4 or 1,
    picked from B and the SM count; the quadrotor: 16)
    (:func:`~ratilqr_tpu_torch.ops._build.block_shared_memory`)."""
    return _build.block_shared_memory(KERNEL, model_id, dtype, B)


def first_widths(model_id: int, dtype, B_max: int = 1 << 30
                 ) -> Dict[int, int]:
    """``{lanes a solve: the narrowest width B ≤ B_max whose launch takes
    it}`` of kernel C on a device model on the current card
    (:func:`~ratilqr_tpu_torch.ops._build.first_widths`)."""
    return _build.first_widths(KERNEL, model_id, dtype, B_max)


def launch_candidate(tm, ins, entry=None) -> CandidateOut:
    """Launch kernel C on arguments prepared by :func:`candidate_layout`;
    ``entry`` is another build's C entry point of the same type (the
    shipped library's by default)."""
    (T1, n, Bn), T = ins[0].shape, ins[1].shape[0]
    dtype, device = ins[0].dtype, ins[0].device
    x_scratch = torch.empty((T1, n, Bn), dtype=dtype, device=device)
    value = torch.empty(Bn, dtype=dtype, device=device)
    m_fail = torch.empty(Bn, dtype=torch.bool, device=device)
    params = _build.params_array(tm.params)
    launch = entry or _build.entry(KERNEL, dtype)
    with torch.cuda.device(device):
        rc = launch(tm.model_id, Bn, T, params, *map(_build.ptr, ins),
                    *map(_build.ptr, (x_scratch, value, m_fail)),
                    _build.stream_of(value))
    _build.check(rc, KERNEL)
    _build.launch_counts[KERNEL] += 1
    return CandidateOut(value, m_fail)
