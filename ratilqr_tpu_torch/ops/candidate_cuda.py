"""Kernel C wrapper: one fused line-search trial on CUDA.

Counterpart of :mod:`ratilqr_tpu.ops.candidate_pallas` (both its stored and
its recompute variant, which compute the same value).
:func:`candidate_bank` launches ``csrc/candidate.cu`` for a bank on a CUDA
device and runs :func:`candidate_bank_plain` — ``approximate_folded``
followed by the folded evaluating core (``candidate_pallas.py:427-432``) —
for a bank on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ratilqr_tpu_torch.ops import _build
from ratilqr_tpu_torch.ops.approx import NoiseModel, approximate_folded
from ratilqr_tpu_torch.ops.riccati import _riccati_folded_core
from ratilqr_tpu_torch.ops.tile_model import device_model

Tensor = torch.Tensor
KERNEL = "candidate"


class CandidateOut(NamedTuple):
    value: Tensor   # (B,)
    m_fail: Tensor  # (B,) bool: neurotic breakdown


def candidate_bank_plain(problem, x_ref: Tensor, l_cand: Tensor, L: Tensor,
                         mu: Tensor, theta: Tensor,
                         noise: NoiseModel) -> CandidateOut:
    """Plain PyTorch version of the fused candidate evaluation."""
    folded = approximate_folded(problem, x_ref, l_cand, L, mu, noise)
    return CandidateOut(*_riccati_folded_core(folded, theta))


def candidate_bank(problem, x_ref: Tensor, l_cand: Tensor, L: Tensor,
                   mu: Tensor, theta: Tensor,
                   noise: NoiseModel) -> CandidateOut:
    """Evaluate a bank of candidates: closed-loop rollout of ``l_cand
    (B, T, m)`` under gains ``L (B, T, m, n)`` around ``x_ref (B, T+1, n)``,
    quadratize, fold with ``mu (B,)``, folded evaluating DP with ``theta
    (B,)``.  CUDA needs a problem whose tile model has a device model."""
    if x_ref.device.type == "cpu":
        return candidate_bank_plain(problem, x_ref, l_cand, L, mu, theta,
                                    noise)
    if x_ref.device.type != "cuda":
        raise NotImplementedError(f"no candidate kernel for device "
                                  f"{x_ref.device}")
    return _candidate_bank_cuda(problem, x_ref, l_cand, L, mu, theta, noise)


def _candidate_bank_cuda(problem, x_ref, l_cand, L, mu, theta, noise):
    tm = device_model(problem)
    Bn, T, m = l_cand.shape
    n = tm.n
    dtype, device = x_ref.dtype, x_ref.device
    code = _build.dtype_code(dtype)
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
    x_scratch = torch.empty((T + 1, n, Bn), dtype=dtype, device=device)
    value = torch.empty(Bn, dtype=dtype, device=device)
    m_fail = torch.empty(Bn, dtype=torch.bool, device=device)
    params = (tuple(tm.params) + (0.0,) * 4)[:4]
    lib = _build.library()
    with torch.cuda.device(device):
        rc = lib.ratilqr_candidate(code, tm.model_id, Bn, T, *params,
                                   *map(_build.ptr, ins),
                                   *map(_build.ptr, (x_scratch, value,
                                                     m_fail)),
                                   _build.stream_of(value))
    _build.check(rc, KERNEL)
    _build.launch_counts[KERNEL] += 1
    return CandidateOut(value, m_fail)
