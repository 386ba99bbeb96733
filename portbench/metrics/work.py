"""The least work of a stage, frozen: bytes and arithmetic operations of one
call at ``(n, m, T, B)``, and the least time one H100 could take for them.

Copied from the program's ``kernel_check.kernel_work`` / ``bound_ms`` so
that a change to the program cannot change the yardstick.  Bytes count
each input read once and each output written once (a shared noise model
once for the bank); operations count the DP algebra of every step, a
multiply-add as 2, and not the model's own dynamics and cost, so the bound
stays a lower one.  A stage is named by what it computes:

- ``step``: the fused outer step, rollout + quadratization + optimizing DP
  (kernel B's work): ``x0, l, θ, μ`` in, ``x, L, dl, value`` and two flags
  out;
- ``candidate``: one line-search trial, closed-loop rollout + fold + folded
  evaluating DP (kernel C's work): ``x̄, l, L, θ, μ`` in, the value and one
  flag out.
"""
from __future__ import annotations

from typing import Tuple

# Peak rates of one H100 SXM (NVIDIA data sheet, 700 W): HBM3 bandwidth,
# and the FP32 / FP64 rates outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
ITEM_BYTES = {"float32": 4, "float64": 8}


def _mm(p: int, q: int, r: int) -> int:
    """Operations of a (p×q)(q×r) product."""
    return p * r * (2 * q - 1)


def _chol(n: int) -> int:
    return n * (n + 1) * (2 * n + 1) // 6


def _m_factor_ops(n: int) -> int:
    # W⁻¹ − θS, sym, factor, M⁻¹S (n solves), D
    return 2 * n * n + n * (n - 1) + _chol(n) + 2 * n ** 3 + 2 * n * n


def _risk_ops(n: int) -> int:
    # tr(WS), M⁻¹s⃗, s⃗ᵀM⁻¹s⃗, log det M and the scalar tail
    return 2 * n * n + 2 * n * n + (2 * n - 1) + (2 * n + 1) + 6


def dp_step_ops(n: int, m: int) -> int:
    """Operations of one optimizing DP step."""
    ops = _m_factor_ops(n)
    ops += _mm(n, n, n) + _mm(n, n, 1) + _mm(m, n, 1) + m        # DS, Ds⃗, g
    ops += 2 * _mm(m, n, n) + m * n                              # BᵀDS, G
    ops += _mm(m, n, m) + 2 * m * m + m * (m - 1)                # H
    ops += _chol(m) + 2 * m * m * (n + 1) + m * n + m            # L, dl
    ops += _mm(m, m, 1) + 2 * (2 * m - 1) + 5 + _risk_ops(n)     # s
    ops += _mm(n, n, 1) + 3 * _mm(n, m, 1) + 4 * n               # s⃗
    ops += (2 * _mm(n, n, n) + _mm(m, m, n) + 2 * _mm(n, m, n)   # S
            + 4 * n * n + n * (n - 1))
    return ops


def folded_step_ops(n: int) -> int:
    """Operations of one folded evaluating DP step."""
    return (_m_factor_ops(n) + _mm(n, n, n) + 2 * _mm(n, n, 1)
            + _risk_ops(n) + 2 + n + 2 * _mm(n, n, n) + n * n + n * (n - 1))


def fold_ops(n: int, m: int) -> int:
    """Operations of the closed-loop fold and its two policy evaluations
    per step."""
    return (_mm(n, m, 1) + 4 * _mm(n, m, n) + _mm(m, m, n) + n + 6 * n * n
            + n * (n - 1) + 2 * (n + 2 * m * n))


def stage_work(stage: str, n: int, m: int, T: int, B: int,
               dtype: str = "float32") -> Tuple[float, float]:
    """``(bytes, operations)`` of one call of ``stage`` on ``B`` lanes."""
    w = ITEM_BYTES[dtype]
    noise = T * (2 * n * n + 1)
    if stage == "step":
        lane = (n + T * m + 2                                   # x0, l, θ, μ
                + (T + 1) * n + T * (m * n + m) + 1)            # x, L, dl, v
        ops = dp_step_ops(n, m)
        flags = 2
    elif stage == "candidate":
        lane = (T + 1) * n + T * (m + m * n) + 2 + 1
        ops = fold_ops(n, m) + folded_step_ops(n)
        flags = 1
    else:
        raise ValueError(f"no work count for stage {stage!r}")
    return float(B * (lane * w + flags) + noise * w), float(B * T * ops)


def bound_s(stage: str, n: int, m: int, T: int, B: int,
            dtype: str = "float32") -> Tuple[float, str]:
    """The least time of one call: the larger of its bytes over the memory
    rate and its operations over the peak rate; returns ``(s, "bytes" or
    "operations")``."""
    nbytes, ops = stage_work(stage, n, m, T, B, dtype)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
