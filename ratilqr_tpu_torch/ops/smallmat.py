"""Closed-form small-matrix linear algebra (unrolled, branch-free).

Counterpart of :mod:`ratilqr_tpu.ops.smallmat`: the same formulas in the
same operation order, over arbitrary leading batch axes with the small
matrix in the LAST axes.  They are also the algebra of the CUDA kernels
(``csrc/smallmat.cuh``), which divide by the pivot exactly as here.

A failed factorization (matrix not positive definite) shows up as NaN —
``sqrt`` of a negative pivot — and :func:`chol_ok` requires every pivot to
be finite AND strictly positive (Julia ``isposdef``).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def cholesky(M: Tensor) -> Tensor:
    """Lower-triangular Cholesky factor of ``M`` (..., n, n); NaN on
    failure."""
    n = M.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            acc = M[..., i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(acc) if i == j else acc / L[j][j]
    z = torch.zeros_like(M[..., 0, 0])
    rows = [torch.stack([L[i][j] if j <= i else z for j in range(n)], -1)
            for i in range(n)]
    return torch.stack(rows, -2)


def solve_triangular_lower(L: Tensor, b: Tensor) -> Tensor:
    """Solve ``L y = b`` with ``L`` lower-triangular (..., n, n)."""
    n = L.shape[-1]
    y = [None] * n
    for i in range(n):
        acc = b[..., i]
        for k in range(i):
            acc = acc - L[..., i, k] * y[k]
        y[i] = acc / L[..., i, i]
    return torch.stack(y, -1)


def solve_triangular_upper_T(L: Tensor, y: Tensor) -> Tensor:
    """Solve ``Lᵀ x = y`` with ``L`` lower-triangular (..., n, n)."""
    n = L.shape[-1]
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[..., i]
        for k in range(i + 1, n):
            acc = acc - L[..., k, i] * x[k]
        x[i] = acc / L[..., i, i]
    return torch.stack(x, -1)


def cho_solve_vec(L: Tensor, b: Tensor) -> Tensor:
    """``M⁻¹ b`` from the Cholesky factor ``L`` of ``M``; ``b`` (..., n)."""
    return solve_triangular_upper_T(L, solve_triangular_lower(L, b))


def cho_solve_mat(L: Tensor, B: Tensor) -> Tensor:
    """``M⁻¹ B`` column by column; ``B`` (..., n, p)."""
    return torch.stack([cho_solve_vec(L, B[..., :, j])
                        for j in range(B.shape[-1])], -1)


def cho_inverse(L: Tensor) -> Tensor:
    """``M⁻¹`` from the Cholesky factor ``L`` of ``M`` (..., n, n)."""
    n = L.shape[-1]
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    return torch.stack([cho_solve_vec(L, eye[:, j].expand(L.shape[:-1]))
                        for j in range(n)], -1)


def _diag(L: Tensor) -> Tensor:
    return torch.stack([L[..., i, i] for i in range(L.shape[-1])], -1)


def cho_logdet(L: Tensor) -> Tensor:
    """``log det M = 2 Σ log L_ii`` from the Cholesky factor."""
    return 2.0 * torch.log(_diag(L)).sum(-1)


def chol_ok(L: Tensor) -> Tensor:
    """Positive-definiteness test on the Cholesky factor: every pivot
    finite and strictly positive (``isposdef``, ``ileqg.jl:366,372``).  A
    singular PSD matrix whose zero pivot is the last one has a finite
    factor and is still rejected."""
    d = _diag(L)
    return (torch.isfinite(d) & (d > 0)).all(-1)


def sym(M: Tensor) -> Tensor:
    return 0.5 * (M + M.transpose(-1, -2))


def mm(A: Tensor, B: Tensor) -> Tensor:
    """Unrolled small-matrix product ``A @ B`` for (..., p, q) × (..., q, r)
    as elementwise multiply-adds in index order."""
    p, q = A.shape[-2], A.shape[-1]
    r = B.shape[-1]
    rows = [torch.stack([sum(A[..., i, k] * B[..., k, j] for k in range(q))
                         for j in range(r)], -1) for i in range(p)]
    return torch.stack(rows, -2)


def mv(A: Tensor, v: Tensor) -> Tensor:
    """Unrolled small matrix-vector product for (..., p, q) × (..., q)."""
    p, q = A.shape[-2], A.shape[-1]
    return torch.stack([sum(A[..., i, k] * v[..., k] for k in range(q))
                        for i in range(p)], -1)


def mt(A: Tensor) -> Tensor:
    """Transpose of the trailing two dims."""
    return A.transpose(-1, -2)
