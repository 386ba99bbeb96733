"""Closed-form small-matrix linear algebra (unrolled, branch-free).

Counterpart of :mod:`ratilqr_tpu.ops.smallmat`: the same formulas in the
same operation order, over arbitrary leading batch axes with the small
matrix in the LAST axes.  They are also the algebra of the CUDA kernels
(``csrc/smallmat.cuh``), which divide by the pivot exactly as here.

The factor, products and triangular solves unroll over ONE index (the
column of the factor, the summation index, the row of a solve) and run
every element of that column, row or result at once, in the same
per-element order: an n x n product is 2n tensor operations, not n³, so the
eager plain path stays usable at n = 12.

A failed factorization (matrix not positive definite) shows up as NaN —
``sqrt`` of a negative pivot — and :func:`chol_ok` requires every pivot to
be finite AND strictly positive (Julia ``isposdef``).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def cholesky(M: Tensor) -> Tensor:
    """Lower-triangular Cholesky factor of ``M`` (..., n, n); NaN on
    failure.  Column by column: every entry of column ``j`` at once."""
    n = M.shape[-1]
    cols = []
    for j in range(n):
        acc = M[..., j:, j]
        for k in range(j):
            acc = acc - cols[k][..., j - k:] * cols[k][..., j - k, None]
        pivot = torch.sqrt(acc[..., :1])
        cols.append(torch.cat([pivot, acc[..., 1:] / pivot], -1))
    z = torch.zeros_like(M[..., 0, :1])
    return torch.stack([torch.cat([z.expand(M.shape[:-2] + (j,)), c], -1)
                        for j, c in enumerate(cols)], -1)


def _lower(L: Tensor, B: Tensor) -> Tensor:
    """Solve ``L Y = B`` for ``B`` (..., n, p), row by row."""
    y = []
    for i in range(L.shape[-1]):
        acc = B[..., i, :]
        for k in range(i):
            acc = acc - L[..., i, k, None] * y[k]
        y.append(acc / L[..., i, i, None])
    return torch.stack(y, -2)


def _upper_T(L: Tensor, Y: Tensor) -> Tensor:
    """Solve ``Lᵀ X = Y`` for ``Y`` (..., n, p), row by row from the
    last."""
    n = L.shape[-1]
    x = [None] * n
    for i in reversed(range(n)):
        acc = Y[..., i, :]
        for k in range(i + 1, n):
            acc = acc - L[..., k, i, None] * x[k]
        x[i] = acc / L[..., i, i, None]
    return torch.stack(x, -2)


def solve_triangular_lower(L: Tensor, b: Tensor) -> Tensor:
    """Solve ``L y = b`` with ``L`` lower-triangular (..., n, n)."""
    return _lower(L, b[..., None])[..., 0]


def solve_triangular_upper_T(L: Tensor, y: Tensor) -> Tensor:
    """Solve ``Lᵀ x = y`` with ``L`` lower-triangular (..., n, n)."""
    return _upper_T(L, y[..., None])[..., 0]


def cho_solve_vec(L: Tensor, b: Tensor) -> Tensor:
    """``M⁻¹ b`` from the Cholesky factor ``L`` of ``M``; ``b`` (..., n)."""
    return solve_triangular_upper_T(L, solve_triangular_lower(L, b))


def cho_solve_mat(L: Tensor, B: Tensor) -> Tensor:
    """``M⁻¹ B`` for ``B`` (..., n, p): every column's solve at once."""
    return _upper_T(L, _lower(L, B))


def cho_inverse(L: Tensor) -> Tensor:
    """``M⁻¹`` from the Cholesky factor ``L`` of ``M`` (..., n, n)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return cho_solve_mat(L, eye.expand(L.shape))


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
    """Small-matrix product ``A @ B`` for (..., p, q) × (..., q, r) as
    elementwise multiply-adds in summation-index order."""
    acc = A[..., :, 0, None] * B[..., None, 0, :]
    for k in range(1, A.shape[-1]):
        acc = acc + A[..., :, k, None] * B[..., None, k, :]
    return acc


def mv(A: Tensor, v: Tensor) -> Tensor:
    """Small matrix-vector product for (..., p, q) × (..., q)."""
    acc = A[..., :, 0] * v[..., 0, None]
    for k in range(1, A.shape[-1]):
        acc = acc + A[..., :, k] * v[..., k, None]
    return acc


def mt(A: Tensor) -> Tensor:
    """Transpose of the trailing two dims."""
    return A.transpose(-1, -2)
