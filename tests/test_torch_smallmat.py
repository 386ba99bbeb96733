"""Parity of the port's closed-form small-matrix algebra with the JAX
package's (``ratilqr_tpu.ops.smallmat``), in float64.

Same formulas in the same operation order, so agreement is to a few ulps:
rtol 1e-12.  ``chol_ok`` must agree exactly, including on indefinite
inputs and on a PSD matrix that is singular in its last pivot.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ratilqr_tpu.ops import smallmat as jsm  # noqa: E402
from ratilqr_tpu_torch.ops import smallmat as tsm  # noqa: E402

RTOL = dict(rtol=1e-12, atol=1e-13)
F64 = torch.float64


def _spd(rng, batch, n):
    X = rng.standard_normal(batch + (n, n))
    return X @ np.swapaxes(X, -1, -2) / n + 0.5 * np.eye(n)


def _both(fn_name, *arrays):
    j = getattr(jsm, fn_name)(*(jnp.asarray(a) for a in arrays))
    t = getattr(tsm, fn_name)(*(torch.tensor(np.array(a), dtype=F64)
                                for a in arrays))
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("n", [2, 3, 4])
def test_factor_and_solves_match_jax(n):
    rng = np.random.default_rng(n)
    M = _spd(rng, (5,), n)
    b = rng.standard_normal((5, n))
    Bmat = rng.standard_normal((5, n, 3))
    Lj = np.asarray(jsm.cholesky(jnp.asarray(M)))
    for name, args in (("cholesky", (M,)),
                       ("solve_triangular_lower", (Lj, b)),
                       ("solve_triangular_upper_T", (Lj, b)),
                       ("cho_solve_vec", (Lj, b)),
                       ("cho_solve_mat", (Lj, Bmat)),
                       ("cho_inverse", (Lj,)),
                       ("cho_logdet", (Lj,))):
        j, t = _both(name, *args)
        np.testing.assert_allclose(t, j, **RTOL, err_msg=name)
    # The factor reproduces M and the inverse inverts it.
    L = tsm.cholesky(torch.as_tensor(M))
    np.testing.assert_allclose((L @ L.transpose(-1, -2)).numpy(), M, **RTOL)
    np.testing.assert_allclose((tsm.cho_inverse(L) @ torch.as_tensor(M))
                               .numpy(), np.broadcast_to(np.eye(n), M.shape),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_products_match_jax(n):
    rng = np.random.default_rng(10 + n)
    A = rng.standard_normal((4, n, n + 1))
    Bm = rng.standard_normal((4, n + 1, 2))
    v = rng.standard_normal((4, n + 1))
    S = rng.standard_normal((4, n, n))
    for name, args in (("mm", (A, Bm)), ("mv", (A, v)), ("mt", (A,)),
                       ("sym", (S,))):
        j, t = _both(name, *args)
        np.testing.assert_allclose(t, j, **RTOL, err_msg=name)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_chol_ok_and_nan_on_failure_match_jax(n):
    rng = np.random.default_rng(20 + n)
    spd = _spd(rng, (), n)
    indefinite = spd - 2.0 * np.abs(np.linalg.eigvalsh(spd)).max() * np.eye(n)
    # PSD but singular with the zero pivot LAST: finite factor, rejected.
    last_singular = np.zeros((n, n))
    last_singular[:n - 1, :n - 1] = _spd(rng, (), n - 1)
    # Negative leading pivot: NaN from sqrt, rejected.
    neg_first = spd.copy()
    neg_first[0, 0] = -1.0
    M = np.stack([spd, indefinite, last_singular, neg_first])
    j, t = _both("cholesky", M)
    np.testing.assert_allclose(t, j, equal_nan=True, **RTOL)
    ok_j = np.asarray(jsm.chol_ok(jnp.asarray(j)))
    ok_t = tsm.chol_ok(torch.as_tensor(t)).numpy()
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_array_equal(ok_t, [True, False, False, False])
    assert np.all(np.isfinite(t[2])), "last-pivot-singular factor is finite"
    assert np.isnan(t[3]).any(), "a failed factor carries NaN"
