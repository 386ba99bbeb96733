"""θ keeps the solve's dtype: a Python float or list θ reaches a float64
solve as float64, never rounded through torch's default float32 (CPU,
float64).

The port's single solve, its θ-bank and RAT iLQR's cost function must give
bit for bit the result of an f64-tensor θ, and agree with the JAX package
(which takes ``jnp.asarray(theta, x0.dtype)``) to rtol 1e-12.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import ratilqr_tpu as J  # noqa: E402
from ratilqr_tpu.models import unicycle as junicycle  # noqa: E402
from ratilqr_tpu_torch.config import (CrossEntropyConfig,  # noqa: E402
                                      ILEQGConfig)
from ratilqr_tpu_torch.models import unicycle as tunicycle  # noqa: E402
from ratilqr_tpu_torch.solvers import ileqg, ratilqr  # noqa: E402

T = 30
F64 = torch.float64
TPROB = tunicycle(N=T, device="cpu")
CONFIG = ILEQGConfig(iter_max=30)
X0, U0 = np.zeros(3), np.zeros((T, 2))
THETA, THETAS = 0.01, [0.01, 0.02]
FIELDS = ("x", "l", "L", "value", "iterations", "failed")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops run faster on one thread than on many,
    and the suite runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_bitwise(a, b, tag):
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), (
            f"{name} {tag}")


def test_single_solve_python_float_theta():
    x0, u0 = torch.tensor(X0), torch.tensor(U0)
    got = ileqg.solve(TPROB, CONFIG, x0, u0, THETA)
    ref = ileqg.solve(TPROB, CONFIG, x0, u0, torch.tensor(THETA, dtype=F64))
    assert_bitwise(got, ref, "float θ vs f64 tensor θ")
    assert got.value.dtype == F64
    jres = J.ileqg_solve(junicycle(N=T), J.ILEQGConfig(iter_max=30),
                         jnp.asarray(X0), jnp.asarray(U0), THETA)
    np.testing.assert_allclose(float(got.value), float(jres.value),
                               rtol=1e-12)
    np.testing.assert_allclose(got.l.numpy(), np.asarray(jres.l),
                               rtol=0, atol=1e-10)


def test_bank_python_list_theta():
    bank = ileqg.make_batched_solver(TPROB, CONFIG)
    got = bank(torch.tensor(X0), torch.tensor(U0), THETAS)
    ref = bank(torch.tensor(X0), torch.tensor(U0),
               torch.tensor(THETAS, dtype=F64))
    assert_bitwise(got, ref, "list θ vs f64 tensor θ")
    jbank = J.make_batched_solver(junicycle(N=T), J.ILEQGConfig(iter_max=30))
    jres = jbank(jnp.asarray(X0), jnp.asarray(U0), jnp.asarray(THETAS))
    np.testing.assert_allclose(got.value.numpy(), np.asarray(jres.value),
                               rtol=1e-12)


def test_cost_fn_python_list_theta():
    cost_fn = ratilqr.make_cost_fn(TPROB, CrossEntropyConfig(ileqg=CONFIG))
    got = cost_fn(torch.tensor(X0), torch.tensor(U0), THETAS, 0.05)
    ref = cost_fn(torch.tensor(X0), torch.tensor(U0),
                  torch.tensor(THETAS, dtype=F64), 0.05)
    assert got.dtype == F64
    assert torch.equal(got, ref)
