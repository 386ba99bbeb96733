"""The port's cartpole bank against the JAX package's (CPU, float64), held
against live JAX results.

  - the working cell, cold from x0 = (0.3, 0, 0.4, 0), θ = linspace(0,
    0.05, 8), T=20, in the default configuration and in the model-size
    path's (b) (fused step and fused candidate evaluation): ``failed`` and
    ``iterations`` equal, value rtol 1e-9, l atol 1e-8;
  - the JAX bench cell's start x0 = 0, the cartpole's fixed point, where
    θ > 0 lanes fail at iteration 0 (at T=20, those above a threshold): the
    same failure pattern;
  - the twin of ``tests/test_models_dims.py::test_solver_stack_at_
    dimension`` at (4, 1) and (12, 4), through the port's
    ``integrate_cost``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ratilqr_tpu import ILEQGConfig as JConfig  # noqa: E402
from ratilqr_tpu.models import cartpole as jcart  # noqa: E402
from ratilqr_tpu.solvers import ileqg as jileqg  # noqa: E402
from ratilqr_tpu_torch import (ILEQGConfig, integrate_cost,  # noqa: E402
                               make_batched_solver, rollout_open_loop, solve)
from ratilqr_tpu_torch.models import cartpole, quadrotor  # noqa: E402

T = 20
THETAS = np.linspace(0.0, 0.05, 8)
X0 = np.array([0.3, 0.0, 0.4, 0.0])
# The model-size path's configuration (b) (chip_smoke.MODEL_CONFIGS).
CONFIG_B = dict(eps_history_cap=0, adaptive_eps_init=True,
                fused_candidate_eval=True, fused_step_optimize=True)
CONFIGS = {"default": {}, "b": CONFIG_B}


@pytest.fixture(scope="module")
def jax_problem():
    return jcart(N=T)


def _both(jax_problem, flags, x0):
    u0 = np.zeros((T, 1))
    want = jileqg.make_batched_solver(jax_problem, JConfig(**flags))(
        x0, u0, THETAS)
    got = make_batched_solver(cartpole(N=T, device="cpu"),
                              ILEQGConfig(**flags))(x0, u0, THETAS)
    return got, want


@pytest.mark.parametrize("name", list(CONFIGS))
def test_working_cell_matches_jax(jax_problem, name):
    got, want = _both(jax_problem, CONFIGS[name], X0)
    assert not bool(got.failed.any())
    assert got.failed.tolist() == np.asarray(want.failed).tolist()
    assert got.iterations.tolist() == np.asarray(want.iterations).tolist()
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(got.l.numpy(), np.asarray(want.l), rtol=0,
                               atol=1e-8)


def test_fixed_point_start_fails_like_jax(jax_problem):
    """x0 = 0, u0 = 0 is the cartpole's fixed point: the open-loop value
    Hessian of the upright pendulum grows until M = W⁻¹ − θS is no longer
    PSD, so lanes with large enough θ fail at initialization."""
    got, want = _both(jax_problem, {}, np.zeros(4))
    failed = np.asarray(want.failed)
    assert failed.any() and not failed[0], "the fixture must mix the lanes"
    assert got.failed.tolist() == failed.tolist()
    assert got.iterations.tolist() == np.asarray(want.iterations).tolist()
    assert (got.iterations[got.failed] == 0).all()
    ok = ~failed
    np.testing.assert_allclose(got.value.numpy()[ok],
                               np.asarray(want.value)[ok], rtol=1e-9, atol=0)


@pytest.mark.parametrize("mk,n,m,x0", [
    (cartpole, 4, 1, [0.3, 0.0, 0.4, 0.0]),
    (quadrotor, 12, 4, [0.0] * 12),
], ids=["cartpole", "quadrotor"])
def test_solver_stack_at_dimension(mk, n, m, x0):
    prob = mk(N=T, device="cpu")
    x0 = torch.tensor(x0, dtype=torch.float64)
    u0 = torch.zeros((T, m), dtype=torch.float64)
    res = solve(prob, ILEQGConfig(iter_max=25), x0, u0, 0.0)
    assert not bool(res.failed)
    assert np.isfinite(float(res.value))
    assert res.L.shape == (T, m, n)
    # the solver reduced the cost below the zero-control rollout cost
    x_zero = rollout_open_loop(prob, x0[None], u0[None])
    assert float(res.value) < float(integrate_cost(prob, x_zero,
                                                   u0[None])[0]) + 1e-9
