"""The port's MPC driver against the JAX driver (CPU, float64): RAT iLQR
re-planning through ``MPCDriver`` with a noiseless world and the same
injected θ draws on both sides (tests/test_torch_ratilqr.py) takes the same
steps; plus unit cases of the warm start, the affine policy and the
Gaussian simulator.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import ratilqr_tpu as J  # noqa: E402
from ratilqr_tpu import mpc as jmpc  # noqa: E402
from ratilqr_tpu.models import lqr_problem as jlqr  # noqa: E402
from ratilqr_tpu.solvers import ratilqr as jrat  # noqa: E402
from ratilqr_tpu_torch import MPCDriver, RATiLQRSolver, convert  # noqa: E402
from ratilqr_tpu_torch.models import lqr_problem as tlqr  # noqa: E402
from ratilqr_tpu_torch.mpc import (affine_policy_control,  # noqa: E402
                                   make_gaussian_simulator, shift_warm_start)
from ratilqr_tpu_torch.solvers import ratilqr as trat  # noqa: E402
from test_torch_ratilqr import (_fake_draw_jax,  # noqa: E402
                                _fake_draw_torch)

T = 8


@pytest.fixture()
def injected_sampler(monkeypatch):
    monkeypatch.setattr(jrat, "get_positive_samples", _fake_draw_jax)
    monkeypatch.setattr(trat, "get_positive_samples", _fake_draw_torch)


def test_rat_ilqr_mpc_matches_jax(injected_sampler):
    jprob, tprob = jlqr(N=T, noise=0.01), tlqr(N=T, noise=0.01, device="cpu")
    jcfg = J.CrossEntropyConfig(num_samples=4, num_elite=2, iter_max=2,
                                mu_init=0.1, sigma_init=0.05,
                                ileqg=J.ILEQGConfig(iter_max=20))
    tcfg = convert.ce_config_from_dict(convert.config_to_dict(jcfg))
    jsolver = jrat.RATiLQRSolver(jprob, jcfg)
    tsolver = RATiLQRSolver(tprob, tcfg)
    x0, u0 = np.array([2.0, -1.0]), np.zeros((T, 2))
    jsteps = jmpc.MPCDriver(
        problem=jprob,
        plan=lambda x, u, key: jsolver.solve(x, u, key, kl_bound=1.0),
        simulate=lambda k, x, u, key: jprob.f(x, u)).run(
            jnp.asarray(x0), jnp.asarray(u0), jax.random.key(0), num_steps=3)
    tsteps = MPCDriver(
        problem=tprob,
        plan=lambda x, u, g: tsolver.solve(x, u, g, kl_bound=1.0),
        simulate=lambda k, x, u, g: tprob.f(x, u)).run(
            torch.tensor(x0), torch.tensor(u0), torch.Generator(),
            num_steps=3)
    assert len(tsteps) == 3
    for k, (ts, js) in enumerate(zip(tsteps, jsteps)):
        for name in ("x", "u", "value", "info"):
            np.testing.assert_allclose(
                np.asarray(getattr(ts, name)), np.asarray(getattr(js, name)),
                rtol=1e-9, atol=1e-12, err_msg=f"{name} step {k}")
        assert ts.plan_time_s > 0 and float(ts.info) > 0
    assert float(tsolver.state.mu_init) > tcfg.mu_init, \
        "the warm start must carry across re-plans"


def test_shift_warm_start():
    s = shift_warm_start(torch.arange(6.0).reshape(3, 2))
    assert s.tolist() == [[2.0, 3.0], [4.0, 5.0], [4.0, 5.0]]


def test_affine_policy_feedback_correction():
    u = affine_policy_control(torch.tensor([3.0, 2.0]),
                              torch.tensor([[2.0, 2.0]]),
                              torch.tensor([[1.0, 0.0]]),
                              torch.tensor([[[0.5, 0.0], [0.0, 0.5]]]))
    assert u.tolist() == [1.5, 0.0]


def test_gaussian_simulator_is_seeded():
    prob = tlqr(N=T, noise=0.01, device="cpu")
    sim = make_gaussian_simulator(prob)
    x, u = torch.tensor([1.0, -1.0], dtype=torch.float64), torch.zeros(
        2, dtype=torch.float64)
    a = sim(0, x, u, torch.Generator().manual_seed(5))
    b = sim(0, x, u, torch.Generator().manual_seed(5))
    c = sim(0, x, u, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    noise = torch.stack([sim(0, x, u, g) - prob.f(x, u) for g in [
        torch.Generator().manual_seed(0)] for _ in range(2000)])
    torch.testing.assert_close(noise.std(0), torch.full(
        (2,), 0.1, dtype=torch.float64), rtol=0.1, atol=0)
