"""PETS and the generative side in the port (``solvers/pets.py``,
``problems.GenerativeProblem``, ``models.gmm_integrator``, the noisy and
generative rollouts) against the JAX package (CPU, float64).

torch's and JAX's random streams differ, so the draws are injected: the
control draws of ``sample_control_sequences`` (JAX's monkeypatched, as the
RAT iLQR tests patch ``get_positive_samples``) and the standard normals of
the noisy rollouts (``jax.random.normal(key, (N, n))``).  The PETS fixture's
cost ``Σ|u| + 1`` does not depend on the trajectory noise, so μ and Σ must
agree to 1e-12 after 5 generations.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import ratilqr_tpu as J  # noqa: E402
from ratilqr_tpu.models import gmm_integrator as jgmm  # noqa: E402
from ratilqr_tpu.models import unicycle as junicycle  # noqa: E402
from ratilqr_tpu.problems import GenerativeProblem as JGen  # noqa: E402
from ratilqr_tpu.solvers import nelder_mead as jnm  # noqa: E402
from ratilqr_tpu.solvers import pets as jpets  # noqa: E402
from ratilqr_tpu_torch import convert  # noqa: E402
from ratilqr_tpu_torch.config import PETSConfig  # noqa: E402
from ratilqr_tpu_torch.models import gmm_integrator  # noqa: E402
from ratilqr_tpu_torch.models import unicycle as tunicycle  # noqa: E402
from ratilqr_tpu_torch.ops import rollout  # noqa: E402
from ratilqr_tpu_torch.solvers import nelder_mead as tnm  # noqa: E402
from ratilqr_tpu_torch.solvers import pets as tpets  # noqa: E402
from ratilqr_tpu_torch.tests_support import (  # noqa: E402,F401
    pets_uniform_problem, uniform_problem)

N, M = 20, 2
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops run faster on one thread than on many,
    and the suite runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_uniform_problem():
    """``ratilqr_tpu.tests_support.pets_uniform_problem``."""
    def f_stochastic(x, u, key, use_true_model=False):
        return x + u + jax.random.uniform(key, x.shape, dtype=x.dtype)

    return JGen(f_stochastic=f_stochastic,
                c=lambda k, x, u: jnp.sum(jnp.abs(u)),
                h=lambda x: jnp.asarray(1.0, x.dtype), N=N)


def initial(mu_scale=0.0):
    mu = mu_scale * np.ones((N, M))
    sigma = np.repeat(np.eye(M)[None], N, 0)
    return mu, sigma


def configs(**kw):
    jcfg = J.PETSConfig(**kw)
    tcfg = convert.pets_config_from_dict(convert.config_to_dict(jcfg))
    assert tcfg == PETSConfig(**kw)
    return jcfg, tcfg


def test_sample_control_sequences_injected_z():
    mu = np.linspace(-1.0, 1.0, N * M).reshape(N, M)
    sigma = np.repeat(np.array([[2.0, 0.3], [0.3, 0.5]])[None], N, 0)
    key = jax.random.key(1)
    ref = jpets.sample_control_sequences(jpets.init_state(mu, sigma), key, 7)
    z = np.array(jax.random.normal(key, (7, N, M), dtype=jnp.float64))
    got = tpets.sample_control_sequences(tpets.init_state(mu, sigma), None,
                                         7, z=z)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    drawn = tpets.sample_control_sequences(
        tpets.init_state(mu, sigma), torch.Generator().manual_seed(0), 7)
    assert drawn.shape == (7, N, M) and drawn.dtype == F64


@pytest.mark.parametrize("costs", [
    [3.0, 1.0, 2.0, 1.0, 5.0, 1.0, 0.5, 2.0],
    [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
    [4.0, 3.0, 3.0, 2.0, 9.0, 2.0, 3.0, 8.0]])
def test_elite_samples_ties_to_lower_index(costs):
    us = np.arange(8 * N * M, dtype=float).reshape(8, N, M)
    _, jidx = jpets.get_elite_samples(jnp.asarray(us), jnp.asarray(costs), 4)
    elites, idx = tpets.get_elite_samples(torch.tensor(us),
                                          torch.tensor(costs), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy(),
                                  np.argsort(costs, kind="stable")[:4])
    np.testing.assert_array_equal(elites.numpy(), us[idx.numpy()])


def test_compute_new_distribution():
    mu, sigma = initial(0.3)
    elites = np.random.default_rng(3).normal(size=(5, N, M))
    for s in (0.1, 0.0, 1.0):
        ref = jpets.compute_new_distribution(
            jpets.init_state(mu, sigma), jnp.asarray(elites), s)
        got = tpets.compute_new_distribution(
            tpets.init_state(mu, sigma), torch.tensor(elites), s)
        np.testing.assert_allclose(got.mu.numpy(), np.asarray(ref.mu),
                                   rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(got.sigma.numpy(), np.asarray(ref.sigma),
                                   rtol=1e-12, atol=1e-15)


def test_compute_cost_uniform_problem(pets_uniform_problem):
    """The cost ignores the trajectory noise: ``Σ|u| + 1`` exactly, as
    JAX's under any key (``pets_test.jl:52-63``)."""
    _, tcfg = configs(num_control_samples=6, num_trajectory_samples=4)
    us = np.random.default_rng(1).normal(size=(6, N, M))
    got = tpets.compute_cost(pets_uniform_problem, tcfg, torch.zeros(2),
                             torch.tensor(us),
                             torch.Generator().manual_seed(2))
    expected = np.abs(us).sum((1, 2)) + 1.0
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-12)
    jcfg, _ = configs(num_control_samples=6, num_trajectory_samples=4)
    ref = jpets.compute_cost(jax_uniform_problem(), jcfg, jnp.zeros(2),
                             jnp.asarray(us), jax.random.key(2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)


def test_five_generations_match_jax(monkeypatch, pets_uniform_problem):
    """Five generations with the same control draws in both packages:
    JAX's ``pets.step`` generation by generation with its sampler
    patched, the port's ``step`` with ``z`` supplied."""
    jcfg, tcfg = configs(num_control_samples=24, num_trajectory_samples=3,
                         num_elite=5, iter_max=5, smoothing_factor=0.1)
    zs = np.random.default_rng(7).normal(size=(5, 24, N, M))
    draws = iter(zs)

    def injected(state, key, num_samples):
        chol = jnp.linalg.cholesky(state.sigma)
        z = jnp.asarray(next(draws))
        return state.mu[None] + jnp.einsum("nij,knj->kni", chol, z)

    monkeypatch.setattr(jpets, "sample_control_sequences", injected)
    mu, sigma = initial(0.5)
    jstate = jpets.init_state(jnp.asarray(mu), jnp.asarray(sigma))
    tstate = tpets.init_state(torch.tensor(mu), torch.tensor(sigma))
    gen = torch.Generator().manual_seed(0)
    for g in range(5):
        jstate = jpets.step(jax_uniform_problem(), jcfg, jnp.zeros(2),
                            jstate, jax.random.key(g))
        tstate = tpets.step(pets_uniform_problem, tcfg, torch.zeros(2),
                            tstate, gen, z=torch.tensor(zs[g]))
        np.testing.assert_allclose(tstate.mu.numpy(), np.asarray(jstate.mu),
                                   rtol=0, atol=1e-12, err_msg=f"μ gen {g}")
        np.testing.assert_allclose(tstate.sigma.numpy(),
                                   np.asarray(jstate.sigma), rtol=0,
                                   atol=1e-12, err_msg=f"Σ gen {g}")
    assert tstate.iter_current == int(jstate.iter_current) == 5


def test_solve_shrinks_control_cost():
    """``solve`` with the port's own draws: with ``c = Σ|u|`` the optimal
    control is 0, so CEM shrinks ``|μ|`` (``tests/test_pets.py``)."""
    _, tcfg = configs(num_control_samples=40, num_trajectory_samples=4,
                      num_elite=8, iter_max=15)
    mu, sigma = initial(0.5)
    solver = tpets.PETSSolver(uniform_problem(device="cpu"),
                              torch.tensor(mu), torch.tensor(sigma), tcfg)
    mu_opt, sigma_opt = solver.solve(torch.zeros(2),
                                     torch.Generator().manual_seed(7))
    assert mu_opt.shape == (N, M) and sigma_opt.shape == (N, M, M)
    assert float(mu_opt.abs().mean()) < 0.5


def test_noisy_rollouts_match_jax():
    """The noisy rollouts fed the z of ``jax.random.normal(key, (N, n))``
    against JAX with that key."""
    T = 12
    jprob = junicycle(N=T, noise=0.05)
    tprob = tunicycle(N=T, noise=0.05, device="cpu")
    rng = np.random.default_rng(5)
    x0 = np.array([0.2, -0.1, 0.3])
    u = rng.normal(size=(T, 2))
    L = 0.1 * rng.normal(size=(T, 2, 3))
    key = jax.random.key(11)
    z = np.array(jax.random.normal(key, (T, 3), dtype=jnp.float64))
    ref = J.rollout_open_loop_noisy(jprob, jnp.asarray(x0), jnp.asarray(u),
                                    key)
    got = rollout.rollout_open_loop_noisy(
        tprob, torch.tensor(x0)[None], torch.tensor(u)[None],
        z=torch.tensor(z)[None])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    x_ref = np.asarray(J.rollout_open_loop(jprob, jnp.asarray(x0),
                                           jnp.asarray(u)))
    jx, ju = J.rollout_feedback_noisy(jprob, jnp.asarray(x_ref),
                                      jnp.asarray(u), jnp.asarray(L), key)
    tx, tu = rollout.rollout_feedback_noisy(
        tprob, torch.tensor(x_ref)[None], torch.tensor(u)[None],
        torch.tensor(L)[None], z=torch.tensor(z)[None])
    np.testing.assert_allclose(tx[0].numpy(), np.asarray(jx), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(tu[0].numpy(), np.asarray(ju), rtol=0,
                               atol=1e-12)
    # Drawn from a generator: one independent draw a lane.
    drawn = rollout.rollout_open_loop_noisy(
        tprob, torch.tensor(x0).expand(4, 3), torch.tensor(u).expand(4, T, 2),
        torch.Generator().manual_seed(0))
    assert drawn.shape == (4, T + 1, 3)
    assert len({tuple(drawn[i, -1].tolist()) for i in range(4)}) == 4


@pytest.mark.parametrize("true_model,mean,var", [(False, 0.0, 0.5),
                                                 (True, 0.5, 1.0)])
def test_gmm_noise_moments(true_model, mean, var):
    """One step of ``gmm_integrator`` from x = 0, u = 0 over a bank of
    independent lanes: the noise's mean and variance within 5 standard
    errors of N(0, 0.5 I) (internal model) and 0.5·N(0, 0.5 I) + 0.5·N(1,
    I) (true model: mean 0.5, variance 0.5·0.5 + 0.5·2 − 0.25 = 1)."""
    prob = gmm_integrator(N=3, device="cpu")
    B = 200_000
    x = torch.zeros((B, 2), dtype=F64)
    noise = prob.draw_noise(torch.Generator().manual_seed(3), x, true_model)
    w = rollout.rollout_generative(prob, x, torch.zeros((B, 1, 2),
                                                        dtype=F64),
                                   use_true_model=true_model,
                                   noise=[noise])[0][:, 1].numpy()
    # The JAX model's step with its own draws has the same moments.
    jprob = jgmm(N=3)
    keys = jax.random.split(jax.random.key(4), 50_000)
    jw = np.asarray(jax.vmap(lambda k: jprob.f_stochastic(
        jnp.zeros(2), jnp.zeros(2), k, true_model))(keys))
    for sample in (w, jw):
        for d in range(2):
            wd = sample[:, d]
            m, v = wd.mean(), wd.var(ddof=1)
            m4 = np.mean((wd - m) ** 4)
            se_m, se_v = np.sqrt(v / wd.size), np.sqrt((m4 - v ** 2) / wd.size)
            assert abs(m - mean) < 5 * se_m, (d, m)
            assert abs(v - var) < 5 * se_v, (d, v)


def test_gmm_pets_solve_runs_both_models():
    """``gmm_integrator`` through PETS under both models; the generator
    draws every lane's noise outside ``vmap``."""
    prob = gmm_integrator(N=8, device="cpu")
    _, tcfg = configs(num_control_samples=16, num_trajectory_samples=4,
                      num_elite=4, iter_max=2)
    state = tpets.init_state(torch.zeros((8, 2), dtype=F64),
                             torch.eye(2, dtype=F64).expand(8, 2, 2))
    outs = [tpets.solve(prob, tcfg, torch.zeros(2), state,
                        torch.Generator().manual_seed(0), true_model)
            for true_model in (False, True)]
    for out in outs:
        assert out.iter_current == 2
        assert bool(torch.isfinite(out.mu).all())
        assert bool(torch.isfinite(out.sigma).all())
    assert not torch.equal(outs[0].mu, outs[1].mu)


def test_convert_round_trips():
    """``NMState`` and ``PETSState`` cross between the packages through
    ``convert`` field for field (``None`` costs kept)."""
    fresh = tnm.init_state(tnm.NelderMeadConfig())
    d = convert.nm_state_to_numpy(fresh)
    assert d["c_high"] is None and d["c_low"] is None
    assert convert.nm_state_from_numpy(d) == fresh
    jstate = jnm.NMState(theta_high_init=jnp.asarray(2.5),
                         theta_low_init=jnp.asarray(1e-8),
                         theta_high=jnp.asarray(1.25),
                         theta_low=jnp.asarray(3e-3),
                         c_high=jnp.asarray(1.07), c_low=jnp.asarray(1.05),
                         iter_current=jnp.asarray(4))
    got = convert.nm_state_from_numpy(convert.nm_state_to_numpy(jstate))
    assert got == tnm.NMState(2.5, 1e-8, 1.25, 3e-3, 1.07, 1.05, 4)
    assert convert.nm_state_to_numpy(got).keys() == set(jnm.NMState._fields)

    mu, sigma = initial(0.2)
    jp = jpets.init_state(jnp.asarray(mu), jnp.asarray(sigma))._replace(
        iter_current=jnp.asarray(3, jnp.int32))
    tp = convert.pets_state_from_numpy(convert.pets_state_to_numpy(jp),
                                       device="cpu")
    np.testing.assert_array_equal(tp.mu.numpy(), mu)
    np.testing.assert_array_equal(tp.sigma.numpy(), sigma)
    assert tp.iter_current == 3 and tp.mu.dtype == F64
    back = convert.pets_state_to_numpy(tp)
    assert set(back) == set(jpets.PETSState._fields)
    np.testing.assert_array_equal(back["sigma"], sigma)
