"""Closed-loop episodes and seed-batched fleets in the port
(``ratilqr_tpu_torch/mpc_episode.py``, ``solvers/ratilqr_jit.py``)
against the port's ``MPCDriver`` and against JAX's ``mpc_episode``
(CPU, float64).

The port's randomness is one ``torch.Generator`` a seed, used by the plan
and then by the simulator, as in ``MPCDriver``: an episode must reproduce
the driver with that generator at rtol 1e-12.  torch's and JAX's streams
differ, so against JAX the world's noise is a seeded numpy table ``w[k]``
on both sides (``x⁺ = f(x, u) + w[k]``), and the solvers' draws are
injected: RAT iLQR's θ (tests/test_torch_ratilqr.py) and PETS's control
draws.  JAX's solvers are jitted with the problem static, so each JAX case
builds a fresh problem object: a trace cached with the real sampler is
never reused.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import ratilqr_tpu as J  # noqa: E402
from ratilqr_tpu import mpc_episode as jme  # noqa: E402
from ratilqr_tpu.models import lqr_problem as jlqr  # noqa: E402
from ratilqr_tpu.problems import GenerativeProblem as JGen  # noqa: E402
from ratilqr_tpu.solvers import nelder_mead_jit as jnmj  # noqa: E402
from ratilqr_tpu.solvers import pets as jpets  # noqa: E402
from ratilqr_tpu.solvers import ratilqr as jrat  # noqa: E402
from ratilqr_tpu.solvers import ratilqr_jit as jratj  # noqa: E402
from ratilqr_tpu_torch import MPCDriver, convert  # noqa: E402
from ratilqr_tpu_torch import mpc as tmpc  # noqa: E402
from ratilqr_tpu_torch import mpc_episode as tme  # noqa: E402
from ratilqr_tpu_torch.config import (CrossEntropyConfig,  # noqa: E402
                                      ILEQGConfig)
from ratilqr_tpu_torch.models import lqr_problem as tlqr  # noqa: E402
from ratilqr_tpu_torch.solvers import ileqg as tileqg  # noqa: E402
from ratilqr_tpu_torch.solvers import nelder_mead_jit as tnmj  # noqa: E402
from ratilqr_tpu_torch.solvers import pets as tpets  # noqa: E402
from ratilqr_tpu_torch.solvers import ratilqr as trat  # noqa: E402
from ratilqr_tpu_torch.solvers import ratilqr_jit as tjit  # noqa: E402
from ratilqr_tpu_torch.tests_support import uniform_problem  # noqa: E402
from ratilqr_tpu_torch.utils.checkpoint import (load_state,  # noqa: E402
                                                save_state)
from test_torch_ratilqr import (_fake_draw_jax,  # noqa: E402
                                _fake_draw_torch)

STEPS = 6
F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops run faster on one thread than on many,
    and the suite runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def injected_sampler(monkeypatch):
    """The same deterministic θ draws in both packages; JAX's
    ``ratilqr_jit`` holds ``get_positive_samples`` by name."""
    monkeypatch.setattr(jrat, "get_positive_samples", _fake_draw_jax)
    monkeypatch.setattr(jratj, "get_positive_samples", _fake_draw_jax)
    monkeypatch.setattr(trat, "get_positive_samples", _fake_draw_torch)


def stage(prob):
    return lambda k, x, u: prob.c(k, x, u)


def gens(seeds):
    return [torch.Generator().manual_seed(s) for s in seeds]


def noise_table(steps, n=2, seed=0):
    return 0.05 * np.random.default_rng(seed).normal(size=(steps, n))


def jax_world(jprob, w):
    """JAX's injected-noise world, ``k`` traced by the scan."""
    table = jnp.asarray(w)
    return lambda k, x, u, key: jprob.f(x, u) + table[k]


def port_world(f, w):
    """The port's injected-noise world over seeds."""
    fb = torch.func.vmap(f)
    table = torch.tensor(w)
    return lambda k, x, u, generators: fb(x, u) + table[k]


def assert_episodes(ep_t, ep_j, tag, **tol):
    tol = tol or TOL
    for name in ("xs", "us", "values", "fallbacks", "total_cost"):
        np.testing.assert_allclose(np.asarray(getattr(ep_t, name)),
                                   np.asarray(getattr(ep_j, name)),
                                   err_msg=f"{name} {tag}", **tol)


# ----------------------------------------------------------------------
# The port's runner against the port's MPCDriver
# ----------------------------------------------------------------------

def test_episode_matches_driver_ileqg():
    """Episode ≡ ``MPCDriver`` with the same generator, state for state;
    ``total_cost`` is the explicit sum of the stage costs."""
    prob = tlqr(N=8, noise=1e-3, device="cpu")
    cfg = ILEQGConfig()
    x0 = torch.tensor([2.0, -1.0], dtype=F64)
    u0 = torch.zeros((8, 2), dtype=F64)
    run = tme.make_episode_runner(tme.make_ileqg_plan(prob, cfg, 0.0),
                                  tme.make_gaussian_simulator(prob), STEPS,
                                  stage(prob))
    ep = run(x0, u0, torch.Generator().manual_seed(7))
    recs = MPCDriver(prob, lambda x, u, g: tileqg.solve(
        prob, cfg, x, u, 0.0)).run(x0, u0, torch.Generator().manual_seed(7),
                                   STEPS)
    assert ep.xs.shape == (STEPS + 1, 2) and ep.us.shape == (STEPS, 2)
    for field, name in ((ep.xs[:-1], "x"), (ep.us, "u"),
                        (ep.values, "value")):
        torch.testing.assert_close(field, torch.stack(
            [getattr(r, name) for r in recs]), rtol=1e-12, atol=0)
    assert not bool(ep.fallbacks.any())
    total = sum(float(prob.c(torch.tensor(k), ep.xs[k], ep.us[k]))
                for k in range(STEPS))
    np.testing.assert_allclose(float(ep.total_cost), total, rtol=1e-12)


def test_episode_matches_driver_ratilqr():
    """The CE warm start (μ_init/σ_init, ref :66-68) threads through the
    episode as through ``MPCDriver`` around ``ratilqr_jit.solve``, with
    the same generator feeding the θ draws and the world."""
    prob = tlqr(N=8, noise=1e-2, device="cpu")
    cfg = CrossEntropyConfig(num_samples=6, num_elite=2, iter_max=2,
                             ileqg=ILEQGConfig(iter_max=10))
    x0 = torch.tensor([1.5, -0.5], dtype=F64)
    u0 = torch.zeros((8, 2), dtype=F64)
    run = tme.make_episode_runner(tme.make_ratilqr_plan(prob, cfg, 0.1),
                                  tme.make_gaussian_simulator(prob), STEPS,
                                  stage(prob))
    ep = run(x0, u0, torch.Generator().manual_seed(3), trat.init_state(cfg))
    held = {"state": trat.init_state(cfg)}

    def plan(x, u, g):
        res = tjit.solve(prob, cfg, held["state"], x, u, g, 0.1)
        held["state"] = res.state
        return res

    recs = MPCDriver(prob, plan).run(x0, u0, torch.Generator().manual_seed(3),
                                     STEPS)
    torch.testing.assert_close(ep.xs[:-1], torch.stack([r.x for r in recs]),
                               rtol=1e-12, atol=0)
    torch.testing.assert_close(ep.us, torch.stack([r.u for r in recs]),
                               rtol=1e-12, atol=0)
    torch.testing.assert_close(ep.values, torch.stack([r.value for r in recs]),
                               rtol=1e-12, atol=0)
    torch.testing.assert_close(ep.aux["theta_opt"],
                               torch.stack([r.info for r in recs]),
                               rtol=1e-12, atol=0)
    for name in trat.CEState._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(ep.plan_state, name)),
            np.asarray(getattr(held["state"], name)), rtol=1e-12,
            err_msg=name)


def test_fleet_matches_individual_episodes():
    """S = 4 seeds as lanes ≡ four one-seed episodes with the same
    generators."""
    prob = tlqr(N=6, noise=1e-3, device="cpu")
    cfg = ILEQGConfig(iter_max=20)
    x0 = torch.tensor([1.0, 1.0], dtype=F64)
    u0 = torch.zeros((6, 2), dtype=F64)
    args = (tme.make_ileqg_plan(prob, cfg, 0.0),
            tme.make_gaussian_simulator(prob), STEPS, stage(prob))
    out = tme.make_fleet_runner(*args)(x0, u0, gens(range(4)))
    assert out.xs.shape == (4, STEPS + 1, 2) and out.us.shape == (4, STEPS, 2)
    assert out.values.shape == out.fallbacks.shape == (4, STEPS)
    assert out.total_cost.shape == (4,)
    run = tme.make_episode_runner(*args)
    for s in range(4):
        ep = run(x0, u0, torch.Generator().manual_seed(s))
        for name in ("xs", "us", "values", "total_cost"):
            torch.testing.assert_close(getattr(out, name)[s],
                                       getattr(ep, name), rtol=1e-12, atol=0)


def test_gaussian_simulator_draws_per_seed():
    """Seed s of the batched simulator ≡ ``mpc.make_gaussian_simulator``
    with seed s's generator, bit for bit."""
    prob = tlqr(N=4, noise=0.3, device="cpu")
    x = torch.tensor([[1.0, -1.0], [0.5, 2.0], [-3.0, 0.0]], dtype=F64)
    u = torch.tensor([[0.1, 0.2], [0.0, -1.0], [2.0, 1.0]], dtype=F64)
    got = tme.make_gaussian_simulator(prob)(2, x, u, gens((5, 6, 5)))
    one = tmpc.make_gaussian_simulator(prob)
    for s, seed in enumerate((5, 6, 5)):
        torch.testing.assert_close(
            got[s], one(2, x[s], u[s], torch.Generator().manual_seed(seed)),
            rtol=1e-15, atol=1e-15)


def test_fallback_on_neurotic_breakdown():
    """noise = 1.0 makes every θ > 0 infeasible on the LQR fixture: every
    step falls back, and the controls are the θ = 0 episode's."""
    prob = tlqr(N=8, noise=1.0, device="cpu")
    cfg = ILEQGConfig()
    x0 = torch.tensor([2.0, -1.0], dtype=F64)
    u0 = torch.zeros((8, 2), dtype=F64)
    risk_neutral = tme.make_ileqg_plan(prob, cfg, 0.0)
    calls = []

    def fallback(x, u_warm):
        calls.append(x.shape[0])
        return risk_neutral((), x, u_warm, None)[1]

    sim = tme.make_gaussian_simulator(prob)
    ep = tme.make_episode_runner(tme.make_ileqg_plan(prob, cfg, 0.5), sim,
                                 STEPS, stage(prob), fallback=fallback)(
        x0, u0, torch.Generator().manual_seed(11))
    assert bool(ep.fallbacks.all()) and calls == [1] * STEPS
    assert bool(torch.isfinite(ep.values).all())
    ep0 = tme.make_episode_runner(risk_neutral, sim, STEPS, stage(prob))(
        x0, u0, torch.Generator().manual_seed(11))
    torch.testing.assert_close(ep.us, ep0.us, rtol=1e-12, atol=0)
    assert not bool(ep0.fallbacks.any())


# ----------------------------------------------------------------------
# RAT iLQR over seeds
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kl_bound", [0.5, 0.0])
def test_ratilqr_fleet_matches_single_solves(kl_bound):
    """The fleet solve ≡ S separate one-seed solves (``ratilqr_jit.solve``,
    the fleet of one seed), each with its seed's generator and state: its
    merged banks change no seed's result.  Seed 0 grows its warm start, seed 1
    starts in breakdown and redraws in generation 1, and seed 2 starts so
    deep in breakdown that its redraws run out and its final solve backs
    off to θ = 0.  The θ breakdown of this fixture lies between 5 and 6."""
    prob = tlqr(N=6, noise=1e-2, device="cpu")
    cfg = CrossEntropyConfig(num_samples=6, num_elite=2, iter_max=2,
                             ileqg=ILEQGConfig(iter_max=10))
    states = [trat.init_state(cfg)._replace(
        mu_init=torch.tensor(mu, dtype=F64),
        sigma_init=torch.tensor(sig, dtype=F64))
        for mu, sig in ((1.0, 0.5), (40.0, 2.0), (1e12, 1e10))]
    x0 = torch.tensor([[1.0, -1.0], [0.5, 0.2], [-1.0, 2.0]], dtype=F64)
    u0 = 0.1 * torch.ones((3, 6, 2), dtype=F64)
    with tileqg.record_banks() as widths:
        fleet = tjit.solve_fleet(prob, cfg, tjit.stack_states(states), x0,
                                 u0, gens((0, 1, 2)), kl_bound)
    singles = [tjit.solve(prob, cfg, st, x0[s], u0[s],
                          torch.Generator().manual_seed(s), kl_bound)
               for s, st in enumerate(states)]
    for s, res in enumerate(singles):
        for name in ("theta_opt", "value", "theta_min", "theta_max"):
            np.testing.assert_allclose(
                float(getattr(fleet, name)[s]), float(getattr(res, name)),
                rtol=1e-12, err_msg=f"{name} seed {s}")
        for name in ("x", "l", "L"):
            torch.testing.assert_close(getattr(fleet, name)[s],
                                       getattr(res, name), rtol=1e-12,
                                       atol=1e-14)
        for name in trat.CEState._fields:
            np.testing.assert_allclose(
                np.asarray(getattr(fleet.state, name)[s]),
                np.asarray(getattr(res.state, name)), rtol=1e-12,
                err_msg=f"state.{name} seed {s}")
        assert bool(fleet.redraws_exhausted[s]) == res.redraws_exhausted
        assert bool(fleet.final_failed[s]) == res.final_failed
    if kl_bound > 0:
        assert float(singles[0].state.mu_init) > 1.0       # grew
        assert float(singles[1].state.mu_init) < 40.0      # shrank, redrew
        assert singles[2].redraws_exhausted and not singles[2].final_failed
        assert float(singles[2].theta_opt) == 0.0          # backed off
        # Generation 1 is one bank of all 3 × 6 lanes, redraws are banks
        # of the rejected seeds only, the final solve one bank of 3 lanes.
        assert widths[:2] == [18, 12] and 3 in widths and widths[-1] == 1
    else:
        assert widths == [3]


def test_ratilqr_episode_matches_jax(injected_sampler):
    """RAT iLQR episodes in both packages with the same θ draws and the
    same world noise: states, controls, values, θ_opt per re-plan and the
    final warm-start state."""
    jcfg = J.CrossEntropyConfig(num_samples=4, num_elite=2, iter_max=2,
                                mu_init=0.1, sigma_init=0.05,
                                ileqg=J.ILEQGConfig(iter_max=10))
    tcfg = convert.ce_config_from_dict(convert.config_to_dict(jcfg))
    jprob, tprob = jlqr(N=8, noise=1e-2), tlqr(N=8, noise=1e-2, device="cpu")
    w = noise_table(STEPS, seed=1)
    x0, u0 = np.array([1.5, -0.5]), np.zeros((8, 2))
    ep_j = jme.make_episode_runner(
        jme.make_ratilqr_plan(jprob, jcfg, 1.0), jax_world(jprob, w), STEPS,
        stage(jprob))(jnp.asarray(x0), jnp.asarray(u0), jax.random.key(0),
                      jrat.init_state(jcfg))
    ep_t = tme.make_episode_runner(
        tme.make_ratilqr_plan(tprob, tcfg, 1.0), port_world(tprob.f, w),
        STEPS, stage(tprob))(torch.tensor(x0), torch.tensor(u0),
                             torch.Generator(), trat.init_state(tcfg))
    assert_episodes(ep_t, ep_j, "RAT iLQR")
    np.testing.assert_allclose(np.asarray(ep_t.aux["theta_opt"]),
                               np.asarray(ep_j.aux["theta_opt"]), **TOL)
    for name in trat.CEState._fields:
        np.testing.assert_allclose(np.asarray(getattr(ep_t.plan_state, name)),
                                   np.asarray(getattr(ep_j.plan_state, name)),
                                   err_msg=name, **TOL)


# ----------------------------------------------------------------------
# iLEQG, PETS and RAT iLQR++ against JAX
# ----------------------------------------------------------------------

@pytest.mark.parametrize("theta", [0.0, 0.2])
def test_ileqg_episode_matches_jax(theta):
    jprob, tprob = jlqr(N=8, noise=1e-2), tlqr(N=8, noise=1e-2, device="cpu")
    cfg = dict(iter_max=30)
    w = noise_table(STEPS, seed=2)
    x0, u0 = np.array([2.0, -1.0]), np.zeros((8, 2))
    ep_j = jme.make_episode_runner(
        jme.make_ileqg_plan(jprob, J.ILEQGConfig(**cfg), theta),
        jax_world(jprob, w), STEPS, stage(jprob))(
            jnp.asarray(x0), jnp.asarray(u0), jax.random.key(0), ())
    ep_t = tme.make_episode_runner(
        tme.make_ileqg_plan(tprob, ILEQGConfig(**cfg), theta),
        port_world(tprob.f, w), STEPS, stage(tprob))(
            torch.tensor(x0), torch.tensor(u0), torch.Generator())
    assert bool(np.isfinite(np.asarray(ep_j.values)).all())
    assert_episodes(ep_t, ep_j, f"θ={theta}")


def test_pets_episode_matches_jax(monkeypatch):
    """PETS episodes with the same control draws (a fixed standard-normal
    table ``z``: JAX's CEM is one ``lax.scan``, so its patched sampler is
    traced once) and the same world noise.  The fixture's cost ``Σ|u| +
    1`` ignores the rollout noise, so the plans and their values agree."""
    N, K = 6, 16
    z = np.random.default_rng(3).normal(size=(K, N, 2))

    def draw_jax(state, key, num_samples):
        chol = jnp.linalg.cholesky(state.sigma)
        return state.mu[None] + jnp.einsum("nij,knj->kni", chol,
                                           jnp.asarray(z))

    def draw_torch(state, generator, num_samples, z_given=None):
        chol = torch.linalg.cholesky(state.sigma)
        return state.mu[None] + torch.einsum("nij,knj->kni", chol,
                                             torch.tensor(z))

    monkeypatch.setattr(jpets, "sample_control_sequences", draw_jax)
    monkeypatch.setattr(tpets, "sample_control_sequences", draw_torch)
    jgen = JGen(f_stochastic=lambda x, u, key, use_true_model=False:
                x + u + jax.random.uniform(key, x.shape, dtype=x.dtype),
                c=lambda k, x, u: jnp.sum(jnp.abs(u)),
                h=lambda x: jnp.asarray(1.0, x.dtype), N=N)
    tgen = uniform_problem(N=N, device="cpu")
    jcfg = J.PETSConfig(num_control_samples=K, num_trajectory_samples=4,
                        num_elite=4, iter_max=2)
    tcfg = convert.pets_config_from_dict(convert.config_to_dict(jcfg))
    sig0 = np.eye(2)[None].repeat(N, 0)
    w = noise_table(STEPS, seed=4)
    x0, mu0 = np.array([-1.0, -1.0]), np.zeros((N, 2))
    ep_j = jme.make_episode_runner(
        jme.make_pets_plan(jgen, jcfg, jnp.asarray(sig0)),
        lambda k, x, u, key: x + u + jnp.asarray(w)[k], STEPS,
        stage(jgen))(jnp.asarray(x0), jnp.asarray(mu0), jax.random.key(5),
                     ())
    ep_t = tme.make_episode_runner(
        tme.make_pets_plan(tgen, tcfg, torch.tensor(sig0)),
        port_world(lambda x, u: x + u, w), STEPS, stage(tgen))(
            torch.tensor(x0), torch.tensor(mu0),
            torch.Generator().manual_seed(5))
    assert_episodes(ep_t, ep_j, "PETS")


def test_nm_episode_matches_jax():
    """RAT iLQR++ draws nothing: with the injected world, the bootstrapped
    ``NMState`` threads through 3 re-plans of both packages alike."""
    jcfg = J.NelderMeadConfig(theta_high_init=0.5, theta_low_init=1e-8,
                              iter_max=10, ileqg=J.ILEQGConfig(iter_max=10))
    tcfg = convert.nm_config_from_dict(convert.config_to_dict(jcfg))
    jprob, tprob = jlqr(N=6, noise=1e-2), tlqr(N=6, noise=1e-2, device="cpu")
    w = noise_table(3, seed=5)
    x0, u0 = np.array([1.0, -1.0]), np.zeros((6, 2))
    jboot = jnmj.bootstrap_state(jprob, jcfg, jnp.asarray(x0),
                                 jnp.asarray(u0),
                                 kl_bound=jnp.asarray(0.1, jnp.float64))
    tboot = tnmj.bootstrap_state(tprob, tcfg, torch.tensor(x0),
                                 torch.tensor(u0), kl_bound=0.1)
    ep_j = jme.make_episode_runner(
        jme.make_nm_plan(jprob, jcfg, 0.1), jax_world(jprob, w), 3,
        stage(jprob))(jnp.asarray(x0), jnp.asarray(u0), jax.random.key(2),
                      jboot)
    ep_t = tme.make_episode_runner(
        tme.make_nm_plan(tprob, tcfg, 0.1), port_world(tprob.f, w), 3,
        stage(tprob))(torch.tensor(x0), torch.tensor(u0), torch.Generator(),
                      tboot)
    assert_episodes(ep_t, ep_j, "RAT iLQR++")
    np.testing.assert_allclose(np.asarray(ep_t.aux["theta_opt"]),
                               np.asarray(ep_j.aux["theta_opt"]), **TOL)
    for name, value in ep_t.plan_state._asdict().items():
        np.testing.assert_allclose(float(value),
                                   float(getattr(ep_j.plan_state, name)),
                                   err_msg=name, **TOL)


def test_episode_plan_state_checkpoint_roundtrip(tmp_path):
    """Episode chaining across process restarts: the final ``plan_state``
    checkpoints and resumes to an identical continuation."""
    prob = tlqr(N=6, noise=1e-2, device="cpu")
    cfg = CrossEntropyConfig(num_samples=4, num_elite=2, iter_max=1,
                             ileqg=ILEQGConfig(iter_max=8))
    run = tme.make_episode_runner(tme.make_ratilqr_plan(prob, cfg, 0.1),
                                  tme.make_gaussian_simulator(prob), 3,
                                  stage(prob))
    x0 = torch.tensor([1.0, -1.0], dtype=F64)
    u0 = torch.zeros((6, 2), dtype=F64)
    ep1 = run(x0, u0, torch.Generator().manual_seed(0), trat.init_state(cfg))
    path = str(tmp_path / "ep_state.ckpt")
    save_state(path, ep1.plan_state)
    restored = load_state(path, ep1.plan_state)
    cont_a = run(ep1.xs[-1], u0, torch.Generator().manual_seed(1),
                 ep1.plan_state)
    cont_b = run(ep1.xs[-1], u0, torch.Generator().manual_seed(1),
                 restored)
    assert torch.equal(cont_a.xs, cont_b.xs)
    assert torch.equal(cont_a.total_cost, cont_b.total_cost)
    assert torch.equal(cont_a.aux["theta_opt"], cont_b.aux["theta_opt"])
