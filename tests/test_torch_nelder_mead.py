"""RAT iLQR++ in the port, the host path ``solvers/nelder_mead.py``,
against the JAX host path (CPU, float64).

The fixture is ``tests/test_bilevel.py:15-19``: the nonlinear toy at N=10,
x0 = 0, u0 = 0.1.  Nelder-Mead draws nothing, so every decision must agree:
θ_opt and value to rtol 1e-9, ``l`` to atol 1e-10 and every ``NMState``
field as ``tests/test_bilevel.py:124-135`` holds the JAX paths.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import ratilqr_tpu as J  # noqa: E402
from ratilqr_tpu.models import nonlinear_toy as jtoy  # noqa: E402
from ratilqr_tpu.mpc import MPCDriver as JMPCDriver  # noqa: E402
from ratilqr_tpu.problems import RiskSensitiveProblem as JProblem  # noqa: E402
from ratilqr_tpu.solvers import nelder_mead as jnm  # noqa: E402
from ratilqr_tpu_torch import convert  # noqa: E402
from ratilqr_tpu_torch.config import NelderMeadConfig  # noqa: E402
from ratilqr_tpu_torch.models import nonlinear_toy as ttoy  # noqa: E402
from ratilqr_tpu_torch.mpc import (MPCDriver,  # noqa: E402
                                   plan_without_generator)
from ratilqr_tpu_torch.problems import RiskSensitiveProblem  # noqa: E402
from ratilqr_tpu_torch.solvers import ileqg  # noqa: E402
from ratilqr_tpu_torch.solvers import nelder_mead as tnm  # noqa: E402
from ratilqr_tpu_torch.solvers import nelder_mead_jit as tjit  # noqa: E402

JPROB = jtoy(N=10)
TPROB = ttoy(N=10, device="cpu")
X0, U0 = np.zeros(2), 0.1 * np.ones((10, 2))
X1 = X0 + 0.05
# The stale-c warm path never converges (the reference's quirk) and runs
# every NM iteration; a small budget keeps those cases short.
WARM_ITER_MAX = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops run faster on one thread than on many,
    and the suite runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**kw):
    """The same NM configuration in both packages."""
    jcfg = J.NelderMeadConfig(**kw)
    tcfg = convert.nm_config_from_dict(convert.config_to_dict(jcfg))
    assert tcfg == NelderMeadConfig(**kw)
    return jcfg, tcfg


def jax_solve(jcfg, state, x, kl):
    return jnm.solve(JPROB, jcfg, state, jnp.asarray(x), jnp.asarray(U0),
                     kl_bound=kl)


def assert_nm_state(st_t, st_j, tag):
    t, j = convert.nm_state_to_numpy(st_t), convert.nm_state_to_numpy(st_j)
    for name in ("theta_high_init", "theta_low_init"):
        np.testing.assert_allclose(t[name], j[name], rtol=1e-12,
                                   err_msg=f"{name} {tag}")
    for name in ("theta_high", "theta_low", "c_high", "c_low"):
        np.testing.assert_allclose(t[name], j[name], rtol=1e-9,
                                   err_msg=f"{name} {tag}")
    assert int(t["iter_current"]) == int(j["iter_current"]), tag


def assert_nm(res_t, res_j, tag):
    for name in ("theta_opt", "value"):
        np.testing.assert_allclose(float(getattr(res_t, name)),
                                   float(getattr(res_j, name)), rtol=1e-9,
                                   err_msg=f"{name} {tag}")
    np.testing.assert_allclose(res_t.l.numpy(), np.asarray(res_j.l),
                               rtol=0, atol=1e-10, err_msg=f"l {tag}")
    assert res_t.value.dtype == torch.float64
    assert_nm_state(res_t.state, res_j.state, tag)


@pytest.mark.parametrize("kl", [1.0, 0.37])
def test_cold_solve_matches_jax(kl):
    jcfg, tcfg = configs()
    rj = jax_solve(jcfg, jnm.init_state(jcfg), X0, kl)
    rt = tnm.solve(TPROB, tcfg, tnm.init_state(tcfg), X0, U0, kl_bound=kl)
    assert_nm(rt, rj, f"kl={kl}")
    assert rt.state.iter_current > 0 and float(rt.theta_opt) > 0


def test_kl_zero_is_solve_value():
    _, tcfg = configs()
    rt = tnm.solve(TPROB, tcfg, tnm.init_state(tcfg), X0, U0, kl_bound=0.0)
    assert float(rt.theta_opt) == 0.0
    ref = ileqg.solve_value(TPROB, tcfg.ileqg, X0, U0, 0.0)
    assert torch.equal(rt.value, ref)
    # No bootstrap ran: the costs stay missing.
    assert rt.state.c_high is None and rt.state.c_low is None
    jref = J.solve_value(JPROB, J.ILEQGConfig(), jnp.asarray(X0),
                         jnp.asarray(U0), 0.0)
    np.testing.assert_allclose(float(rt.value), float(jref), rtol=1e-12)
    with pytest.raises(ValueError):
        tnm.solve(TPROB, tcfg, tnm.init_state(tcfg), X0, U0, kl_bound=-1.0)


@pytest.mark.parametrize("refresh", [False, True])
def test_warm_second_solve(refresh):
    """The second solve from x1 carries the first one's state: the stale
    carried costs (reference semantics) or their re-evaluation."""
    jcfg, tcfg = configs(refresh_carried_costs=refresh,
                         iter_max=WARM_ITER_MAX)
    rj = jax_solve(jcfg, jnm.init_state(jcfg), X0, 1.0)
    solver = tnm.NelderMeadSolver(TPROB, tcfg)
    assert_nm(solver.solve(X0, U0, kl_bound=1.0), rj, "cold")
    rj2 = jax_solve(jcfg, rj.state, X1, 1.0)
    rt2 = solver.solve(torch.tensor(X1), torch.tensor(U0), kl_bound=1.0)
    assert_nm(rt2, rj2, f"warm refresh={refresh}")
    if not refresh:
        assert rt2.state.iter_current == WARM_ITER_MAX


def test_jax_state_seeds_the_port(capsys):
    """An ``NMState`` from a JAX solve, carried through ``convert``, seeds
    the port's next solve to JAX's result, and the other way round; the
    verbose solve prints the per-iteration trace."""
    jcfg, tcfg = configs(refresh_carried_costs=True)
    r1 = jax_solve(jcfg, jnm.init_state(jcfg), X0, 1.0)
    carried = convert.nm_state_from_numpy(convert.nm_state_to_numpy(r1.state))
    r2_j = jax_solve(jcfg, r1.state, X1, 1.0)
    r2_t = tnm.solve(TPROB, tcfg, carried, X1, U0, kl_bound=1.0,
                     verbose=True)
    assert_nm(r2_t, r2_j, "JAX state -> port")
    trace = capsys.readouterr().out
    assert trace.count("**NM iter") == r2_t.state.iter_current
    assert "Nelder-Mead converged" in trace
    back = jnm.NMState(**convert.nm_state_to_numpy(r2_t.state))
    r3_j = jax_solve(jcfg, back, X0, 1.0)
    r3_t = tnm.solve(TPROB, tcfg, r2_t.state, X0, U0, kl_bound=1.0)
    assert_nm(r3_t, r3_j, "port state -> JAX")


def _nan_problems(N=6):
    """Dynamics NaN at every state (tests/test_failure_paths.py:118-127):
    the solve fails at every θ, so the bootstrap exhausts its budget."""
    W = 0.1 * torch.eye(2, dtype=torch.float64)
    tp = RiskSensitiveProblem(
        f=lambda x, u: torch.sqrt(x - 100.0) + u,
        c=lambda k, x, u: x @ x + u @ u, h=lambda x: x @ x,
        W=lambda k: W, N=N)
    jp = JProblem(
        f=lambda x, u: jnp.sqrt(x - 100.0) + u,
        c=lambda k, x, u: x @ x + u @ u, h=lambda x: x @ x,
        W=lambda k: 0.1 * jnp.eye(2, dtype=jnp.float64), N=N)
    return tp, jp


def test_bootstrap_budget_on_nan_dynamics():
    """Both port paths end the bootstrap after ``_MAX_BOOTSTRAP`` rungs
    with the inits halved 59 times, value Inf, as the JAX host path."""
    tp, jp = _nan_problems()
    jcfg, tcfg = configs()
    u0 = np.zeros((6, 2))
    rj = jnm.solve(jp, jcfg, jnm.init_state(jcfg), jnp.zeros(2),
                   jnp.asarray(u0), kl_bound=1.0)
    halved = tcfg.lam ** (tnm._MAX_BOOTSTRAP - 1)
    assert float(rj.state.theta_high_init) == tcfg.theta_high_init * halved
    assert float(rj.state.theta_low_init) == tcfg.theta_low_init * halved
    for solve in (tnm.solve, tjit.solve):
        rt = solve(tp, tcfg, tnm.init_state(tcfg), np.zeros(2), u0,
                   kl_bound=1.0)
        assert math.isinf(float(rt.value)), solve.__module__
        st, sj = (convert.nm_state_to_numpy(s) for s in (rt.state, rj.state))
        for name in st:
            np.testing.assert_array_equal(st[name], sj[name],
                                          err_msg=f"{name} {solve.__module__}")
        assert float(rt.theta_opt) == float(rj.theta_opt)


def test_mpc_replans_through_the_adapter():
    """Two MPC re-plans with the NM host path behind ``MPCDriver`` (the
    generator ignored) on a noiseless simulator, against JAX's driver."""
    jcfg, tcfg = configs(refresh_carried_costs=True)
    jstate = {"s": jnm.init_state(jcfg)}

    def jplan(x, u, key):
        res = jnm.solve(JPROB, jcfg, jstate["s"], x, u, kl_bound=1.0)
        jstate["s"] = res.state
        return res

    jsteps = JMPCDriver(JPROB, jplan,
                        lambda k, x, u, key: JPROB.f(x, u)).run(
        jnp.asarray(X0), jnp.asarray(U0), jax.random.key(0), 2)
    solver = tnm.NelderMeadSolver(TPROB, tcfg)
    tsteps = MPCDriver(TPROB, plan_without_generator(solver.solve,
                                                     kl_bound=1.0),
                       lambda k, x, u, gen: TPROB.f(x, u)).run(
        torch.tensor(X0), torch.tensor(U0), torch.Generator(), 2)
    for k, (ts, js) in enumerate(zip(tsteps, jsteps)):
        np.testing.assert_allclose(float(ts.value), float(js.value),
                                   rtol=1e-9, err_msg=f"value {k}")
        np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), rtol=0,
                                   atol=1e-10, err_msg=f"u {k}")
        np.testing.assert_allclose(float(ts.info), float(js.info),
                                   rtol=1e-9, err_msg=f"θ_opt {k}")
    assert_nm_state(solver.state, jstate["s"], "after MPC")
