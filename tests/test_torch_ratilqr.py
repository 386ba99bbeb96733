"""RAT iLQR in the port (the host path ``solvers/ratilqr.py`` and the
single-call path ``solvers/ratilqr_jit.py``) against the JAX host path
(CPU, float64).

torch's and JAX's random streams differ, so both sides draw θ from the same
deterministic sampler (the ``_injected_sampler`` pattern of
tests/test_oracle_bilevel.py:114-140): every CE decision must then agree —
θ_opt, value, every ``CEState`` field and the θ-range, rtol 1e-9.  The
budgets keep their semantics: the host path raises, the single-call path
sets ``redraws_exhausted`` / ``final_failed`` and forces θ = 0.
"""
import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import ratilqr_tpu as J  # noqa: E402
from ratilqr_tpu.models import nonlinear_toy as jtoy  # noqa: E402
from ratilqr_tpu.solvers import ratilqr as jrat  # noqa: E402
from ratilqr_tpu_torch import convert  # noqa: E402
from ratilqr_tpu_torch.config import (CrossEntropyConfig,  # noqa: E402
                                      ILEQGConfig)
from ratilqr_tpu_torch.models import nonlinear_toy as ttoy  # noqa: E402
from ratilqr_tpu_torch.problems import RiskSensitiveProblem  # noqa: E402
from ratilqr_tpu_torch.solvers import ratilqr as trat  # noqa: E402
from ratilqr_tpu_torch.solvers import ratilqr_jit as tjit  # noqa: E402

_Z = np.linspace(-1.1, 1.3, 7)   # deterministic stand-in for N(0,1) draws
KL = 1.0
JPROB = jtoy(N=10)
TPROB = ttoy(N=10, device="cpu")
X0, U0 = np.zeros(2), 0.1 * np.ones((10, 2))
INNER = dict(iter_max=20)


def _fake_draw_jax(key, mu, sigma, num_samples, dtype=jnp.float64):
    z = jnp.asarray(_Z[:num_samples], dtype)
    return jnp.abs(jnp.asarray(mu, dtype) + jnp.asarray(sigma, dtype) * z
                   ) + jnp.asarray(1e-4, dtype)


def _fake_draw_torch(generator, mu, sigma, num_samples, dtype=torch.float64):
    z = torch.tensor(_Z[:num_samples], dtype=dtype)
    return (torch.as_tensor(mu, dtype=dtype)
            + torch.as_tensor(sigma, dtype=dtype) * z).abs() + 1e-4


@pytest.fixture()
def injected_sampler(monkeypatch):
    monkeypatch.setattr(jrat, "get_positive_samples", _fake_draw_jax)
    monkeypatch.setattr(trat, "get_positive_samples", _fake_draw_torch)


def configs(**kw):
    """The same CE configuration in both packages."""
    jcfg = J.CrossEntropyConfig(ileqg=J.ILEQGConfig(**INNER), **kw)
    tcfg = convert.ce_config_from_dict(convert.config_to_dict(jcfg))
    assert tcfg == CrossEntropyConfig(ileqg=ILEQGConfig(**INNER), **kw)
    return jcfg, tcfg


def assert_ce_state(st_t, st_j, tag):
    t, j = convert.ce_state_to_numpy(st_t), convert.ce_state_to_numpy(st_j)
    for name in ("mu_init", "sigma_init", "mu", "sigma", "theta_min",
                 "theta_max"):
        np.testing.assert_allclose(t[name], j[name], rtol=1e-9,
                                   err_msg=f"{name} {tag}")
    assert int(t["iter_current"]) == int(j["iter_current"]), tag


def assert_results(res_t, res_j, tag):
    for name in ("theta_opt", "value", "theta_min", "theta_max"):
        np.testing.assert_allclose(float(getattr(res_t, name)),
                                   float(getattr(res_j, name)), rtol=1e-9,
                                   err_msg=f"{name} {tag}")
    np.testing.assert_allclose(res_t.l.numpy(), np.asarray(res_j.l),
                               rtol=0, atol=1e-8, err_msg=f"l {tag}")
    assert_ce_state(res_t.state, res_j.state, tag)


def run_chain(kl, n_calls, **cfg_kw):
    """``n_calls`` warm-chained solves in JAX's host path and the port's two
    paths from the same initial state; returns the JAX results."""
    jcfg, tcfg = configs(**cfg_kw)
    jstate = jrat.init_state(jcfg)
    hstate = sstate = trat.init_state(tcfg)
    out = []
    for k in range(n_calls):
        xk = X0 + 0.05 * k
        rj = jrat.solve(JPROB, jcfg, jstate, jnp.asarray(xk),
                        jnp.asarray(U0), jax.random.key(0), kl_bound=kl)
        rh = trat.solve(TPROB, tcfg, hstate, torch.tensor(xk),
                        torch.tensor(U0), torch.Generator(), kl_bound=kl)
        rs = tjit.solve(TPROB, tcfg, sstate, torch.tensor(xk),
                        torch.tensor(U0), torch.Generator(), kl)
        assert_results(rh, rj, f"host k={k}")
        # The single-call path keeps iter_current = iter_max (or 0).
        assert_results(rs, rj._replace(state=rj.state._replace(
            iter_current=tcfg.iter_max if kl > 0 else 0)), f"single k={k}")
        assert not rs.redraws_exhausted and not rs.final_failed
        jstate, hstate, sstate = rj.state, rh.state, rs.state
        out.append(rj)
    return out


GROW = dict(num_samples=4, num_elite=2, iter_max=2, mu_init=0.1,
            sigma_init=0.05)


def test_grow_branch_warm_chain(injected_sampler):
    """All-valid iteration 1 grows μ_init/σ_init by 1/λ, and the grown
    state seeds the next solve (ref :299-305)."""
    res = run_chain(KL, 2, **GROW)
    assert float(res[-1].state.mu_init) > 0.1 * 2 ** 1.5


def test_shrink_branch(injected_sampler):
    """μ_init = 500 is deep in breakdown: iteration 1 shrinks and redraws
    (ref :293-298)."""
    res = run_chain(KL, 1, num_samples=4, num_elite=2, iter_max=2,
                    mu_init=500.0, sigma_init=1.0)
    assert float(res[0].state.mu_init) < 500.0


def test_use_theta_max(injected_sampler):
    res = run_chain(KL, 1, **dict(GROW, use_theta_max=True))
    assert float(res[0].theta_opt) == float(res[0].theta_max)


def test_kl_zero_is_ilqg(injected_sampler):
    res = run_chain(0.0, 1, **GROW)
    assert float(res[0].theta_opt) == 0.0
    assert float(res[0].theta_min) == 0.0 == float(res[0].theta_max)
    ilqg = J.ileqg_solve(JPROB, J.ILEQGConfig(**INNER), jnp.asarray(X0),
                         jnp.asarray(U0), 0.0)
    np.testing.assert_allclose(float(res[0].value), float(ilqg.value),
                               rtol=1e-12)


def test_jax_state_seeds_the_port(injected_sampler):
    """A ``CEState`` from a JAX solve, carried through ``convert``, seeds
    the port's next solve to JAX's result, and the other way round."""
    jcfg, tcfg = configs(**GROW)
    r1 = jrat.solve(JPROB, jcfg, jrat.init_state(jcfg), jnp.asarray(X0),
                    jnp.asarray(U0), jax.random.key(0), kl_bound=KL)
    carried = convert.ce_state_from_numpy(convert.ce_state_to_numpy(r1.state))
    x1 = X0 + 0.05
    r2_j = jrat.solve(JPROB, jcfg, r1.state, jnp.asarray(x1),
                      jnp.asarray(U0), jax.random.key(0), kl_bound=KL)
    r2_t = trat.solve(TPROB, tcfg, carried, torch.tensor(x1),
                      torch.tensor(U0), torch.Generator(), kl_bound=KL)
    assert_results(r2_t, r2_j, "JAX state -> port")
    back = jrat.CEState(**{
        k: (int(v) if k == "iter_current" else jnp.asarray(v))
        for k, v in convert.ce_state_to_numpy(r2_t.state).items()})
    x2 = X0 + 0.1
    r3_j = jrat.solve(JPROB, jcfg, back, jnp.asarray(x2), jnp.asarray(U0),
                      jax.random.key(0), kl_bound=KL)
    r3_t = trat.solve(TPROB, tcfg, r2_t.state, torch.tensor(x2),
                      torch.tensor(U0), torch.Generator(), kl_bound=KL)
    assert_results(r3_t, r3_j, "port state -> JAX")
    arrays = convert.ratilqr_result_to_numpy(r3_t)
    assert set(arrays) == set(jrat.RATiLQRResult._fields)
    assert set(arrays["state"]) == set(jrat.CEState._fields)


def _always_infeasible_problem(N=6):
    """tests/test_failure_paths.py:59-69: W = 1e12·I makes every θ > 0 a
    neurotic breakdown, far below anything the sampler can reach."""
    W = 1e12 * torch.eye(2, dtype=torch.float64)
    return RiskSensitiveProblem(
        f=lambda x, u: x + u, c=lambda k, x, u: x @ x + u @ u,
        h=lambda x: x @ x, W=lambda k: W, N=N)


def test_redraw_budget_host_raises_single_call_flags():
    prob = _always_infeasible_problem()
    cfg = CrossEntropyConfig(num_samples=4, num_elite=2, iter_max=2,
                             ileqg=ILEQGConfig(iter_max=3))
    x0, u0 = torch.ones(2, dtype=torch.float64), torch.zeros(
        (6, 2), dtype=torch.float64)
    with pytest.raises(RuntimeError, match="redraw budget exhausted"):
        trat.solve(prob, cfg, trat.init_state(cfg), x0, u0,
                   torch.Generator().manual_seed(0), kl_bound=1.0)
    res = tjit.solve(prob, cfg, trat.init_state(cfg), x0, u0,
                     torch.Generator().manual_seed(0), 1.0)
    assert res.redraws_exhausted and not res.final_failed
    # Each generation shrank the warm start once per redraw (25 each).
    assert float(res.state.mu_init) == pytest.approx(
        cfg.mu_init * cfg.lam ** trat.MAX_REDRAWS, rel=1e-12)
    assert res.state.iter_current == cfg.iter_max
    # Every θ > 0 breaks down, so the backoff ends at θ = 0, where the
    # objective's kl_bound/θ is +Inf.
    assert float(res.theta_opt) == 0.0 and math.isinf(float(res.value))


def test_single_call_final_failure_forces_theta_zero():
    """Non-PSD W fails every θ, 0 included: the single-call path runs out
    of θ-backoff, its last attempt at θ = 0, and reports it
    (tests/test_ratilqr_jit.py:132-157); the host path raises."""
    W = -0.01 * torch.eye(2, dtype=torch.float64)
    prob = RiskSensitiveProblem(
        f=lambda x, u: x + u, c=lambda k, x, u: 0.5 * (x @ x) + 0.5 * (u @ u),
        h=lambda x: 0.5 * (x @ x), W=lambda k: W, N=6)
    cfg = CrossEntropyConfig(num_samples=4, num_elite=2, iter_max=2,
                             ileqg=ILEQGConfig(iter_max=5))
    x0 = torch.tensor([1.0, -1.0], dtype=torch.float64)
    u0 = torch.zeros((6, 2), dtype=torch.float64)
    res = tjit.solve(prob, cfg, trat.init_state(cfg), x0, u0,
                     torch.Generator().manual_seed(0), 0.1)
    assert res.redraws_exhausted and res.final_failed
    assert float(res.theta_opt) == 0.0 and math.isinf(float(res.value))
    with pytest.raises(RuntimeError):
        trat.solve(prob, cfg, trat.init_state(cfg), x0, u0,
                   torch.Generator().manual_seed(0), kl_bound=0.0)


def test_nan_costs_are_masked_and_sorted_last():
    fake = SimpleNamespace(value=torch.tensor(
        [1.0, float("nan"), 0.5, float("inf")], dtype=torch.float64))
    thetas = torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=torch.float64)
    costs = trat.costs_of(fake, thetas, 1.0)
    assert torch.isinf(costs[1]) and torch.isinf(costs[3])
    cfg = CrossEntropyConfig(num_samples=4, num_elite=2)
    st = trat.refit(cfg, trat.init_state(cfg), thetas.numpy(),
                    costs.numpy())
    # Elites: θ = 0.3 (cost 3.83) and θ = 0.1 (cost 11); never the Inf lanes.
    assert float(st.mu) == pytest.approx(0.2, rel=1e-12)
    assert float(st.theta_min) == pytest.approx(0.1)
    assert float(st.theta_max) == pytest.approx(0.3)


def test_sampler_is_seeded_positive_and_unbiased():
    mu, sigma, n = 0.005, 0.01, 20_000
    draw = lambda seed: trat.get_positive_samples(  # noqa: E731
        torch.Generator().manual_seed(seed), mu, sigma, n, torch.float32)
    a, b, c = draw(3), draw(3), draw(4)
    assert a.dtype == torch.float32 and a.shape == (n,)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool((a > 0).all())
    # Truncated normal on (0, ∞): mean μ + σ φ(α)/(1 − Φ(α)), α = −μ/σ.
    alpha = -mu / sigma
    phi = math.exp(-alpha ** 2 / 2) / math.sqrt(2 * math.pi)
    tail = 0.5 * math.erfc(alpha / math.sqrt(2))
    mean = mu + sigma * phi / tail
    se = float(a.double().std()) / math.sqrt(n)
    assert abs(float(a.double().mean()) - mean) < 3 * se
    # Far in the tail (μ = −5σ) the draws stay positive and finite.
    far = trat.get_positive_samples(torch.Generator().manual_seed(0), -0.05,
                                    0.01, 1000)
    assert bool(torch.isfinite(far).all() & (far > 0).all())
