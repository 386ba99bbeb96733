"""Parity of the port's Riccati DP (the plain version of kernel A) with the
JAX package.

  - float64 against JAX ``_riccati_core`` in every mode, rtol 1e-10;
  - float32 against the Pallas kernel ``riccati_bank`` run in interpret
    mode, with the tolerances of tests/test_pallas.py;
  - the per-lane μ-restart loop against JAX ``dp_optimize`` under vmap;
  - the closed-form Whittle LEQG fixture of tests/test_leqg_closed_form.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ratilqr_tpu.models import unicycle as junicycle  # noqa: E402
from ratilqr_tpu.ops import riccati as jric  # noqa: E402
from ratilqr_tpu.ops.approx import approximate_model as japprox  # noqa: E402
from ratilqr_tpu.ops.riccati_pallas import riccati_bank as jbank  # noqa: E402
from ratilqr_tpu.ops.rollout import (  # noqa: E402
    rollout_open_loop_with_jac as jroll)
from ratilqr_tpu_torch.ops import riccati as tric  # noqa: E402
from ratilqr_tpu_torch.ops.approx import Approximation  # noqa: E402
from ratilqr_tpu_torch.ops.riccati_cuda import riccati_bank  # noqa: E402
from test_leqg_closed_form import (CASES, make_stages,  # noqa: E402
                                   whittle_evaluate, whittle_optimize)

T, B = 7, 5
THETAS = np.array([0.0, 0.01, 0.05, 1e6, 0.02])
MUS = np.array([0.0, 0.0, 1e-3, 0.0, 1e-2])
F64 = torch.float64


def _jax_approx(dtype, seed=0):
    prob = junicycle(N=T, dtype=dtype)
    rng = np.random.default_rng(seed)
    x0s = jnp.asarray(0.1 * rng.standard_normal((B, 3)), dtype)
    us = jnp.asarray(0.1 * rng.standard_normal((B, T, 2)), dtype)

    def make(x0, u):
        x, A, Bm = jroll(prob, x0, u)
        return japprox(prob, u, x, A, Bm)

    return jax.vmap(make)(x0s, us)


def _to_torch(ap_j, dtype, shared_w=True):
    """JAX bank approximation → the port's (noise model shared by
    default, as the port's approximate_model builds it)."""
    f = {k: torch.tensor(np.array(getattr(ap_j, k)), dtype=dtype)
         for k in ap_j._fields}
    if shared_w:
        f["W"], f["W_inv"], f["logdet_W"] = (f["W"][0], f["W_inv"][0],
                                             f["logdet_W"][0])
    return Approximation(**f)


def _perturbed_policy(L, dl, seed=2):
    rng = np.random.default_rng(seed)
    return (L + 0.05 * rng.standard_normal(L.shape),
            dl + 0.05 * rng.standard_normal(dl.shape))


def _jax_core(ap_j, thetas, mus, L=None, dl=None):
    if L is None:
        return jax.vmap(lambda a, th, mu: jric._riccati_core(
            a, th, mu, None, None))(ap_j, thetas, mus)
    return jax.vmap(lambda a, th, mu, LL, dd: jric._riccati_core(
        a, th, mu, LL, dd))(ap_j, thetas, mus, L, dl)


def _compare_core(got, want, tol):
    dp_t, L_t, dl_t, mf_t, hf_t = got
    dp_j, L_j, dl_j, mf_j, hf_j = want
    np.testing.assert_array_equal(mf_t.numpy(), np.asarray(mf_j))
    np.testing.assert_array_equal(hf_t.numpy(), np.asarray(hf_j))
    ok = ~(np.asarray(mf_j) | np.asarray(hf_j))
    assert ok.sum() >= 3, "fixture lost its feasible lanes"
    for name in dp_j._fields:
        np.testing.assert_allclose(getattr(dp_t, name).numpy()[ok],
                                   np.asarray(getattr(dp_j, name))[ok],
                                   **tol, err_msg=name)
    np.testing.assert_allclose(L_t.numpy()[ok], np.asarray(L_j)[ok], **tol)
    np.testing.assert_allclose(dl_t.numpy()[ok], np.asarray(dl_j)[ok], **tol)


TOL64 = dict(rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shared_w", [True, False])
@pytest.mark.parametrize("mode", ["optimizing", "evaluating",
                                  "evaluating_no_dl"])
def test_core_matches_jax_f64(mode, shared_w):
    ap_j = _jax_approx(jnp.float64)
    ap_t = _to_torch(ap_j, F64, shared_w)
    th_t, mu_t = torch.tensor(THETAS), torch.tensor(MUS)
    if mode == "optimizing":
        got = tric._riccati_core(ap_t, th_t, mu_t, None, None)
        want = _jax_core(ap_j, THETAS, MUS)
    else:
        _, L_o, dl_o, _, _ = _jax_core(ap_j, THETAS, MUS)
        L, dl = _perturbed_policy(np.asarray(L_o), np.asarray(dl_o))
        if mode == "evaluating_no_dl":
            dl_t, dl = None, np.zeros_like(dl)
        else:
            dl_t = torch.tensor(dl)
        got = tric._riccati_core(ap_t, th_t, mu_t, torch.tensor(L), dl_t)
        want = _jax_core(ap_j, THETAS, MUS, L, dl)
    _compare_core(got, want, TOL64)


@pytest.mark.parametrize("optimizing", [True, False])
def test_slim_bank_matches_full(optimizing):
    ap_t = _to_torch(_jax_approx(jnp.float64), F64)
    th_t, mu_t = torch.tensor(THETAS), torch.tensor(MUS)
    full_opt = riccati_bank(ap_t, th_t, mu_t)
    L_in = None if optimizing else full_opt.L
    full = riccati_bank(ap_t, th_t, mu_t, L_in)
    slim = riccati_bank(ap_t, th_t, mu_t, L_in, slim=True)
    torch.testing.assert_close(slim.value, full.value, rtol=0, atol=0,
                               equal_nan=True)
    assert torch.equal(slim.m_fail, full.m_fail)
    assert torch.equal(slim.h_fail, full.h_fail)
    if optimizing:
        torch.testing.assert_close(slim.L, full.L, rtol=0, atol=0,
                                   equal_nan=True)
    else:
        assert slim.L is None and slim.dl is None


@pytest.mark.parametrize("optimizing", [True, False])
def test_core_f32_matches_pallas_kernel_interpret(optimizing):
    """The port's plain core in f32 against the Pallas kernel (interpret
    mode on the CPU), with tests/test_pallas.py's tolerances."""
    ap_j = _jax_approx(jnp.float32)
    th = jnp.asarray(THETAS, jnp.float32)
    mu = jnp.asarray(MUS, jnp.float32)
    ap_shared = ap_j._replace(W=ap_j.W[0], W_inv=ap_j.W_inv[0],
                              logdet_W=ap_j.logdet_W[0])
    ap_t = _to_torch(ap_j, torch.float32)
    th_t = torch.tensor(THETAS, dtype=torch.float32)
    mu_t = torch.tensor(MUS, dtype=torch.float32)
    if optimizing:
        want = jbank(ap_shared, th, mu)
        got = riccati_bank(ap_t, th_t, mu_t)
        tol = dict(rtol=2e-4, atol=1e-6)
    else:
        opt = jbank(ap_shared, th, mu)
        L, dl = _perturbed_policy(np.asarray(opt.L), np.asarray(opt.dl))
        L, dl = L.astype(np.float32), dl.astype(np.float32)
        want = jbank(ap_shared, th, mu, jnp.asarray(L), jnp.asarray(dl))
        got = riccati_bank(ap_t, th_t, mu_t, torch.tensor(L),
                           torch.tensor(dl))
        tol = dict(rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(got.m_fail.numpy(), np.asarray(want.m_fail))
    np.testing.assert_array_equal(got.h_fail.numpy(), np.asarray(want.h_fail))
    ok = ~(np.asarray(want.m_fail) | np.asarray(want.h_fail))
    assert ok.sum() >= 3
    np.testing.assert_allclose(got.s.numpy()[ok, 0],
                               np.asarray(want.s)[ok, 0], rtol=3e-5)
    for name in ("s", "s_vec", "S", "g", "G", "H", "L", "dl"):
        np.testing.assert_allclose(getattr(got, name).numpy()[ok],
                                   np.asarray(getattr(want, name))[ok],
                                   **tol, err_msg=name)


def _negative_curvature_approx(seed):
    """Random-state approximations of the restart-forcing fixture of
    tests/test_step_fused.py (f = x + u, c = ½x·x − 0.05u·u,
    h = 0.005x·x, W = 0.01 I): H is indefinite at μ = 0 near the horizon
    end, so lanes walk the μ ladder, each for its own number of rounds."""
    rng = np.random.default_rng(seed)
    n = m = 2
    x = 2.0 * rng.standard_normal((B, T + 1, n))
    u = 0.3 * rng.standard_normal((B, T, m))
    eye = np.broadcast_to(np.eye(2), (B, T, 2, 2))
    W = 0.01 * np.eye(2)
    fields = dict(
        q=0.5 * (x[:, :-1] ** 2).sum(-1) - 0.05 * (u ** 2).sum(-1),
        q_vec=x[:, :-1], Q=eye, r=-0.1 * u, R=-0.1 * eye,
        P=np.zeros((B, T, m, n)), A=eye, B=eye,
        W=np.broadcast_to(W, (B, T, 2, 2)),
        W_inv=np.broadcast_to(np.linalg.inv(W), (B, T, 2, 2)),
        logdet_W=np.full((B, T), np.linalg.slogdet(W)[1]),
        q_term=0.005 * (x[:, -1] ** 2).sum(-1), q_vec_term=0.01 * x[:, -1],
        Q_term=0.01 * np.broadcast_to(np.eye(2), (B, 2, 2)))
    return fields


def test_mu_restart_loop_is_per_lane():
    fields = _negative_curvature_approx(4)
    ap_j = jric.Approximation(**{k: jnp.asarray(v) for k, v in
                                 fields.items()})
    thetas = np.array([0.0, 0.0, 1e-4, 0.0, 1e6])
    mu0 = np.array([0.0, 1e-3, 0.0, 0.5, 0.0])
    delta0 = np.full(B, 2.0)
    want = jax.vmap(lambda a, th, mu, de: jric.dp_optimize(
        a, theta=th, mu=mu, delta=de, mu_min=1e-6, delta_0=2.0, slim=True))(
            ap_j, thetas, mu0, delta0)
    ap_t = Approximation(**{k: torch.tensor(np.array(v), dtype=F64)
                            for k, v in fields.items()})
    got = tric.dp_optimize(ap_t, theta=torch.tensor(thetas),
                           mu=torch.tensor(mu0), delta=torch.tensor(delta0),
                           mu_min=1e-6, delta_0=2.0, slim=True)
    mu_j = np.asarray(want[3])
    assert np.all(mu_j[:3] > mu0[:3]), "fixture stopped restarting"
    assert mu_j[3] == mu0[3], "a lane with large μ needs no restart"
    assert len(set(mu_j[:3].tolist())) > 1, "lanes should restart apart"
    names = ("value", "L", "dl", "mu", "delta")
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    ok = ~np.asarray(want[5])
    for name, g, w in zip(names, got[:5], want[:5]):
        np.testing.assert_allclose(g.numpy()[ok], np.asarray(w)[ok],
                                   **TOL64, err_msg=name)


def test_mu_delta_schedule_matches_jax():
    mu = np.array([0.0, 1e-7, 1e-3, 2.0])
    de = np.array([2.0, 0.25, 4.0, 1.0])
    for name in ("increase_mu_delta", "decrease_mu_delta"):
        j = getattr(jric, name)(jnp.asarray(mu), jnp.asarray(de), 1e-6, 2.0)
        t = getattr(tric, name)(torch.tensor(mu), torch.tensor(de), 1e-6, 2.0)
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       err_msg=name)


def _whittle_approx(stages, terminal):
    stack = lambda k: torch.tensor(np.stack([st[k] for st in stages]))[None]
    W = np.stack([st["W"] for st in stages])
    return Approximation(
        q=stack("q"), q_vec=stack("q_vec"), Q=stack("Q"), r=stack("r"),
        R=stack("R"), P=stack("P"), A=stack("A"), B=stack("B"),
        W=torch.tensor(W), W_inv=torch.tensor(np.linalg.inv(W)),
        logdet_W=torch.tensor(np.linalg.slogdet(W)[1]),
        q_term=torch.tensor([terminal[0]], dtype=F64),
        q_vec_term=torch.tensor(terminal[1])[None],
        Q_term=torch.tensor(terminal[2])[None])


@pytest.mark.parametrize("seed,theta,w_scale", CASES)
def test_whittle_closed_form(seed, theta, w_scale):
    stages, terminal = make_stages(seed, w_scale, affine=True)
    ap = _whittle_approx(stages, terminal)
    ref = whittle_optimize(stages, terminal, theta)
    dp, L, dl, mu, _, failed = tric.dp_optimize(
        ap, theta=theta, mu=0.0, delta=2.0, mu_min=1e-6, delta_0=2.0)
    assert not bool(failed[0]) and float(mu[0]) == 0.0
    rt = dict(rtol=1e-8, atol=1e-10)
    for name in ("S", "s_vec", "s"):
        np.testing.assert_allclose(getattr(dp, name)[0, :-1].numpy(),
                                   np.stack([r[name] for r in ref]), **rt)
    for name in ("H", "G", "g"):
        np.testing.assert_allclose(getattr(dp, name)[0].numpy(),
                                   np.stack([r[name] for r in ref]), **rt)
    np.testing.assert_allclose(L[0].numpy(), np.stack([r["L"] for r in ref]),
                               **rt)
    np.testing.assert_allclose(dl[0].numpy(),
                               np.stack([r["dl"] for r in ref]), **rt)

    rng = np.random.default_rng(seed + 100)
    L_fix = np.stack([r["L"] for r in ref]) + 0.1 * rng.standard_normal(
        L[0].shape)
    dl_fix = np.stack([r["dl"] for r in ref]) + 0.1 * rng.standard_normal(
        dl[0].shape)
    vals = whittle_evaluate(stages, terminal, theta, L_fix, dl_fix)
    dp_e, failed_e = tric.dp_evaluate(ap, torch.tensor(L_fix)[None],
                                      torch.tensor(dl_fix)[None],
                                      theta=theta, mu=0.0)
    assert not bool(failed_e[0])
    for i, name in enumerate(("S", "s_vec", "s")):
        np.testing.assert_allclose(getattr(dp_e, name)[0, :-1].numpy(),
                                   np.stack([v[i] for v in vals[:-1]]), **rt)
