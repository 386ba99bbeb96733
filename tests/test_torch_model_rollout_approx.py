"""Parity of the port's models, rollouts and approximations with the JAX
package, in float64.

The same problem is built in both packages from the same constructor
arguments, the same numpy inputs go through ``jax.vmap`` of the JAX
function and through the port's bank function, and the results agree to
rtol 1e-12 (same formulas; AD in both).  The port's tile models must equal
``torch.func`` derivatives of the problem callbacks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ratilqr_tpu import models as jm  # noqa: E402
from ratilqr_tpu.ops import approx as japprox  # noqa: E402
from ratilqr_tpu.ops import rollout as jroll  # noqa: E402
from ratilqr_tpu_torch import models as tm  # noqa: E402
from ratilqr_tpu_torch.ops import approx as tapprox  # noqa: E402
from ratilqr_tpu_torch.ops import rollout as troll  # noqa: E402
from ratilqr_tpu_torch.ops.tile_model import lqr_tile_model  # noqa: E402
from ratilqr_tpu_torch.problems import RiskSensitiveProblem  # noqa: E402

T, B = 9, 4
F64 = torch.float64
TOL = dict(rtol=1e-12, atol=1e-12, equal_nan=True)

MODELS = {
    "unicycle": (dict(), 3, 2, "unicycle"),
    "unicycle_fjac": (dict(analytic_jacobians=True), 3, 2, "unicycle"),
    "lqr": (dict(noise=0.5), 2, 2, "lqr_problem"),
    "double_integrator": (dict(), 2, 2, "double_integrator"),
    "nonlinear_toy": (dict(), 2, 2, "nonlinear_toy"),
}


def _problems(key):
    kw, n, m, maker = MODELS[key]
    return (getattr(jm, maker)(N=T, dtype=jnp.float64, **kw),
            getattr(tm, maker)(N=T, dtype=F64, **kw), n, m)


def _inputs(key, n, m, seed=0):
    rng = np.random.default_rng(seed)
    if key == "nonlinear_toy":   # fractional powers: keep x, u positive
        x0 = rng.uniform(0.1, 0.5, (B, n))
        u = rng.uniform(0.05, 0.2, (B, T, m))
        L = 0.01 * rng.standard_normal((B, T, m, n))
    else:
        x0 = 0.3 * rng.standard_normal((B, n))
        u = 0.3 * rng.standard_normal((B, T, m))
        L = 0.2 * rng.standard_normal((B, T, m, n))
    return x0, u, L


def _t(a):
    return torch.tensor(np.array(a), dtype=F64)


def _close(t, j, msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **TOL,
                               err_msg=msg)


@pytest.mark.parametrize("key", sorted(MODELS))
def test_rollouts_match_jax(key):
    jp, tp, n, m = _problems(key)
    x0, u, L = _inputs(key, n, m)
    x_ref = np.asarray(jax.vmap(lambda a, b: jroll.rollout_open_loop(
        jp, a, 0.5 * b))(x0, u))

    _close(troll.rollout_open_loop(tp, _t(x0), _t(u)),
           jax.vmap(lambda a, b: jroll.rollout_open_loop(jp, a, b))(x0, u))
    for got, want in zip(
            troll.rollout_open_loop_with_jac(tp, _t(x0), _t(u)),
            jax.vmap(lambda a, b: jroll.rollout_open_loop_with_jac(
                jp, a, b))(x0, u)):
        _close(got, want, "open loop with jac")
    for got, want in zip(
            troll.rollout_feedback(tp, _t(x_ref), _t(u), _t(L)),
            jax.vmap(lambda a, b, c: jroll.rollout_feedback(jp, a, b, c))(
                x_ref, u, L)):
        _close(got, want, "feedback")
    for got, want in zip(
            troll.rollout_feedback_with_jac(tp, _t(x_ref), _t(u), _t(L)),
            jax.vmap(lambda a, b, c: jroll.rollout_feedback_with_jac(
                jp, a, b, c))(x_ref, u, L)):
        _close(got, want, "feedback with jac")


@pytest.mark.parametrize("key", sorted(MODELS))
def test_approximate_model_matches_jax(key):
    jp, tp, n, m = _problems(key)
    x0, u, _ = _inputs(key, n, m, seed=1)
    x, A, Bm = troll.rollout_open_loop_with_jac(tp, _t(x0), _t(u))
    got = tapprox.approximate_model(tp, _t(u), x, A, Bm)
    want = jax.vmap(lambda uu, xx, aa, bb: japprox.approximate_model(
        jp, uu, xx, aa, bb))(u, x.numpy(), A.numpy(), Bm.numpy())
    for name in japprox.Approximation._fields:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        _close(np.broadcast_to(g, w.shape), w, name)
    # The Jacobian-recomputing path (no A/B passed) gives the same stack.
    again = tapprox.approximate_model(tp, _t(u), x)
    _close(again.A, got.A)
    _close(again.B, got.B)


@pytest.mark.parametrize("key", sorted(MODELS))
def test_approximate_folded_matches_jax(key):
    jp, tp, n, m = _problems(key)
    x0, u, L = _inputs(key, n, m, seed=2)
    x_ref = troll.rollout_open_loop(tp, _t(x0), 0.5 * _t(u))
    mu = np.array([0.0, 1e-3, 0.1, 1.0])
    got = tapprox.approximate_folded(tp, x_ref, _t(u), _t(L), _t(mu))
    want = jax.vmap(lambda xr, uu, LL, mm: japprox.approximate_folded(
        jp, xr, uu, LL, mm))(x_ref.numpy(), u, L, mu)
    for name in japprox.FoldedApprox._fields:
        w = np.asarray(getattr(want, name))
        _close(np.broadcast_to(getattr(got, name).numpy(), w.shape), w, name)
    # Open loop (the initialize! evaluation): x_ref is the initial state.
    got0 = tapprox.approximate_folded(tp, _t(x0), _t(u))
    want0 = jax.vmap(lambda a, b: japprox.approximate_folded(jp, a, b))(
        x0, u)
    for name in ("q", "q_vec", "Q", "A", "q_term", "q_vec_term", "Q_term"):
        _close(getattr(got0, name), getattr(want0, name), name)


def _negative_curvature_problem():
    """The restart-forcing fixture of tests/test_step_fused.py: control cost
    −0.05·u·u, terminal cost 0.005·x·x."""
    return RiskSensitiveProblem(
        f=lambda x, u: x + u,
        c=lambda k, x, u: 0.5 * (x @ x) - 0.05 * (u @ u),
        h=lambda x: 0.005 * (x @ x),
        W=lambda k: 0.01 * torch.eye(2, dtype=F64), N=T,
        tile_model=lqr_tile_model(u_weight=-0.05, term_weight=0.01))


@pytest.mark.parametrize("which", ["unicycle", "lqr", "negative_curvature"])
def test_tile_model_equals_torch_ad(which):
    from torch.func import grad, hessian, jacfwd
    prob = {"unicycle": lambda: tm.unicycle(N=T, dtype=F64),
            "lqr": lambda: tm.lqr_problem(N=T, dtype=F64),
            "negative_curvature": _negative_curvature_problem}[which]()
    tile = prob.tile_model
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((6, tile.n)))
    u = _t(rng.standard_normal((6, tile.m)))
    k = torch.tensor(3)
    xn, A, Bm = tile.f_jac(x, u)
    q, qv, Q, r, R, P = tile.quad(k, x, u)
    qT, qvT, QT = tile.term(x)
    for b in range(x.shape[0]):
        xb, ub = x[b], u[b]
        _close(xn[b], prob.f(xb, ub))
        _close(A[b], jacfwd(prob.f, argnums=0)(xb, ub))
        _close(Bm[b], jacfwd(prob.f, argnums=1)(xb, ub))
        _close(q[b], prob.c(k, xb, ub))
        _close(qv[b], grad(prob.c, argnums=1)(k, xb, ub))
        _close(Q[b], hessian(prob.c, argnums=1)(k, xb, ub))
        _close(r[b], grad(prob.c, argnums=2)(k, xb, ub))
        _close(R[b], hessian(prob.c, argnums=2)(k, xb, ub))
        _close(P[b], jacfwd(grad(prob.c, argnums=2), argnums=1)(k, xb, ub))
        _close(qT[b], prob.h(xb))
        _close(qvT[b], grad(prob.h)(xb))
        _close(QT[b], hessian(prob.h)(xb))
