"""The port's cartpole (n=4, m=1) against the JAX package (CPU, float64):
the problem's callbacks, its tile model (against ``torch.func`` derivatives
of its own callbacks, the twin of ``tests/test_candidate_fused.py::
test_tile_model_derivatives_match_ad``, and against JAX
``cartpole_tile_model``), the device model's parameter slots, and the bound
arithmetic at the cartpole's shape and at (6, 3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ratilqr_tpu import models as jm  # noqa: E402
from ratilqr_tpu.ops import tile_model as jtile  # noqa: E402
from ratilqr_tpu_torch import kernel_check as kc  # noqa: E402
from ratilqr_tpu_torch import models as tm  # noqa: E402
from ratilqr_tpu_torch.ops import _build  # noqa: E402
from ratilqr_tpu_torch.ops import tile_model as ttile  # noqa: E402

TOL = dict(rtol=1e-12, atol=1e-12)
LANES = 7
PARAMS = (0.05, 1.0, 0.1, 0.5, 9.81)   # dt, mc, mp, lp, grav


def _states(seed):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((LANES, 4)),
            0.5 * rng.standard_normal((LANES, 1)))


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL,
                               err_msg=msg)


def test_callbacks_match_jax():
    jp = jm.cartpole(N=5, dt=0.04, noise=2e-4)
    tp = tm.cartpole(N=5, dt=0.04, noise=2e-4, dtype=torch.float64,
                     device="cpu")
    x, u = _states(0)
    k = torch.tensor(2)
    for xb, ub in zip(x, u):
        xt, ut = torch.tensor(xb), torch.tensor(ub)
        _close(tp.f(xt, ut), jp.f(jnp.asarray(xb), jnp.asarray(ub)), "f")
        _close(tp.c(k, xt, ut), jp.c(2, jnp.asarray(xb), jnp.asarray(ub)),
               "c")
        _close(tp.h(xt), jp.h(jnp.asarray(xb)), "h")
    _close(tp.W(3), jp.W(3), "W")
    assert tp.N == 5 and tp.tile_model.n == 4 and tp.tile_model.m == 1


def test_tile_model_equals_torch_ad():
    from torch.func import grad, hessian, jacfwd
    prob = tm.cartpole(N=5, dtype=torch.float64, device="cpu")
    tile = prob.tile_model
    x, u = map(torch.tensor, _states(1))
    k = torch.tensor(3)
    xn, A, Bm = tile.f_jac(x, u)
    q, qv, Q, r, R, P = tile.quad(k, x, u)
    qT, qvT, QT = tile.term(x)
    for b in range(LANES):
        xb, ub = x[b], u[b]
        _close(xn[b], prob.f(xb, ub), "f")
        _close(A[b], jacfwd(prob.f, argnums=0)(xb, ub), "A")
        _close(Bm[b], jacfwd(prob.f, argnums=1)(xb, ub), "B")
        _close(q[b], prob.c(k, xb, ub), "q")
        _close(qv[b], grad(prob.c, argnums=1)(k, xb, ub), "q_vec")
        _close(Q[b], hessian(prob.c, argnums=1)(k, xb, ub), "Q")
        _close(r[b], grad(prob.c, argnums=2)(k, xb, ub), "r")
        _close(R[b], hessian(prob.c, argnums=2)(k, xb, ub), "R")
        _close(P[b], jacfwd(grad(prob.c, argnums=2), argnums=1)(k, xb, ub),
               "P")
        _close(qT[b], prob.h(xb), "h")
        _close(qvT[b], grad(prob.h)(xb), "h_x")
        _close(QT[b], hessian(prob.h)(xb), "h_xx")


def test_tile_model_matches_jax_tile_model():
    """The port's lane-batched ``(lanes, n)`` formulas against JAX's
    component-indexed ``(n, lanes)`` ones."""
    jt = jtile.cartpole_tile_model(*PARAMS)
    tt = ttile.cartpole_tile_model(*PARAMS)
    x, u = _states(2)
    xt, ut = torch.tensor(x), torch.tensor(u)
    xj, uj = jnp.asarray(x.T), jnp.asarray(u.T)

    def lanes_last(a):   # port (lanes, ...) -> JAX (..., lanes)
        return np.moveaxis(a.numpy(), 0, -1)

    for got, want in zip(tt.f_jac(xt, ut), jt.f_jac_tile(xj, uj)):
        _close(lanes_last(got), want, "f_jac")
    for got, want in zip(tt.quad(torch.tensor(4), xt, ut),
                         jt.quad_tile(jnp.int32(4), xj, uj)):
        _close(lanes_last(got), want, "quad")
    for got, want in zip(tt.term(xt), jt.term_tile(xj)):
        _close(lanes_last(got), want, "term")


def test_device_model_and_parameter_slots():
    prob = tm.cartpole(device="cpu")
    tile = prob.tile_model
    assert ttile.device_model(prob) is tile
    assert tile.model_id == ttile.CARTPOLE == 3
    assert tile.params == PARAMS
    assert list(_build.params_array(tile.params)) == list(PARAMS) + [0.0] * 3


def test_bound_counts_at_the_new_shapes():
    """The bound arithmetic takes m = 1 and (6, 3): one more step adds each
    kernel's streamed words once."""
    f32 = torch.float32
    for n, m in ((4, 1), (6, 3)):
        one, ops1 = kc.kernel_work("riccati", n, m, 1, 1, f32)
        two, ops2 = kc.kernel_work("riccati", n, m, 2, 1, f32)
        words = 1 + n + 2 * n * n + m + m * m + 2 * m * n + m * n + m
        assert two - one == 4 * words + 4 * (2 * n * n + 1)
        assert ops2 - ops1 == kc.dp_step_ops(n, m) > 0
        one, _ = kc.kernel_work("riccati_folded", n, m, 1, 1, f32)
        two, _ = kc.kernel_work("riccati_folded", n, m, 2, 1, f32)
        assert two - one == 4 * (1 + n + 2 * n * n) + 4 * (2 * n * n + 1)
    for kernel in ("riccati", "step", "candidate", "riccati_folded"):
        ms, by = kc.bound_ms(kernel, 4, 1, 50, 16_384, f32)
        assert ms > 0 and by in ("bytes", "operations")
    assert kc.model_dims("cartpole") == (4, 1)
    assert kc.model_dims("linear6x3") == (6, 3)
