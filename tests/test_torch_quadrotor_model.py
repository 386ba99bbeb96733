"""The port's n=12 quadrotor against the JAX package (CPU, float64): the
problem's callbacks, its tile model (against ``torch.func`` derivatives of
its own callbacks and against JAX ``quadrotor_tile_model``), the device
model the fused kernels take, a result round trip through ``convert``, and
the entry points' default device.
"""
import inspect
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ratilqr_tpu import models as jm  # noqa: E402
from ratilqr_tpu.ops import tile_model as jtile  # noqa: E402
from ratilqr_tpu_torch import convert  # noqa: E402
from ratilqr_tpu_torch import models as tm  # noqa: E402
from ratilqr_tpu_torch.ops import _build  # noqa: E402
from ratilqr_tpu_torch.ops import tile_model as ttile  # noqa: E402

TOL = dict(rtol=1e-12, atol=1e-12)
LANES = 7


def _states(seed):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((LANES, 12)),
            0.5 * rng.standard_normal((LANES, 4)))


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL,
                               err_msg=msg)


def test_callbacks_match_jax():
    jp = jm.quadrotor(N=5, goal=(1.0, -0.5, 2.0))
    tp = tm.quadrotor(N=5, goal=(1.0, -0.5, 2.0), dtype=torch.float64,
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
    assert tp.N == 5 and tp.tile_model.n == 12 and tp.tile_model.m == 4


def test_tile_model_equals_torch_ad():
    from torch.func import grad, hessian, jacfwd
    prob = tm.quadrotor(N=5, dtype=torch.float64, device="cpu")
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
    goal = (0.5, 1.5, -1.0)
    jt = jtile.quadrotor_tile_model(0.02, 9.81, goal)
    tt = ttile.quadrotor_tile_model(0.02, 9.81, goal)
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
    prob = tm.quadrotor(goal=(1.0, 2.0, 3.0), device="cpu")
    tile = prob.tile_model
    assert ttile.device_model(prob) is tile
    assert tile.model_id == ttile.QUADROTOR
    assert tile.params == (0.02, 9.81, 1.0, 2.0, 3.0)
    slots = _build.params_array(tile.params)
    assert list(slots) == [0.02, 9.81, 1.0, 2.0, 3.0, 0.0, 0.0, 0.0]
    assert len(_build.params_array(range(_build.MAX_PARAMS))) == 8
    with pytest.raises(ValueError, match="at most 8"):
        _build.params_array(range(_build.MAX_PARAMS + 1))


def test_result_round_trip_with_n12_gains():
    rng = np.random.default_rng(3)
    Bn, T = 3, 5
    arrays = {"x": rng.standard_normal((Bn, T + 1, 12)),
              "l": rng.standard_normal((Bn, T, 4)),
              "L": rng.standard_normal((Bn, T, 4, 12)),
              "value": np.array([1.0, np.inf, 2.5]),
              "eps_history": np.zeros((Bn, 0, 2)),
              "eps_count": np.array([3, 0, 4]),
              "iterations": np.array([2, 1, 3]),
              "d_final": rng.standard_normal(Bn),
              "mu_final": np.zeros(Bn),
              "failed": np.array([False, True, False])}
    res = convert.result_from_numpy(arrays, device="cpu")
    assert res.L.shape == (Bn, T, 4, 12) and res.L.dtype == torch.float64
    back = convert.result_to_numpy(res)
    for name, a in arrays.items():
        np.testing.assert_array_equal(back[name], a, err_msg=name)


@pytest.mark.parametrize("entry", [
    tm.unicycle, tm.lqr_problem, tm.double_integrator, tm.nonlinear_toy,
    tm.quadrotor, tm.cartpole, convert.result_from_numpy],
    ids=lambda f: f.__name__)
def test_entry_points_default_to_the_card(entry):
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_import_makes_no_cuda_tensor():
    """Importing every module of the port initializes no CUDA context."""
    code = ("import torch, ratilqr_tpu_torch, ratilqr_tpu_torch.models, "
            "ratilqr_tpu_torch.kernel_check, ratilqr_tpu_torch.convert, "
            "ratilqr_tpu_torch.solvers.ratilqr_jit; "
            "assert not torch.cuda.is_initialized()")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=pathlib.Path(__file__).resolve().parent.parent)


def test_bound_counts_each_byte_once():
    from ratilqr_tpu_torch import kernel_check as kc
    f32 = torch.float32
    # One more unicycle step: kernel A reads 40 words and writes 8
    # (riccati.cu), plus one step of the shared noise model (2n² + 1).
    one, _ = kc.kernel_work("riccati", 3, 2, 1, 1, f32)
    two, _ = kc.kernel_work("riccati", 3, 2, 2, 1, f32)
    assert two - one == 4 * (40 + 8) + 4 * 19
    # Kernel D streams 1 + n + 2n² words per step and lane (riccati_folded.cu).
    one, _ = kc.kernel_work("riccati_folded", 12, 4, 1, 1, f32)
    two, _ = kc.kernel_work("riccati_folded", 12, 4, 2, 1, f32)
    assert two - one == 4 * (1 + 12 + 288) + 4 * 289
    # The quadrotor bank: A and D move more bytes than their arithmetic
    # needs on an H100; B and C recompute the blocks and are bound by it.
    by = {k: kc.bound_ms(k, 12, 4, 50, 16_384, f32)[1]
          for k in ("riccati", "step", "candidate", "riccati_folded")}
    assert by == {"riccati": "bytes", "step": "operations",
                  "candidate": "operations", "riccati_folded": "bytes"}
    ms, _ = kc.bound_ms("step", 12, 4, 50, 16_384, f32)
    assert kc.bound_ms("step", 12, 4, 50, 32_768, f32)[0] == \
        pytest.approx(2 * ms)
    assert kc.bound_ms("step", 12, 4, 50, 16_384, torch.float64)[0] > ms


def test_ptxas_report_reads_the_verbose_lines():
    log = "\n".join([
        "nvcc riccati.cu: 41.2 s, exit 0",
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'",
        "ptxas info    : Function properties for _Z3fooPf",
        "    2048 bytes stack frame, 1880 bytes spill stores, "
        "2100 bytes spill loads",
        "ptxas info    : Used 255 registers, used 0 barriers, 528 bytes "
        "cmem[0]",
        "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'",
        "ptxas info    : Used 40 registers, 528 bytes cmem[0]"])
    rows = _build.ptxas_report(log)
    assert [r[1:] for r in rows] == [(255, 1880, 2100, 2048), (40, 0, 0, 0)]
    assert rows[0][0] in ("_Z3fooPf", "foo(float*)")
