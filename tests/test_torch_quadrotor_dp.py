"""Kernels A and B on the n=12 quadrotor: their plain versions in the port
against the JAX package's XLA composition (CPU, float64).

  - the rollout with Jacobians and ``approximate_model`` (the blocks kernel
    A streams and kernel B recomputes) against JAX ``rollout_open_loop_
    with_jac`` + ``approximate_model``;
  - kernel A's plain version, ``_riccati_core`` optimizing and evaluating,
    against JAX ``_riccati_core`` (the θ = 1e6 lane must latch m_fail);
  - kernel B's plain version, ``step_optimize_bank_plain``, against the same
    JAX composition, slim; and with μ = −1e6 on a θ = 0 lane (the n=12
    h_fail fixture of ``kernel_check.H_FAIL``), its h_fail and m_fail lanes
    against JAX's.

T=8, B=6, rtol 1e-10.  The Pallas kernels in interpret mode are not the
reference here: at n=12 they take a minute or more each on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from ratilqr_tpu.models import quadrotor as jquad  # noqa: E402
from ratilqr_tpu.ops import approx as japprox  # noqa: E402
from ratilqr_tpu.ops import riccati as jric  # noqa: E402
from ratilqr_tpu.ops import rollout as jroll  # noqa: E402
from ratilqr_tpu_torch.models import quadrotor as tquad  # noqa: E402
from ratilqr_tpu_torch.ops import riccati as tric  # noqa: E402
from ratilqr_tpu_torch.ops.approx import (approximate_model,  # noqa: E402
                                          noise_model)
from ratilqr_tpu_torch.ops.riccati_cuda import (  # noqa: E402
    riccati_bank_plain)
from ratilqr_tpu_torch.ops.rollout import (  # noqa: E402
    rollout_open_loop_with_jac)
from ratilqr_tpu_torch.ops.step_cuda import (  # noqa: E402
    step_optimize_bank_plain)
from test_torch_riccati import _compare_core, _perturbed_policy  # noqa: E402

T, B = 8, 6
THETAS = np.array([0.0, 0.002, 0.005, 0.01, 1e6, 0.0])
MUS = np.array([0.0, 0.0, 1e-3, 0.0, 0.0, 1e-2])
# Lane 0 (θ = 0) fails H and not M; lane 4 (θ = 1e6) fails M.
MUS_H_FAIL = np.array([-1e6, 0.0, 1e-3, 0.0, 0.0, 1e-2])
TOL = dict(rtol=1e-10, atol=1e-12)
F64 = torch.float64


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((B, 12)),
            0.1 * rng.standard_normal((B, T, 4)))


@pytest.fixture(scope="module")
def jax_stack():
    """JAX rollout with Jacobians and approximation of the bank."""
    prob = jquad(N=T)
    x0, u = _inputs()

    def make(x0, u):
        x, A, Bm = jroll.rollout_open_loop_with_jac(prob, x0, u)
        return (x, A, Bm), japprox.approximate_model(prob, u, x, A, Bm)

    return jax.jit(jax.vmap(make))(x0, u)


# One compiled optimizing core for every μ mix of this file.
_jax_optimize = jax.jit(jax.vmap(lambda a, th, mu: jric._riccati_core(
    a, th, mu, None, None)))


@pytest.fixture(scope="module")
def jax_optimizing(jax_stack):
    return _jax_optimize(jax_stack[1], THETAS, MUS)


def _port_stack():
    prob = tquad(N=T, dtype=F64, device="cpu")
    x0, u = map(torch.tensor, _inputs())
    x, A, Bm = rollout_open_loop_with_jac(prob, x0, u)
    noise = noise_model(prob, T, F64, "cpu")
    return prob, x0, u, noise, (x, A, Bm), approximate_model(prob, u, x, A,
                                                             Bm, noise)


def test_approximation_matches_jax(jax_stack):
    _, _, _, _, traj, ap = _port_stack()
    (x_j, A_j, B_j), ap_j = jax_stack
    for got, want in zip(traj, (x_j, A_j, B_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ap._fields:
        want = np.asarray(getattr(ap_j, name))
        got = getattr(ap, name).numpy()
        np.testing.assert_allclose(np.broadcast_to(got, want.shape), want,
                                   **TOL, err_msg=name)


def test_kernel_a_plain_optimizing_matches_jax(jax_optimizing):
    *_, ap = _port_stack()
    got = tric._riccati_core(ap, torch.tensor(THETAS), torch.tensor(MUS),
                             None, None)
    _compare_core(got, jax_optimizing, TOL)
    assert got[3].tolist() == list(THETAS == 1e6), \
        "exactly the θ = 1e6 lane must latch m_fail"


def test_kernel_a_plain_evaluating_matches_jax(jax_stack, jax_optimizing):
    *_, ap = _port_stack()
    L, dl = _perturbed_policy(np.nan_to_num(np.asarray(jax_optimizing[1])),
                              np.nan_to_num(np.asarray(jax_optimizing[2])))
    want = jax.jit(jax.vmap(lambda a, th, mu, LL, dd: jric._riccati_core(
        a, th, mu, LL, dd)))(jax_stack[1], THETAS, MUS, L, dl)
    got = tric._riccati_core(ap, torch.tensor(THETAS), torch.tensor(MUS),
                             torch.tensor(L), torch.tensor(dl))
    _compare_core(got, want, TOL)
    slim = riccati_bank_plain(ap, torch.tensor(THETAS), torch.tensor(MUS),
                              torch.tensor(L), torch.tensor(dl), slim=True)
    ok = ~slim.m_fail
    np.testing.assert_allclose(slim.value[ok].numpy(),
                               np.asarray(want[0].s)[ok.numpy(), 0], **TOL)


def test_kernel_b_plain_matches_jax(jax_stack, jax_optimizing):
    prob, x0, u, noise, _, _ = _port_stack()
    got = step_optimize_bank_plain(prob, x0, u, torch.tensor(THETAS),
                                   torch.tensor(MUS), noise)
    dp, L, dl, m_fail, h_fail = jax_optimizing
    assert got.m_fail.tolist() == np.asarray(m_fail).tolist()
    assert got.h_fail.tolist() == np.asarray(h_fail).tolist()
    ok = ~(np.asarray(m_fail) | np.asarray(h_fail))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(jax_stack[0][0]),
                               **TOL)
    np.testing.assert_allclose(got.value.numpy()[ok],
                               np.asarray(dp.s)[ok, 0], **TOL)
    np.testing.assert_allclose(got.L.numpy()[ok], np.asarray(L)[ok], **TOL)
    np.testing.assert_allclose(got.dl.numpy()[ok], np.asarray(dl)[ok],
                               **TOL)


def test_kernel_b_plain_latches_h_fail_as_jax(jax_stack):
    """μ = −1e6 at θ = 0 makes H negative definite while M = W⁻¹ is not:
    the lane latches h_fail and not m_fail in both packages, and the other
    lanes agree as in :func:`test_kernel_b_plain_matches_jax`."""
    prob, x0, u, noise, _, _ = _port_stack()
    got = step_optimize_bank_plain(prob, x0, u, torch.tensor(THETAS),
                                   torch.tensor(MUS_H_FAIL), noise)
    dp, L, dl, m_fail, h_fail = _jax_optimize(jax_stack[1], THETAS,
                                              MUS_H_FAIL)
    assert got.h_fail.tolist() == np.asarray(h_fail).tolist()
    assert got.m_fail.tolist() == np.asarray(m_fail).tolist()
    assert got.h_fail.tolist() == list(MUS_H_FAIL == -1e6)
    assert got.m_fail.tolist() == list(THETAS == 1e6)
    ok = ~(np.asarray(m_fail) | np.asarray(h_fail))
    np.testing.assert_allclose(got.value.numpy()[ok],
                               np.asarray(dp.s)[ok, 0], **TOL)
    np.testing.assert_allclose(got.L.numpy()[ok], np.asarray(L)[ok], **TOL)
    np.testing.assert_allclose(got.dl.numpy()[ok], np.asarray(dl)[ok],
                               **TOL)
