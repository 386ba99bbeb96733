"""Kernels C and D on the n=12 quadrotor: their plain versions in the port
against the JAX package's XLA composition (CPU, float64).

  - ``approximate_folded`` (the closed-loop rollout, quadratization and fold
    kernel C recomputes, and the stack kernel D streams) against JAX
    ``approximate_folded``;
  - kernel D's plain version, ``riccati_bank_folded_plain``, against JAX
    ``dp_evaluate_folded`` on that stack (the θ = 1e6 lane must latch);
  - kernel C's plain version, ``candidate_bank_plain``, against the same
    JAX composition.

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
from ratilqr_tpu_torch.models import quadrotor as tquad  # noqa: E402
from ratilqr_tpu_torch.ops.approx import (approximate_folded,  # noqa: E402
                                          noise_model)
from ratilqr_tpu_torch.ops.candidate_cuda import (  # noqa: E402
    candidate_bank_plain)
from ratilqr_tpu_torch.ops.riccati_cuda import (  # noqa: E402
    riccati_bank_folded_plain)
from ratilqr_tpu_torch.ops.rollout import rollout_open_loop  # noqa: E402

T, B = 8, 6
THETAS = np.array([0.0, 0.002, 0.005, 0.01, 1e6, 0.0])
MUS = np.array([0.0, 0.0, 1e-3, 0.0, 0.0, 1e-2])
TOL = dict(rtol=1e-10, atol=1e-12)
F64 = torch.float64


def _port_inputs():
    """Seeded candidate fixture: nominal trajectories rolled out from a
    different schedule, so the feedback term L (x − x̄) is exercised."""
    rng = np.random.default_rng(1)
    prob = tquad(N=T, dtype=F64, device="cpu")
    x0 = torch.tensor(0.1 * rng.standard_normal((B, 12)))
    l = torch.tensor(0.1 * rng.standard_normal((B, T, 4)))
    L = torch.tensor(0.1 * rng.standard_normal((B, T, 4, 12)))
    x_ref = rollout_open_loop(prob, x0, 0.5 * l)
    return prob, x_ref, l, L, torch.tensor(MUS), torch.tensor(THETAS)


@pytest.fixture(scope="module")
def jax_folded():
    """JAX folded stack and its folded evaluation, per lane."""
    prob = jquad(N=T)
    _, x_ref, l, L, mu, _ = _port_inputs()

    def run(xr, ll, LL, m, th):
        fa = japprox.approximate_folded(prob, xr, ll, LL, m)
        return fa, jric.dp_evaluate_folded(fa, theta=th)

    return jax.jit(jax.vmap(run))(x_ref.numpy(), l.numpy(), L.numpy(),
                                  mu.numpy(), THETAS)


def test_approximate_folded_matches_jax(jax_folded):
    prob, x_ref, l, L, mu, _ = _port_inputs()
    fa = approximate_folded(prob, x_ref, l, L, mu,
                            noise_model(prob, T, F64, "cpu"))
    for name in fa._fields:
        want = np.asarray(getattr(jax_folded[0], name))
        got = getattr(fa, name).numpy()
        np.testing.assert_allclose(np.broadcast_to(got, want.shape), want,
                                   **TOL, err_msg=name)


def _assert_value(got, want):
    want_v, want_f = map(np.asarray, want)
    assert got.m_fail.tolist() == want_f.tolist() == list(THETAS == 1e6), \
        "exactly the θ = 1e6 lane must latch m_fail"
    ok = ~want_f
    np.testing.assert_allclose(got.value.numpy()[ok], want_v[ok], **TOL)


def test_kernel_d_plain_matches_jax(jax_folded):
    prob, x_ref, l, L, mu, theta = _port_inputs()
    fa = approximate_folded(prob, x_ref, l, L, mu,
                            noise_model(prob, T, F64, "cpu"))
    _assert_value(riccati_bank_folded_plain(fa, theta), jax_folded[1])


def test_kernel_c_plain_matches_jax(jax_folded):
    prob, x_ref, l, L, mu, theta = _port_inputs()
    got = candidate_bank_plain(prob, x_ref, l, L, mu, theta,
                               noise_model(prob, T, F64, "cpu"))
    _assert_value(got, jax_folded[1])
