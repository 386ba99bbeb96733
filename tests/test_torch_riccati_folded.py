"""Parity of the port's folded evaluating pass (the plain version of
kernel D) with the JAX package.

  - float32 against the Pallas kernel ``riccati_bank_folded`` in interpret
    mode, on the fixture of tests/test_pallas.py:187-201, shared and
    per-lane noise model, fail flags equal;
  - float64 ``dp_evaluate_folded`` against JAX ``dp_evaluate_folded``;
  - the fold identity: the folded pass equals the unfolded evaluating pass
    with dl = 0, closed loop (line-search trials) and open loop
    (``initialize!``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ratilqr_tpu.models import unicycle as juni  # noqa: E402
from ratilqr_tpu.ops.approx import approximate_folded as jfold  # noqa: E402
from ratilqr_tpu.ops.riccati import dp_evaluate_folded as jeval  # noqa: E402
from ratilqr_tpu.ops.riccati_pallas import (  # noqa: E402
    riccati_bank_folded as jbank_folded)
from ratilqr_tpu_torch.models import unicycle as tuni  # noqa: E402
from ratilqr_tpu_torch.ops.approx import (FoldedApprox,  # noqa: E402
                                          approximate_folded,
                                          approximate_model, noise_model)
from ratilqr_tpu_torch.ops.riccati import (dp_evaluate,  # noqa: E402
                                           dp_evaluate_folded)
from ratilqr_tpu_torch.ops.riccati_cuda import (  # noqa: E402
    riccati_bank_folded)
from ratilqr_tpu_torch.ops.rollout import (  # noqa: E402
    rollout_feedback_with_jac, rollout_open_loop_with_jac)

T, B = 7, 5
MUS = np.array([0.0, 0.0, 1e-3, 0.0, 0.4])
W_FIELDS = ("W", "W_inv", "logdet_W")
THETAS = {"fixture": np.array([0.0, 0.01, 0.05, 0.1, 0.02]),
          "breakdown": np.array([0.0, 0.01, 0.05, 1e6, 0.02])}


def _jax_folded(dtype):
    """The folded stack of tests/test_pallas.py's ``folded_inputs``, per
    lane (the noise model too); returns (stack, (x_ref, l, L, mu))."""
    prob = juni(N=T, dtype=dtype)
    x_ref = 0.1 * jax.random.normal(jax.random.key(2), (B, T + 1, 3), dtype)
    ls = 0.1 * jax.random.normal(jax.random.key(3), (B, T, 2), dtype)
    Ls = 0.2 * jax.random.normal(jax.random.key(4), (B, T, 2, 3), dtype)
    mus = jnp.asarray(MUS, dtype)
    fa = jax.vmap(lambda xr, l, L, mu: jfold(prob, xr, l, L, mu))(
        x_ref, ls, Ls, mus)
    return fa, (x_ref, ls, Ls, mus)


def _shared(fa):
    return fa._replace(**{k: getattr(fa, k)[0] for k in W_FIELDS})


def _to_torch(fa_j, dtype):
    return FoldedApprox(**{k: torch.tensor(np.array(getattr(fa_j, k)),
                                           dtype=dtype)
                           for k in fa_j._fields})


@pytest.mark.parametrize("thetas", list(THETAS))
@pytest.mark.parametrize("shared_w", [True, False])
def test_plain_matches_pallas_kernel_interpret(shared_w, thetas):
    fa_j, _ = _jax_folded(jnp.float32)
    if shared_w:
        fa_j = _shared(fa_j)
    th = THETAS[thetas]
    want = jbank_folded(fa_j, jnp.asarray(th, jnp.float32))
    got = riccati_bank_folded(_to_torch(fa_j, torch.float32),
                              torch.tensor(th, dtype=torch.float32))
    np.testing.assert_array_equal(got.m_fail.numpy(), np.asarray(want.m_fail))
    ok = ~np.asarray(want.m_fail)
    assert ok.sum() >= 4 and ok[3] == (thetas == "fixture")
    np.testing.assert_allclose(got.value.numpy()[ok],
                               np.asarray(want.value)[ok], rtol=3e-5)


@pytest.mark.parametrize("shared_w", [True, False])
def test_dp_evaluate_folded_matches_jax_f64(shared_w):
    fa_j, _ = _jax_folded(jnp.float64)
    if shared_w:
        fa_j = _shared(fa_j)
    th = THETAS["breakdown"]
    axes = type(fa_j)(**{k: None if shared_w and k in W_FIELDS else 0
                         for k in fa_j._fields})
    want_v, want_f = jax.vmap(lambda fa, t: jeval(fa, theta=t),
                              in_axes=(axes, 0))(fa_j, th)
    got_v, got_f = dp_evaluate_folded(_to_torch(fa_j, torch.float64),
                                      theta=torch.tensor(th))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    ok = ~np.asarray(want_f)
    np.testing.assert_allclose(got_v.numpy()[ok], np.asarray(want_v)[ok],
                               rtol=1e-10)


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_fold_identity(loop):
    """Folded value == unfolded evaluating pass (dl = 0) on the same
    rollout: closed loop around x̄ with gains L, or open loop with L = 0."""
    f64 = torch.float64
    prob = tuni(N=T, dtype=f64, device="cpu")
    noise = noise_model(prob, T, f64, "cpu")
    _, args = _jax_folded(jnp.float64)
    x_ref, l, L, mu = (torch.tensor(np.array(a)) for a in args)
    theta = torch.tensor(THETAS["breakdown"])
    if loop == "closed":
        fa = approximate_folded(prob, x_ref, l, L, mu, noise)
        x, u, A, Bm = rollout_feedback_with_jac(prob, x_ref, l, L)
    else:
        L, mu = torch.zeros_like(L), torch.zeros_like(mu)
        fa = approximate_folded(prob, x_ref[:, 0], l, noise=noise)
        x, A, Bm = rollout_open_loop_with_jac(prob, x_ref[:, 0], l)
        u = l
    v_fold, f_fold = dp_evaluate_folded(fa, theta=theta)
    v_ref, f_ref = dp_evaluate(approximate_model(prob, u, x, A, Bm, noise),
                               L, theta=theta, mu=mu, slim=True)
    assert torch.equal(f_fold, f_ref) and bool(f_ref[3]) and int(
        f_ref.sum()) == 1
    torch.testing.assert_close(v_fold[~f_ref], v_ref[~f_ref], rtol=1e-10,
                               atol=0)


def test_wrapper_raises_off_cpu_and_cuda():
    fa = FoldedApprox(*[torch.empty(s, device="meta") for s in (
        (B, T), (B, T, 3), (B, T, 3, 3), (B, T, 3, 3), (T, 3, 3), (T, 3, 3),
        (T,), (B,), (B, 3), (B, 3, 3))])
    with pytest.raises(NotImplementedError):
        riccati_bank_folded(fa, torch.empty(B, device="meta"))
