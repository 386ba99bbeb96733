"""Parity of the port's fused candidate evaluation (the plain version of
kernel C) with the JAX package.

  - float32 against the Pallas kernel ``candidate_bank``, stored
    (``recompute=False``) and recompute variant, in interpret mode, with
    the tolerances of tests/test_candidate_fused.py;
  - float64 against JAX ``approximate_folded`` + ``dp_evaluate_folded``;
  - the folded value equals the unfolded evaluating pass with dl = 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ratilqr_tpu import models as jm  # noqa: E402
from ratilqr_tpu.ops import smallmat as jsm  # noqa: E402
from ratilqr_tpu.ops.approx import approximate_folded as jfold  # noqa: E402
from ratilqr_tpu.ops.candidate_pallas import (  # noqa: E402
    candidate_bank as jcand_bank)
from ratilqr_tpu.ops.riccati import dp_evaluate_folded as jeval  # noqa: E402
from ratilqr_tpu.ops.rollout import rollout_open_loop as jroll  # noqa: E402
from ratilqr_tpu_torch import models as tm  # noqa: E402
from ratilqr_tpu_torch.ops.approx import (approximate_model,  # noqa: E402
                                          noise_model)
from ratilqr_tpu_torch.ops.candidate_cuda import candidate_bank  # noqa: E402
from ratilqr_tpu_torch.ops.riccati import dp_evaluate  # noqa: E402
from ratilqr_tpu_torch.ops.rollout import (  # noqa: E402
    rollout_feedback_with_jac)

T, B = 7, 5
THETAS = np.array([0.0, 0.01, 0.05, 1e6, 0.02])
MUS = np.array([0.0, 0.0, 1e-3, 0.0, 1e-2])
MODELS = [("unicycle", 3, 2), ("lqr_problem", 2, 2)]


def _inputs(jp, n, m, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x0s = (0.1 * rng.standard_normal((B, n))).astype(dtype)
    ls = (0.1 * rng.standard_normal((B, T, m))).astype(dtype)
    Ls = (0.1 * rng.standard_normal((B, T, m, n))).astype(dtype)
    # Nominal trajectories from a DIFFERENT schedule, so the feedback term
    # is exercised.
    x_refs = np.asarray(jax.vmap(lambda x0, l: jroll(jp, x0, 0.5 * l))(
        x0s, ls)).astype(dtype)
    return x_refs, ls, Ls


@pytest.mark.parametrize("recompute", [False, True])
@pytest.mark.parametrize("maker,n,m", MODELS)
def test_plain_candidate_matches_pallas_kernel_interpret(maker, n, m,
                                                         recompute):
    f32 = torch.float32
    jp = getattr(jm, maker)(N=T, dtype=jnp.float32)
    tp = getattr(tm, maker)(N=T, dtype=f32, device="cpu")
    x_refs, ls, Ls = _inputs(jp, n, m, np.float32)
    Wm = jax.vmap(jp.W)(jnp.arange(T)).astype(jnp.float32)
    chol = jsm.cholesky(Wm)
    want = jcand_bank(jp.tile_model, jnp.asarray(x_refs), jnp.asarray(ls),
                      jnp.asarray(Ls), jnp.asarray(MUS, jnp.float32),
                      jnp.asarray(THETAS, jnp.float32), Wm,
                      jsm.cho_inverse(chol), jsm.cho_logdet(chol),
                      recompute=recompute)
    got = candidate_bank(tp, torch.tensor(x_refs), torch.tensor(ls),
                         torch.tensor(Ls), torch.tensor(MUS, dtype=f32),
                         torch.tensor(THETAS, dtype=f32),
                         noise_model(tp, T, f32, "cpu"))
    np.testing.assert_array_equal(got.m_fail.numpy(), np.asarray(want.m_fail))
    ok = ~np.asarray(want.m_fail)
    assert ok.sum() >= 3 and not ok[3], "fixture lost its fail pattern"
    np.testing.assert_allclose(got.value.numpy()[ok],
                               np.asarray(want.value)[ok], rtol=3e-5)


@pytest.mark.parametrize("maker,n,m", MODELS)
def test_plain_candidate_matches_folded_xla_f64(maker, n, m):
    f64 = torch.float64
    jp = getattr(jm, maker)(N=T, dtype=jnp.float64)
    tp = getattr(tm, maker)(N=T, dtype=f64, device="cpu")
    x_refs, ls, Ls = _inputs(jp, n, m, np.float64, seed=1)
    want_v, want_f = jax.vmap(lambda xr, l, L, mu, th: jeval(
        jfold(jp, xr, l, L, mu), theta=th))(x_refs, ls, Ls, MUS, THETAS)
    noise = noise_model(tp, T, f64, "cpu")
    got = candidate_bank(tp, torch.tensor(x_refs), torch.tensor(ls),
                         torch.tensor(Ls), torch.tensor(MUS),
                         torch.tensor(THETAS), noise)
    np.testing.assert_array_equal(got.m_fail.numpy(), np.asarray(want_f))
    ok = ~np.asarray(want_f)
    np.testing.assert_allclose(got.value.numpy()[ok],
                               np.asarray(want_v)[ok], rtol=1e-10)

    # Folding is an identity: the unfolded evaluating pass (dl = 0) over
    # the same closed-loop rollout gives the same value.
    x, u, A, Bm = rollout_feedback_with_jac(tp, torch.tensor(x_refs),
                                            torch.tensor(ls),
                                            torch.tensor(Ls))
    value, fail = dp_evaluate(approximate_model(tp, u, x, A, Bm, noise),
                              torch.tensor(Ls), theta=torch.tensor(THETAS),
                              mu=torch.tensor(MUS), slim=True)
    np.testing.assert_array_equal(fail.numpy(), got.m_fail.numpy())
    np.testing.assert_allclose(value.numpy()[ok], got.value.numpy()[ok],
                               rtol=1e-10)


def test_team_sweep_needs_a_card_and_whole_warps(monkeypatch):
    """``python -m ratilqr_tpu_torch.team_sweep`` exits 1 without a card;
    every team shape it builds fills whole warps, as candidate.cu's
    static_assert demands."""
    from ratilqr_tpu_torch import team_sweep
    for lanes, teams in team_sweep.VARIANTS:
        assert 32 % lanes == 0 and lanes * teams % 32 == 0
        assert lanes > 12   # a lane per row of the quadrotor, and one more
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert team_sweep.main() == 1
