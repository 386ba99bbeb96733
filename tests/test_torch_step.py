"""Parity of the port's fused step (the plain version of kernel B) with the
JAX package.

  - float32 against the Pallas kernel ``step_optimize_bank`` in interpret
    mode (T=7, B=5, a θ mix whose 1e6 lane must fail), with the
    tolerances of tests/test_step_fused.py;
  - float64 against JAX ``step_optimize`` (μ-restart loop included) on the
    restart-forcing negative-curvature fixture of that file;
  - ``python -m ratilqr_tpu_torch.team_sweep step`` (or ``riccati``), which
    times kernel B's (kernel A's) team shapes, needs a card and takes only
    a kernel it knows.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ratilqr_tpu import models as jm  # noqa: E402
from ratilqr_tpu.ops import smallmat as jsm  # noqa: E402
from ratilqr_tpu.ops.step_pallas import (step_optimize as jstep,  # noqa: E402
                                         step_optimize_bank as jstep_bank)
from ratilqr_tpu.problems import RiskSensitiveProblem as JProblem  # noqa: E402
from ratilqr_tpu_torch import models as tm  # noqa: E402
from ratilqr_tpu_torch.ops.approx import noise_model  # noqa: E402
from ratilqr_tpu_torch.ops.step_cuda import (step_optimize,  # noqa: E402
                                             step_optimize_bank)
from ratilqr_tpu_torch.ops.tile_model import lqr_tile_model  # noqa: E402
from ratilqr_tpu_torch.problems import RiskSensitiveProblem  # noqa: E402

T, B = 7, 5
THETAS = np.array([0.0, 0.01, 0.05, 1e6, 0.02], np.float32)
MUS = np.array([0.0, 0.0, 1e-3, 0.0, 1e-2], np.float32)


@pytest.mark.parametrize("maker,n,m", [("unicycle", 3, 2),
                                       ("lqr_problem", 2, 2)])
def test_plain_step_matches_pallas_kernel_interpret(maker, n, m):
    f32 = torch.float32
    jp = getattr(jm, maker)(N=T, dtype=jnp.float32)
    tp = getattr(tm, maker)(N=T, dtype=f32, device="cpu")
    rng = np.random.default_rng(0)
    x0s = (0.1 * rng.standard_normal((B, n))).astype(np.float32)
    ls = (0.1 * rng.standard_normal((B, T, m))).astype(np.float32)
    Wm = jax.vmap(jp.W)(jnp.arange(T)).astype(jnp.float32)
    chol = jsm.cholesky(Wm)
    want = jstep_bank(jp.tile_model, jnp.asarray(x0s), jnp.asarray(ls),
                      jnp.asarray(THETAS), jnp.asarray(MUS), Wm,
                      jsm.cho_inverse(chol), jsm.cho_logdet(chol))
    got = step_optimize_bank(tp, torch.tensor(x0s), torch.tensor(ls),
                             torch.tensor(THETAS), torch.tensor(MUS),
                             noise_model(tp, T, f32, "cpu"))
    np.testing.assert_array_equal(got.m_fail.numpy(), np.asarray(want.m_fail))
    np.testing.assert_array_equal(got.h_fail.numpy(), np.asarray(want.h_fail))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-5,
                               atol=1e-6)
    ok = ~np.asarray(want.m_fail | want.h_fail)
    assert ok.sum() >= 3, "fixture lost its feasible lanes"
    assert not ok[3], "the θ = 1e6 lane must fail"
    np.testing.assert_allclose(got.value.numpy()[ok],
                               np.asarray(want.value)[ok], rtol=3e-5)
    np.testing.assert_allclose(got.L.numpy()[ok], np.asarray(want.L)[ok],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.dl.numpy()[ok], np.asarray(want.dl)[ok],
                               rtol=1e-4, atol=1e-5)


CU, CH = -0.05, 0.005   # negative control curvature, tiny terminal cost


def _negative_curvature_problems():
    jp = JProblem(f=lambda x, u: x + u,
                  c=lambda k, x, u: 0.5 * (x @ x) + CU * (u @ u),
                  h=lambda x: CH * (x @ x),
                  W=lambda k: 0.01 * jnp.eye(2, dtype=jnp.float64), N=T)
    tp = RiskSensitiveProblem(
        f=lambda x, u: x + u,
        c=lambda k, x, u: 0.5 * (x @ x) + CU * (u @ u),
        h=lambda x: CH * (x @ x),
        W=lambda k: 0.01 * torch.eye(2, dtype=torch.float64), N=T,
        tile_model=lqr_tile_model(u_weight=CU, term_weight=2 * CH))
    return jp, tp


def test_step_optimize_restarts_match_jax_f64():
    jp, tp = _negative_curvature_problems()
    x0s = np.array([[1.0, -0.5], [0.3, 0.2], [2.0, 1.0]])
    ls = 0.1 * np.random.default_rng(3).standard_normal((3, T, 2))
    thetas = np.zeros(3)
    mu0 = np.array([0.0, 0.0, 1e-2])
    delta0 = np.full(3, 2.0)
    want = jax.vmap(lambda x0, l, th, mu, de: jstep(
        jp, x0, l, theta=th, mu=mu, delta=de, mu_min=1e-6, delta_0=2.0))(
            x0s, ls, thetas, mu0, delta0)
    f64 = torch.float64
    got = step_optimize(tp, torch.tensor(x0s), torch.tensor(ls),
                        theta=torch.tensor(thetas), mu=torch.tensor(mu0),
                        delta=torch.tensor(delta0), mu_min=1e-6,
                        delta_0=2.0, noise=noise_model(tp, T, f64, "cpu"))
    assert np.all(np.asarray(want[4]) > mu0), "fixture stopped restarting"
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(want[6]))
    assert not np.any(np.asarray(want[6])), "fixture lanes must recover"
    for name, g, w in zip(("x", "value", "L", "dl", "mu", "delta"),
                          got[:6], want[:6]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12, err_msg=name)


def test_team_sweep_takes_the_kernel(monkeypatch):
    """``team_sweep step`` (also with ``--baseline``), ``riccati``,
    ``riccati_folded``, ``policy`` and ``flags`` exit 1 without a card, an
    unknown kernel or a stray argument 2; every team
    shape has a lane for each of the quadrotor's 12 rows of AᵀDS and 4 of
    BᵀDS (team_mat.cuh:dp_step), and kernel A's and D's shapes stage with
    one buffer or two."""
    from ratilqr_tpu_torch import team_sweep
    assert all(lanes >= 12 + 4 for lanes, _ in team_sweep.VARIANTS)
    assert all(lanes >= 12 + 4 and buffers in (1, 2)
               for lanes, _, buffers in team_sweep.RICCATI_VARIANTS)
    assert {b for *_, b in team_sweep.RICCATI_VARIANTS} == {1, 2}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert team_sweep.main(["step"]) == 1
    assert team_sweep.main(["riccati"]) == 1
    assert team_sweep.main(["riccati_folded"]) == 1
    assert team_sweep.main(["folded"]) == 2
    assert team_sweep.main(["step", "candidate"]) == 2
    assert team_sweep.main(["step", "--baseline", "csrc"]) == 1
    assert team_sweep.main(["policy"]) == 1
    assert team_sweep.main(["flags", "--baseline", "csrc"]) == 1
    assert team_sweep.main(["policy", "--baseline", "csrc"]) == 2


@pytest.mark.parametrize("kernel", ["candidate", "step"])
def test_team_sweep_small_variants_cover_the_shipped_kernels(kernel):
    """Each few-lane variant of kernels C and B takes 1 or 4 lanes a solve
    in whole warps of solves, C's stage only where K > 1, and the variants
    hold the shipped kernels (C: (4, 128, 1) and (1, 64, 0); B, which
    stages nothing: (4, 128) and (1, 64)); the flag check builds every
    level of the contraction policy."""
    from ratilqr_tpu_torch import team_sweep
    variants = team_sweep.SMALL[kernel][0]
    for K, threads, *staged in variants:
        assert K in (1, 4) and threads % 32 == 0
        assert len(staged) == (kernel == "candidate")
        assert all(v in (0, 1) and (K > 1 or not v) for v in staged)
    shipped = ({(4, 128, 1), (1, 64, 0)} if kernel == "candidate" else
               {(4, 128), (1, 64)})
    assert shipped <= set(variants)
    units = team_sweep._flag_units(kernel)
    assert set(units) == {"no_fma", "policy0", "policy1", "policy2"}
    assert units["policy2"][2] == ["-DRQ_PSD_ROUNDING=2"]


def test_team_sweep_small_variants_cover_kernel_d():
    """Each few-lane variant of kernel D takes 1 or 4 lanes a solve in
    whole warps of solves, the variants hold both kernels the shipped
    launch picks ((4, 128), and (1, 128): one solve per thread), both
    noise models are timed, the
    width cells hold RAT iLQR's and the CE generation's widths and the
    edges of the 4-lane band on 132 SMs, and the flag check builds every
    level of the contraction policy."""
    from ratilqr_tpu_torch import team_sweep
    variants, cells, width_cells, _, _ = team_sweep.SMALL["riccati_folded"]
    for K, threads in variants:
        assert K in (1, 4) and threads % 32 == 0
        assert team_sweep._small_defines("riccati_folded", (K, threads)) == [
            f"-DRQ_SMALL_LANES={K}", f"-DRQ_SMALL_THREADS={threads}",
            f"-DRQ_WIDE_THREADS={threads}"]
    assert {(4, 128), (1, 128)} <= set(variants)
    assert team_sweep.PASSES["riccati_folded"] == ("riccati_folded",
                                                   "riccati_folded_lane_w")
    assert {("unicycle", 100, 10), ("unicycle", 100, 16_384)} <= set(cells)
    widths = {B for _, _, B in width_cells}
    assert {10, 16_384, 132 * 128, 132 * 128 + 1} <= widths
    assert team_sweep._flag_units("riccati_folded").keys() == {
        "no_fma", "policy0", "policy1", "policy2"}


def test_team_sweep_small_variants_cover_kernel_a():
    """Each few-lane variant of kernel A takes 1 or 4 lanes a solve in
    whole warps of solves and reads its steps into registers (form 0) or
    stages them (1), the variants hold every kernel the shipped launch
    picks ((4, 128) in both forms, (1, 64) reading into registers), both
    slim passes are timed, and the width cells hold the edges of the
    launch's bands on 132 SMs."""
    from ratilqr_tpu_torch import team_sweep
    variants, cells, width_cells, _, _ = team_sweep.SMALL["riccati"]
    for K, threads, form in variants:
        assert K in (1, 4) and threads % 32 == 0 and form in (0, 1)
        assert team_sweep._small_defines("riccati", (K, threads, form))[-1] \
            == f"-DRQ_STEP_FORM={form}"
    assert {(4, 128, 0), (4, 128, 1), (1, 64, 0)} <= set(variants)
    assert team_sweep.PASSES["riccati"] == ("riccati", "riccati_evaluating")
    widths = {B for _, _, B in width_cells}
    assert {132 * 64, 132 * 64 + 1, 132 * 128, 132 * 128 + 1} <= widths
    assert team_sweep._flag_units("riccati").keys() == {
        "no_fma", "policy0", "policy1", "policy2"}
