"""The port's parallel-in-time Riccati DP (``ops/riccati_parallel.py``)
against the port's sequential DP and against JAX (CPU, float64).

The six cases of tests/test_riccati_parallel.py, run as one bank of lanes
(several θ and start states a case), plus the element algebra
(associativity), the neurotic-breakdown latch, an indefinite R with PSD H,
a per-lane noise model, JAX's ``combine`` live, and JAX's
``dp_optimize_parallel`` on the LQR risk case, frozen in
``tests/golden/torch_riccati_parallel.json`` (it takes ~20 s to compile
here).  The scan's tree order differs from the sequential pass, so parity
is rtol 1e-8 (the JAX tests' tolerance), not bit for bit.
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ratilqr_tpu_torch.models import (cartpole, lqr_problem,  # noqa: E402
                                      unicycle)
from ratilqr_tpu_torch.ops.approx import approximate_model  # noqa: E402
from ratilqr_tpu_torch.ops.riccati import (dp_evaluate,  # noqa: E402
                                           dp_optimize)
from ratilqr_tpu_torch.ops.riccati_parallel import (  # noqa: E402
    Element, _scan, combine, dp_evaluate_parallel, dp_optimize_parallel)
from ratilqr_tpu_torch.ops.rollout import (  # noqa: E402
    rollout_open_loop_with_jac)
from ratilqr_tpu_torch.problems import RiskSensitiveProblem  # noqa: E402

GOLDEN = (pathlib.Path(__file__).parent / "golden"
          / "torch_riccati_parallel.json")
F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-10)
DP_ARGS = dict(delta=2.0, mu_min=1e-6, delta_0=2.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops run faster on one thread than on many,
    and the suite runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_element(rng, n, batch=()):
    def normal(*shape):
        return torch.tensor(rng.normal(size=batch + shape), dtype=F64)

    A = 0.3 * normal(n, n)
    Cm, Jm = 0.3 * normal(n, n), 0.3 * normal(n, n)
    return Element(A=A, b=normal(n), C=0.1 * Cm @ Cm.transpose(-1, -2),
                   eta=normal(n), J=Jm @ Jm.transpose(-1, -2))


def _apply(e, S, v):
    n = S.shape[-1]
    z = torch.zeros((n, n), dtype=F64)
    out = combine(e, Element(A=z, b=torch.zeros(n, dtype=F64), C=z, eta=v,
                             J=S))
    return out.J, out.eta


def test_combine_is_associative_and_consistent():
    rng = np.random.default_rng(0)
    e1, e2, e3 = (_rand_element(rng, 3) for _ in range(3))
    S, v = 0.7 * torch.eye(3, dtype=F64), torch.ones(3, dtype=F64)
    S12, v12 = _apply(combine(e1, e2), S, v)
    S12b, v12b = _apply(e1, *_apply(e2, S, v))
    torch.testing.assert_close(S12, S12b, rtol=1e-10, atol=0)
    torch.testing.assert_close(v12, v12b, rtol=1e-10, atol=0)
    a = combine(combine(e1, e2), e3)
    b = combine(e1, combine(e2, e3))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("num", [1, 2, 5, 8, 13])
def test_scan_equals_sequential_fold(num):
    """The hand-written odd/even scan ≡ the left fold, every prefix, over
    two lanes."""
    rng = np.random.default_rng(num)
    elems = _rand_element(rng, 3, batch=(2, num))
    got = _scan(combine, elems)
    acc = Element(*(x[:, 0] for x in elems))
    for t in range(num):
        if t:
            acc = combine(acc, Element(*(x[:, t] for x in elems)))
        for x, y in zip(acc, got):
            torch.testing.assert_close(y[:, t], x, rtol=1e-9, atol=1e-11)


def _cross_terms(N=12):
    """Cost with x-u cross terms: the complete-the-square path."""
    return RiskSensitiveProblem(
        f=lambda x, u: x + 0.1 * u + 0.05 * torch.sin(x),
        c=lambda k, x, u: (0.5 * x @ x + u @ u + 0.3 * (x @ u)
                           + 0.1 * torch.sum(u) + 0.05 * torch.sum(x)),
        h=lambda x: 0.5 * x @ x,
        W=lambda k: 0.05 * torch.eye(2, dtype=F64), N=N)


CASES = [   # tests/test_riccati_parallel.py:76-83
    ("lqr_theta0", lambda: lqr_problem(N=10, device="cpu"), 2, 0.0, 0.0),
    ("lqr_risk", lambda: lqr_problem(N=10, noise=0.01, device="cpu"), 2,
     0.3, 0.0),
    ("cross_terms", _cross_terms, 2, 0.1, 0.0),
    ("cross_terms_mu", _cross_terms, 2, 0.05, 1e-3),
    ("unicycle", lambda: unicycle(N=20, device="cpu"), 2, 0.02, 0.0),
    ("cartpole", lambda: cartpole(N=15, device="cpu"), 1, 0.001, 0.0),
]


def _approx(prob, m, x0s, u_scale=0.1):
    """The bank approximation at ``u = u_scale`` from the rows of
    ``x0s``."""
    B = x0s.shape[0]
    u = u_scale * torch.ones((B, prob.N, m), dtype=F64)
    x, A, Bm = rollout_open_loop_with_jac(prob, x0s, u)
    return approximate_model(prob, u, x, A, Bm)


def _assert_dp(dp_p, dp_s, lanes, fields=("S", "s_vec", "s")):
    for name in fields:
        torch.testing.assert_close(getattr(dp_p, name)[lanes],
                                   getattr(dp_s, name)[lanes], **TOL)


@pytest.mark.parametrize("name,mk,m,theta,mu", CASES,
                         ids=[c[0] for c in CASES])
def test_parallel_matches_sequential(name, mk, m, theta, mu):
    """Three lanes a case: the case's θ and start 0.3·1 (the JAX case),
    then half the θ from another start, then θ = 0."""
    prob = mk()
    n = len(prob.W(0))
    x0s = torch.tensor(np.stack([0.3 * np.ones(n), 0.2 * np.ones(n),
                                 -0.1 * np.ones(n)]), dtype=F64)
    ap = _approx(prob, m, x0s)
    thetas = torch.tensor([theta, 0.5 * theta, 0.0], dtype=F64)
    seq = dp_optimize(ap, theta=thetas, mu=mu, **DP_ARGS)
    par = dp_optimize_parallel(ap, theta=thetas, mu=mu, **DP_ARGS)
    dp_s, L_s, dl_s, mu_s, delta_s, fail_s = seq
    dp_p, L_p, dl_p, mu_p, delta_p, fail_p = par
    assert torch.equal(fail_s, fail_p)
    assert torch.equal(mu_s, mu_p) and torch.equal(delta_s, delta_p)
    ok = ~fail_s
    assert bool(ok[0]), f"{name}: the JAX case's lane must be feasible"
    _assert_dp(dp_p, dp_s, ok, ("S", "s_vec", "s", "g", "G", "H"))
    torch.testing.assert_close(L_p[ok], L_s[ok], **TOL)
    torch.testing.assert_close(dl_p[ok], dl_s[ok], **TOL)

    # The evaluating pass at the optimized policy, with and without the
    # offsets.
    for dl in (dl_s, None):
        dp_es, fail_es = dp_evaluate(ap, L_s, dl, theta=thetas, mu=mu)
        dp_ep, fail_ep = dp_evaluate_parallel(ap, L_s, dl, theta=thetas,
                                              mu=mu)
        assert torch.equal(fail_es, fail_ep)
        _assert_dp(dp_ep, dp_es, ~fail_es)


def test_parallel_detects_neurotic_breakdown():
    """W = I makes θ = 0.5 infeasible (M = W⁻¹ − θS loses PSD) and θ = 0
    feasible: the parallel latch flags exactly the breakdown lane, and the
    evaluating pass reports it as m_fail."""
    prob = lqr_problem(N=10, device="cpu")
    ap = _approx(prob, 2, torch.zeros((2, 2), dtype=F64), u_scale=1.0)
    thetas = torch.tensor([0.5, 0.0], dtype=F64)
    *_, fail_s = dp_optimize(ap, theta=thetas, mu=0.0, **DP_ARGS)
    dp_p, L_p, dl_p, _, _, fail_p = dp_optimize_parallel(
        ap, theta=thetas, mu=0.0, **DP_ARGS)
    assert fail_p.tolist() == [True, False] == fail_s.tolist()
    _, m_fail = dp_evaluate_parallel(ap, L_p, dl_p, theta=thetas, mu=0.0)
    _, m_fail_s = dp_evaluate(ap, L_p, dl_p, theta=thetas, mu=0.0)
    assert m_fail.tolist() == [True, False] == m_fail_s.tolist()


def test_parallel_handles_indefinite_R_with_psd_H():
    """Indefinite R with H = R + BᵀS̃B PSD: the sequential pass succeeds
    without restarts, and so must the completed square (R̃ invertible,
    not PSD)."""
    prob = RiskSensitiveProblem(
        f=lambda x, u: x + 2.0 * u,
        c=lambda k, x, u: 0.5 * x @ x + 0.5 * u @ u - 0.6 * u[0] ** 2,
        h=lambda x: 5.0 * x @ x,
        W=lambda k: 0.05 * torch.eye(2, dtype=F64), N=8)
    ap = _approx(prob, 2, 0.3 * torch.ones((1, 2), dtype=F64))
    assert float(torch.linalg.eigvalsh(ap.R[0, 0]).min()) < 0
    dp_s, L_s, dl_s, _, _, fail_s = dp_optimize(ap, theta=0.05, mu=0.0,
                                                **DP_ARGS)
    dp_p, L_p, dl_p, _, _, fail_p = dp_optimize_parallel(
        ap, theta=0.05, mu=0.0, **DP_ARGS)
    assert not bool(fail_s.any()) and not bool(fail_p.any())
    torch.testing.assert_close(dp_p.s, dp_s.s, **TOL)
    torch.testing.assert_close(L_p, L_s, **TOL)


def test_parallel_mu_restart_and_per_lane_noise_model():
    """A per-lane noise model ``(B, T, n, n)`` and a lane whose first pass
    fails H (μ = −5, restarted by the per-lane μ loop): the restarts, μ, Δ
    and the results equal the sequential pass's."""
    prob = unicycle(N=12, device="cpu")
    x0s = torch.tensor([[0.1, 0.0, 0.2], [0.0, 0.3, -0.1]], dtype=F64)
    ap = _approx(prob, 2, x0s)
    scale = torch.tensor([1.0, 3.0], dtype=F64)[:, None, None, None]
    ap = ap._replace(W=ap.W * scale, W_inv=ap.W_inv / scale,
                     logdet_W=ap.logdet_W + 3 * torch.log(scale[:, :, 0, 0]))
    thetas = torch.tensor([0.02, 0.01], dtype=F64)
    mus = torch.tensor([0.0, -5.0], dtype=F64)
    dp_s, L_s, dl_s, mu_s, delta_s, fail_s = dp_optimize(
        ap, theta=thetas, mu=mus, **DP_ARGS)
    dp_p, L_p, dl_p, mu_p, delta_p, fail_p = dp_optimize_parallel(
        ap, theta=thetas, mu=mus, **DP_ARGS)
    assert not bool(fail_s.any()) and torch.equal(fail_s, fail_p)
    assert float(mu_s[1]) > 0, "lane 1 must have restarted"
    assert torch.equal(mu_s, mu_p) and torch.equal(delta_s, delta_p)
    _assert_dp(dp_p, dp_s, ~fail_s)
    torch.testing.assert_close(L_p, L_s, **TOL)


def test_combine_matches_live_jax():
    """JAX's ``combine`` on the same elements (eager, a few ms)."""
    import jax.numpy as jnp

    from ratilqr_tpu.ops import riccati_parallel as jrp

    rng = np.random.default_rng(5)
    e1, e2 = (_rand_element(rng, 3, batch=(4,)) for _ in range(2))
    want = jrp.combine(*(jrp.Element(*(jnp.asarray(x.numpy()) for x in e))
                         for e in (e1, e2)))
    for got, ref in zip(combine(e1, e2), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=1e-14)


def _jax_lqr_risk():
    """JAX's ``dp_optimize_parallel`` on the LQR risk case (N=10, θ=0.3,
    start 0.3·1, u = 0.1): ``{S, s_vec, s, L, dl, failed}`` as lists."""
    import jax.numpy as jnp

    from ratilqr_tpu.models import lqr_problem as jlqr
    from ratilqr_tpu.ops.approx import approximate_model as japprox
    from ratilqr_tpu.ops.riccati_parallel import dp_optimize_parallel
    from ratilqr_tpu.ops.rollout import rollout_open_loop_with_jac as jroll

    jprob = jlqr(N=10, noise=0.01)
    u = 0.1 * jnp.ones((10, 2), jnp.float64)
    x, A, Bm = jroll(jprob, 0.3 * jnp.ones(2, jnp.float64), u)
    dp, L, dl, _, _, failed = dp_optimize_parallel(
        japprox(jprob, u, x, A, Bm), theta=0.3, mu=0.0, **DP_ARGS)
    return {"S": dp.S, "s_vec": dp.s_vec, "s": dp.s, "L": L, "dl": dl,
            "failed": failed}


def test_matches_frozen_jax_dp_optimize_parallel():
    """The port's parallel DP on the LQR risk case against JAX's
    ``dp_optimize_parallel``, rtol 1e-8.  JAX's pass takes ~20 s to trace
    and compile here, so its results are frozen in
    ``tests/golden/torch_riccati_parallel.json``; regenerate them with the
    JAX package by ``PYTHONPATH=. python
    tests/test_torch_riccati_parallel.py``."""
    want = json.loads(GOLDEN.read_text())
    ap = _approx(lqr_problem(N=10, noise=0.01, device="cpu"), 2,
                 0.3 * torch.ones((1, 2), dtype=F64))
    dp, L, dl, _, _, failed = dp_optimize_parallel(ap, theta=0.3, mu=0.0,
                                                   **DP_ARGS)
    assert bool(failed[0]) == want["failed"] is False
    for name, got in (("S", dp.S), ("s_vec", dp.s_vec), ("s", dp.s),
                      ("L", L), ("dl", dl)):
        np.testing.assert_allclose(got[0].numpy(), np.array(want[name]),
                                   err_msg=name, **TOL)


if __name__ == "__main__":
    import os

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    out = {k: np.asarray(v).tolist() for k, v in _jax_lqr_risk().items()}
    GOLDEN.write_text(json.dumps(out) + "\n")
    print(f"wrote {GOLDEN}")
