"""Kernels A and D at any shape, and problems with no tile model: the port
against the JAX package (CPU, float64).

  - the plain versions of kernels A (``_riccati_core``, optimizing and
    evaluating) and D (``riccati_bank_folded_plain``) at (n, m) = (4, 1)
    and (6, 3) on ``kernel_check.random_linear`` against JAX ``_riccati_
    core`` and ``approximate_folded`` + ``dp_evaluate_folded`` on the same
    problem, built from the same numpy arrays, to 1e-10;
  - the bank on ``random_linear(6, 3)`` in the default configuration and
    with the fused flags (which, with no tile model, take their
    compositions over kernels A and D) against JAX's bank;
  - the routing of the fused flags without a tile model, the bank's device
    (the problem's), and the dimension limit, which raises before any
    build.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ratilqr_tpu import ILEQGConfig as JConfig  # noqa: E402
from ratilqr_tpu.ops import approx as japprox  # noqa: E402
from ratilqr_tpu.ops import riccati as jric  # noqa: E402
from ratilqr_tpu.ops import rollout as jroll  # noqa: E402
from ratilqr_tpu.problems import RiskSensitiveProblem as JProblem  # noqa: E402
from ratilqr_tpu.solvers import ileqg as jileqg  # noqa: E402
from ratilqr_tpu_torch import ILEQGConfig, make_batched_solver  # noqa: E402
from ratilqr_tpu_torch import kernel_check as kc  # noqa: E402
from ratilqr_tpu_torch.ops import _build, riccati_cuda  # noqa: E402
from ratilqr_tpu_torch.ops import riccati as tric  # noqa: E402
from ratilqr_tpu_torch.ops.approx import (approximate_folded,  # noqa: E402
                                          approximate_model)
from ratilqr_tpu_torch.ops.rollout import (  # noqa: E402
    rollout_open_loop, rollout_open_loop_with_jac)
from ratilqr_tpu_torch.problems import problem_device  # noqa: E402
from ratilqr_tpu_torch.solvers import ileqg as tileqg  # noqa: E402
from test_torch_riccati import _compare_core, _perturbed_policy  # noqa: E402

T, B = 8, 10
TOL = dict(rtol=1e-10, atol=1e-12)
F64 = torch.float64
CPU = torch.device("cpu")
SHAPES = [(4, 1), (6, 3)]
BANK_T = 12
BANK_THETAS = np.linspace(0.0, 0.05, 6)


def jax_random_linear(n, m, T, noise=1e-3):
    """``kernel_check.random_linear`` in JAX, from the same arrays."""
    a = {k: jnp.asarray(v) for k, v in kc.random_linear_arrays(n, m).items()}
    W = noise * jnp.eye(n)
    return JProblem(
        f=lambda x, u: a["A"] @ x + a["B"] @ u,
        c=lambda k, x, u: 0.5 * (x @ (a["q"] * x)) + 0.5 * (u @ (a["r"] * u)),
        h=lambda x: 0.5 * (x @ (a["qf"] * x)), W=lambda k: W, N=T)


def _inputs(n, m):
    """The seeded kernel-check bank: x0, l, L, θ (1e6 lanes must fail M)
    and μ, as numpy arrays."""
    _, x0, l, L, theta, mu, _ = kc.bank_inputs(f"linear{n}x{m}", T, B, F64,
                                               CPU)
    return tuple(t.numpy() for t in (x0, l, L, theta, mu))


def _port_approx(n, m):
    prob, x0, l, _, theta, mu, noise = kc.bank_inputs(f"linear{n}x{m}", T, B,
                                                      F64, CPU)
    x, A, Bm = rollout_open_loop_with_jac(prob, x0, l)
    return approximate_model(prob, l, x, A, Bm, noise), theta, mu


def _jax_approx(prob, x0, l):
    def make(x0, u):
        x, A, Bm = jroll.rollout_open_loop_with_jac(prob, x0, u)
        return japprox.approximate_model(prob, u, x, A, Bm)
    return jax.jit(jax.vmap(make))(x0, l)


@pytest.mark.parametrize("n,m", SHAPES, ids=lambda d: str(d))
def test_kernel_a_plain_matches_jax_at_any_shape(n, m):
    x0, l, _, theta, mu = _inputs(n, m)
    ap_j = _jax_approx(jax_random_linear(n, m, T), x0, l)
    ap, th, mu_t = _port_approx(n, m)
    for name in ap._fields:
        want = np.asarray(getattr(ap_j, name))
        got = getattr(ap, name).numpy()
        np.testing.assert_allclose(np.broadcast_to(got, want.shape), want,
                                   **TOL, err_msg=name)
    core = jax.jit(jax.vmap(lambda a, t, u, LL, dd: jric._riccati_core(
        a, t, u, LL, dd)))
    opt_j = jax.jit(jax.vmap(lambda a, t, u: jric._riccati_core(
        a, t, u, None, None)))(ap_j, theta, mu)
    got = tric._riccati_core(ap, th, mu_t, None, None)
    _compare_core(got, opt_j, TOL)
    assert got[3].tolist() == list(theta == 1e6)
    L, dl = _perturbed_policy(np.nan_to_num(np.asarray(opt_j[1])),
                              np.nan_to_num(np.asarray(opt_j[2])))
    _compare_core(tric._riccati_core(ap, th, mu_t, torch.tensor(L),
                                     torch.tensor(dl)),
                  core(ap_j, theta, mu, L, dl), TOL)


@pytest.mark.parametrize("n,m", SHAPES, ids=lambda d: str(d))
def test_kernel_d_plain_matches_jax_at_any_shape(n, m):
    x0, l, L, theta, mu = _inputs(n, m)
    prob_t = kc.make_problem(f"linear{n}x{m}", T, F64, CPU)
    x_ref = rollout_open_loop(prob_t, torch.tensor(x0), 0.5 * torch.tensor(l))
    fa = approximate_folded(prob_t, x_ref, torch.tensor(l), torch.tensor(L),
                            torch.tensor(mu),
                            kc.bank_inputs(f"linear{n}x{m}", T, B, F64,
                                           CPU)[-1])
    prob_j = jax_random_linear(n, m, T)

    def run(xr, ll, LL, u, th):
        fa = japprox.approximate_folded(prob_j, xr, ll, LL, u)
        return fa, jric.dp_evaluate_folded(fa, theta=th)

    fa_j, (value_j, fail_j) = jax.jit(jax.vmap(run))(x_ref.numpy(), l, L, mu,
                                                     theta)
    for name in fa._fields:
        want = np.asarray(getattr(fa_j, name))
        got = getattr(fa, name).numpy()
        np.testing.assert_allclose(np.broadcast_to(got, want.shape), want,
                                   **TOL, err_msg=name)
    got = riccati_cuda.riccati_bank_folded_plain(fa, torch.tensor(theta))
    assert got.m_fail.tolist() == np.asarray(fail_j).tolist()
    assert got.m_fail.tolist() == list(theta == 1e6)
    ok = ~np.asarray(fail_j)
    np.testing.assert_allclose(got.value.numpy()[ok],
                               np.asarray(value_j)[ok], **TOL)


BANK_CONFIGS = {
    "default": dict(),
    "fused-flags": dict(fused_step_optimize=True, fused_candidate_eval=True),
}


@pytest.mark.parametrize("name", list(BANK_CONFIGS))
def test_bank_without_tile_model_matches_jax(name):
    """random_linear(6, 3): the default configuration (kernel A on the
    card) and the fused flags (their compositions over A and D) against
    JAX's bank, which runs its XLA composition for a problem with no tile
    model."""
    n, m = 6, 3
    x0 = np.random.default_rng(4).uniform(-1.0, 1.0, n)
    u0 = np.zeros((BANK_T, m))
    flags = BANK_CONFIGS[name]
    want = jileqg.make_batched_solver(jax_random_linear(n, m, BANK_T),
                                      JConfig(**flags))(x0, u0, BANK_THETAS)
    got = make_batched_solver(
        kc.make_problem(f"linear{n}x{m}", BANK_T, F64, CPU),
        ILEQGConfig(**flags))(x0, u0, BANK_THETAS)
    assert not bool(got.failed.any())
    assert got.failed.tolist() == np.asarray(want.failed).tolist()
    assert got.iterations.tolist() == np.asarray(want.iterations).tolist()
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(got.l.numpy(), np.asarray(want.l), rtol=0,
                               atol=1e-8)


def test_fused_flags_without_tile_model_route_to_kernels_a_and_d(monkeypatch):
    """With no tile model, ``fused_step_optimize`` and ``fused_candidate_
    eval`` go through the Riccati dispatch (kernels A and D on the card),
    decided on the problem, as JAX routes to its XLA composition."""
    calls = {"riccati_bank": 0, "riccati_bank_folded": 0}
    for name in calls:
        real = getattr(riccati_cuda, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(riccati_cuda, name, spy)
    prob = kc.make_problem("linear6x3", BANK_T, F64, CPU)
    res = make_batched_solver(prob, ILEQGConfig(
        fused_step_optimize=True, fused_candidate_eval=True))(
        np.ones(6), np.zeros((BANK_T, 3)), BANK_THETAS)
    assert not bool(res.failed.any())
    assert calls["riccati_bank"] >= int(res.iterations.max())
    assert calls["riccati_bank_folded"] > int(res.iterations.max())


def test_problem_device_is_the_noise_models():
    prob = kc.random_linear(3, 2, 4, F64, "meta")
    assert problem_device(prob) == torch.device("meta")
    assert problem_device(kc.make_problem("cartpole", 4, F64, CPU)) == CPU


def test_bank_runs_on_the_problems_device(monkeypatch):
    """numpy inputs (and tensors on another device) go to the problem's
    device, unless the caller names one."""
    seen = []

    def fake_solve(problem, config, x0, u_init, theta, noise=None):
        seen.append({t.device.type for t in (x0, u_init, theta, noise.W)})
        return None

    monkeypatch.setattr(tileqg, "solve_bank", fake_solve)
    prob = kc.random_linear(3, 2, 4, F64, "meta")
    bank = make_batched_solver(prob, ILEQGConfig())
    bank(np.zeros(3), np.zeros((4, 2)), np.linspace(0.0, 0.02, 5))
    bank(torch.zeros(3), torch.zeros((4, 2)), torch.zeros(5))
    make_batched_solver(kc.random_linear(3, 2, 4, F64, CPU), ILEQGConfig(),
                        device="meta")(np.zeros(3), np.zeros((4, 2)),
                                       np.zeros(5))
    assert seen == [{"meta"}, {"meta"}, {"meta"}]


def test_shape_beyond_the_limit_raises_before_any_build(monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a build was started")

    monkeypatch.setattr(_build, "build_shape", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    big = riccati_cuda.MAX_DIM + 1
    ap, theta, mu = (lambda f: (f[0], f[3], f[4]))(kc._riccati_fixture(
        f"linear{big}x2", 2, 3, F64, CPU, True))
    kc.clear_caches()
    with pytest.raises(NotImplementedError, match=f"{riccati_cuda.MAX_DIM}"):
        riccati_cuda.riccati_layout(ap, theta, mu)
    fa = kc.folded_inputs(f"linear{big}x2", 2, 3, F64, CPU)[0]
    with pytest.raises(NotImplementedError, match=f"{riccati_cuda.MAX_DIM}"):
        riccati_cuda.folded_layout(fa, theta)
    # At the limit the layouts take the bank; the build would come at
    # launch, for a shape outside the shipped library.
    at = riccati_cuda.MAX_DIM
    ap, *_ = kc._riccati_fixture(f"linear{at}x{at}", 2, 3, F64, CPU, True)
    riccati_cuda.riccati_layout(ap, theta, mu)
    kc.clear_caches()
    assert (at, at) not in riccati_cuda.SHAPES
