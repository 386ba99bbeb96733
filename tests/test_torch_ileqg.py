"""Parity of the port's iLEQG solver bank with the JAX bank, CPU float64.

The port writes out the per-lane masks that JAX gets from ``vmap`` of
``lax.while_loop``; the two banks must take the same decisions lane for
lane (``iterations``, ``eps_count``, ``failed`` equal) and reach the same
solution (``value`` rtol 1e-9; ``l``, ``L`` atol 1e-8), cold and
warm-started through ``ratilqr_tpu_torch.convert``.  The horizon-100 case
is in tests/test_torch_ileqg_horizon100.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import ratilqr_tpu as J  # noqa: E402
import ratilqr_tpu_torch as P  # noqa: E402
from ratilqr_tpu.models import unicycle as junicycle  # noqa: E402
from ratilqr_tpu_torch import convert  # noqa: E402
from ratilqr_tpu_torch.models import (lqr_problem,  # noqa: E402
                                      unicycle as tunicycle)

THETAS = np.array([0.0, 0.005, 0.02, 1e6])
BENCH = dict(adaptive_eps_init=True, eps_history_cap=0,
             fused_candidate_eval=True, fused_step_optimize=True)
X_MPC = np.array([0.05, -0.03, 0.01])


def assert_banks_match(res_t, res_j, hist=True):
    """The bank-parity contract of this file and the horizon-100 one."""
    j = convert.result_to_numpy(res_j)
    t = convert.result_to_numpy(res_t)
    for name in ("iterations", "eps_count", "failed"):
        np.testing.assert_array_equal(t[name], j[name], err_msg=name)
    np.testing.assert_allclose(t["value"], j["value"], rtol=1e-9)
    ok = ~j["failed"]
    for name in ("l", "L", "x"):
        np.testing.assert_allclose(t[name][ok], j[name][ok], rtol=0,
                                   atol=1e-8, err_msg=name)
    if hist:
        np.testing.assert_allclose(t["eps_history"][ok],
                                   j["eps_history"][ok], rtol=0, atol=1e-8)


def run_cold_and_warm(T, cfg_kw):
    """Cold solve from zeros, then a warm re-plan at a perturbed state from
    lane 0's schedule carried over from the JAX result (bench.py:132-147).
    Returns ((torch cold, jax cold), (torch warm, jax warm))."""
    jbank = J.make_batched_solver(junicycle(N=T), J.ILEQGConfig(**cfg_kw))
    cfg_t = convert.config_from_dict(
        convert.config_to_dict(J.ILEQGConfig(**cfg_kw)))
    tbank = P.make_batched_solver(tunicycle(N=T), cfg_t)
    x0 = np.zeros(3)
    u0 = np.zeros((T, 2))
    cold_j = jbank(jnp.asarray(x0), jnp.asarray(u0), jnp.asarray(THETAS))
    cold_t = tbank(torch.tensor(x0), torch.tensor(u0), torch.tensor(THETAS))
    carried = convert.result_from_numpy(convert.result_to_numpy(cold_j))
    u_warm = carried.l[0].numpy()
    warm_j = jbank(jnp.asarray(x0 + X_MPC), jnp.asarray(u_warm),
                   jnp.asarray(THETAS))
    warm_t = tbank(torch.tensor(x0 + X_MPC), torch.tensor(u_warm),
                   torch.tensor(THETAS))
    return (cold_t, cold_j), (warm_t, warm_j)


@pytest.mark.parametrize("config", ["default", "bench"])
def test_bank_matches_jax_cold_and_warm(config):
    cfg_kw = BENCH if config == "bench" else {}
    (cold_t, cold_j), (warm_t, warm_j) = run_cold_and_warm(20, cfg_kw)
    assert bool(cold_j.failed[3]) and not np.any(np.asarray(
        cold_j.failed[:3])), "θ = 1e6 must be the only failed lane"
    assert_banks_match(cold_t, cold_j)
    assert_banks_match(warm_t, warm_j)
    assert int(warm_t.iterations[0]) < int(cold_t.iterations[0])


def test_single_solve_is_a_one_lane_bank():
    prob = lqr_problem(N=8, noise=0.01)
    cfg = P.ILEQGConfig(iter_max=20)
    x0 = torch.tensor([2.0, -1.0], dtype=torch.float64)
    u0 = torch.zeros((8, 2), dtype=torch.float64)
    one = P.solve(prob, cfg, x0, u0, 0.1)
    bank = P.make_batched_solver(prob, cfg)(x0, u0, torch.tensor([0.0, 0.1]))
    assert one.value.dim() == 0
    torch.testing.assert_close(one.value, bank.value[1])
    torch.testing.assert_close(one.l, bank.l[1])
    assert float(bank.value[1]) > float(bank.value[0]), \
        "risk sensitivity must raise the cost"
    jres = J.ileqg_solve(J.models.lqr_problem(N=8, noise=0.01),
                         J.ILEQGConfig(iter_max=20), jnp.asarray(x0.numpy()),
                         jnp.asarray(u0.numpy()), 0.1)
    np.testing.assert_allclose(one.value.numpy(), np.asarray(jres.value),
                               rtol=1e-9)


def test_config_and_result_cross_packages():
    cfg = J.ILEQGConfig(iter_max=7, lam=0.3, **BENCH)
    assert convert.config_to_dict(convert.config_from_dict(
        convert.config_to_dict(cfg))) == dataclasses.asdict(cfg)
    with pytest.raises(ValueError):
        convert.config_from_dict({**dataclasses.asdict(cfg), "lam": 1.5})
    arrays = {name: np.zeros(shape) for name, shape in (
        ("x", (2, 4, 3)), ("l", (2, 3, 2)), ("L", (2, 3, 2, 3)),
        ("value", (2,)), ("eps_history", (2, 0, 2)), ("eps_count", (2,)),
        ("iterations", (2,)), ("d_final", (2,)), ("mu_final", (2,)),
        ("failed", (2,)))}
    res = convert.result_from_numpy(arrays, dtype=torch.float32)
    assert res.l.dtype == torch.float32 and res.failed.dtype == torch.bool
    assert res.iterations.dtype == torch.int32
    back = convert.result_to_numpy(res)
    assert set(back) == set(arrays)


@pytest.mark.parametrize("kw", [dict(ls_chunk=4),
                                dict(fold_candidate_eval=True)])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        P.make_batched_solver(tunicycle(N=5), P.ILEQGConfig(**kw))
