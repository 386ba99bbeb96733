"""RAT iLQR++ in the port on the single-call schedule
(``solvers/nelder_mead_jit.py``) against the JAX host path (CPU,
float64), on the fixture of ``tests/test_torch_nelder_mead.py``.

JAX's own tests pin its single-call path to its host path, so the host
path is the reference here too: at every speculation depth, with and
without ``refresh_carried_costs``, cold and warm, θ_opt and value to rtol
1e-9, ``l`` to atol 1e-10 and every ``NMState`` field.  A counting bank
shows the schedule: one 120-lane bootstrap bank, then one bank of
``TREE[depth]`` lanes a speculation round, and a one-lane final solve only
where θ_low has no carried lane.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ratilqr_tpu.solvers import nelder_mead as jnm  # noqa: E402
from ratilqr_tpu_torch.solvers import ileqg as tileqg  # noqa: E402
from ratilqr_tpu_torch.solvers import nelder_mead as tnm  # noqa: E402
from ratilqr_tpu_torch.solvers import nelder_mead_jit as tjit  # noqa: E402
from test_torch_nelder_mead import (  # noqa: E402,F401
    TPROB, U0, WARM_ITER_MAX, X0, X1, _one_torch_thread, assert_nm, configs,
    jax_solve)


@functools.lru_cache(maxsize=None)
def jax_chain(refresh: bool, kl: float = 1.0):
    """JAX host path: a cold solve from x0, then a warm one from x1."""
    jcfg, _ = configs(refresh_carried_costs=refresh, iter_max=WARM_ITER_MAX)
    r1 = jax_solve(jcfg, jnm.init_state(jcfg), X0, kl)
    return r1, jax_solve(jcfg, r1.state, X1, kl)


@pytest.mark.parametrize("refresh", [False, True])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_single_call_matches_jax_host(depth, refresh):
    _, tcfg = configs(refresh_carried_costs=refresh, iter_max=WARM_ITER_MAX,
                      speculation_depth=depth)
    rj1, rj2 = jax_chain(refresh)
    r1 = tjit.solve(TPROB, tcfg, tnm.init_state(tcfg), X0, U0, kl_bound=1.0)
    assert_nm(r1, rj1, f"cold depth={depth} refresh={refresh}")
    r2 = tjit.solve(TPROB, tcfg, r1.state, torch.tensor(X1),
                    torch.tensor(U0), kl_bound=1.0)
    assert_nm(r2, rj2, f"warm depth={depth} refresh={refresh}")


def test_kl_zero_keeps_costs_missing():
    """A ``kl_bound == 0`` solve on a fresh state is pure iLQG and returns
    NaN costs, so the next ``kl_bound > 0`` solve still bootstraps and
    equals a fresh host solve."""
    _, tcfg = configs()
    r0 = tjit.solve(TPROB, tcfg, tnm.init_state(tcfg), X0, U0, kl_bound=0.0)
    assert float(r0.theta_opt) == 0.0
    assert math.isnan(r0.state.c_high) and math.isnan(r0.state.c_low)
    h0 = tnm.solve(TPROB, tcfg, tnm.init_state(tcfg), X0, U0, kl_bound=0.0)
    assert torch.equal(r0.value, h0.value)
    r1 = tjit.solve(TPROB, tcfg, r0.state, X0, U0, kl_bound=1.0)
    fresh = tnm.solve(TPROB, tcfg, tnm.init_state(tcfg), X0, U0,
                      kl_bound=1.0)
    for name in ("theta_opt", "value"):
        np.testing.assert_allclose(float(getattr(r1, name)),
                                   float(getattr(fresh, name)), rtol=1e-9)
    assert r1.state == fresh.state
    # The host path reads the NaN encoding as missing too.
    h1 = tnm.solve(TPROB, tcfg, r0.state, X0, U0, kl_bound=1.0)
    assert h1.state == fresh.state


@pytest.fixture()
def bank_widths():
    """The width of every bank the block's solves run."""
    with tileqg.record_banks() as widths:
        yield widths


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_bank_schedule(depth, bank_widths, capsys):
    _, tcfg = configs(speculation_depth=depth, iter_max=WARM_ITER_MAX)
    r1 = tjit.solve(TPROB, tcfg, tnm.init_state(tcfg), X0, U0, kl_bound=1.0)
    rounds = -(-r1.state.iter_current // depth)
    # Cold: the bootstrap bank, one bank a speculation round, and the
    # final solve reuses θ_low's carried lane.
    assert bank_widths == [120] + [tjit.TREE[depth]] * rounds
    bank_widths.clear()
    # Warm at reference semantics: no bootstrap; θ_low (the carried stale
    # vertex) is never displaced here, so one one-lane final solve runs.
    r2 = tjit.solve(TPROB, tcfg, r1.state, X1, U0, kl_bound=1.0)
    assert r2.state.iter_current == WARM_ITER_MAX
    assert r2.state.theta_low == r1.state.theta_low_init
    rounds = -(-WARM_ITER_MAX // depth)
    assert bank_widths == [tjit.TREE[depth]] * rounds + [1]
    bank_widths.clear()
    # Refresh: one merged bank, [ladder_hi | ladder_lo | tree_a | tree_b],
    # holds the first speculation round.
    _, rcfg = configs(speculation_depth=depth, refresh_carried_costs=True,
                      verbose=True)
    r3 = tjit.solve(TPROB, rcfg, r1.state, X1, U0, kl_bound=1.0)
    rounds = -(-r3.state.iter_current // depth) - 1
    assert bank_widths == ([120 + 2 * tjit.TREE[depth]]
                           + [tjit.TREE[depth]] * rounds)
    # verbose: one trace line a replayed NM iteration.
    assert capsys.readouterr().out.count("**NM iter") == (
        r3.state.iter_current)
