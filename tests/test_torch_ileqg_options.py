"""The port's bank under ``fold_candidate_eval`` against the JAX bank, and
the chunked ε ladder against a trial budget smaller than one chunk (CPU,
float64).

  - the folded candidate evaluation (kernel D's path) equals the JAX bank
    with the same option on the fixture of tests/test_pallas.py:260-291,
    and takes the default composition's decisions;
  - ``ls_chunk = 8`` with ``ls_max_trials ∈ {3, 5}`` equals the sequential
    search and the JAX bank (tests/test_line_search_chunk.py:74-89).

The chunked ladder proper is in tests/test_torch_ls_chunk.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import ratilqr_tpu as J  # noqa: E402
import ratilqr_tpu_torch as P  # noqa: E402
from ratilqr_tpu.models import unicycle as juni  # noqa: E402
from ratilqr_tpu_torch.models import unicycle as tuni  # noqa: E402
from test_torch_ileqg import assert_banks_match  # noqa: E402


def run_jax(jprob, cfg_kw, x0, u0, thetas):
    return J.make_batched_solver(jprob, J.ILEQGConfig(**cfg_kw))(
        jnp.asarray(x0), jnp.asarray(u0), jnp.asarray(thetas))


def run_port(tprob, cfg_kw, x0, u0, thetas):
    return P.make_batched_solver(tprob, P.ILEQGConfig(**cfg_kw))(
        torch.tensor(x0), torch.tensor(u0), torch.tensor(thetas))


def assert_same_trials(res_c, res_1):
    """Trial-for-trial equality of two port banks."""
    for name in ("iterations", "eps_count", "failed"):
        assert torch.equal(getattr(res_c, name), getattr(res_1, name)), name
    for name in ("value", "l", "L", "eps_history"):
        torch.testing.assert_close(getattr(res_c, name),
                                   getattr(res_1, name), rtol=1e-12,
                                   atol=1e-14, equal_nan=True, msg=name)


def test_fold_candidate_eval_matches_jax():
    thetas = np.array([0.0, 0.01, 0.05, 1e6])
    x0, u0 = np.array([0.3, -0.2, 0.1]), 0.05 * np.ones((12, 2))
    base = dict(iter_max=20, adaptive_eps_init=True, eps_history_cap=0)
    cfg = dict(base, fold_candidate_eval=True)
    jres = run_jax(juni(N=12), cfg, x0, u0, thetas)
    tprob = tuni(N=12, device="cpu", analytic_jacobians=True)
    tres = run_port(tprob, cfg, x0, u0, thetas)
    assert bool(jres.failed[3]) and not np.any(np.asarray(jres.failed[:3]))
    assert_banks_match(tres, jres, hist=False)
    # The fold changes the layout of the candidate evaluation only: the
    # default composition takes the same decisions.
    dflt = run_port(tprob, base, x0, u0, thetas)
    for name in ("iterations", "eps_count", "failed"):
        assert torch.equal(getattr(dflt, name), getattr(tres, name)), name
    ok = ~dflt.failed
    torch.testing.assert_close(tres.value[ok], dflt.value[ok], rtol=1e-10,
                               atol=0)


@pytest.mark.parametrize("trials", [3, 5])
def test_chunk_beyond_trial_budget(trials):
    """Rungs past ``ls_max_trials`` are neither taken, counted nor
    recorded."""
    x0, u0, thetas = np.zeros(3), np.zeros((20, 2)), np.array([0.0])
    cfg = dict(iter_max=10, ls_max_trials=trials)
    tprob = tuni(N=20, device="cpu", analytic_jacobians=True)
    tres = run_port(tprob, dict(cfg, ls_chunk=8), x0, u0, thetas)
    assert_banks_match(tres, run_jax(juni(N=20), dict(cfg, ls_chunk=8), x0,
                                     u0, thetas))
    assert_same_trials(tres, run_port(tprob, cfg, x0, u0, thetas))
