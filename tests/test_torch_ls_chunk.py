"""The port's chunked ε ladder (``ls_chunk > 1``) against its sequential
line search and against the JAX bank (CPU, float64), on the fixtures of
tests/test_line_search_chunk.py:26-58, with and without adaptive ε.

The JAX bank runs once per (model, adaptive ε) with ``ls_chunk = 4``; JAX's
own tests pin its chunked search to its sequential one for every chunk.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ratilqr_tpu.models import nonlinear_toy as jtoy  # noqa: E402
from ratilqr_tpu.models import unicycle as juni  # noqa: E402
from ratilqr_tpu_torch.models import nonlinear_toy as ttoy  # noqa: E402
from ratilqr_tpu_torch.models import unicycle as tuni  # noqa: E402
from test_torch_ileqg import assert_banks_match  # noqa: E402
from test_torch_ileqg_options import (assert_same_trials,  # noqa: E402
                                      run_jax, run_port)

MODELS = {   # name: (JAX problem, port problem, x0, u0)
    "toy": (lambda: jtoy(N=10), lambda: ttoy(N=10, device="cpu"), np.zeros(2),
            0.1 * np.ones((10, 2))),
    "unicycle": (lambda: juni(N=20),
                 lambda: tuni(N=20, device="cpu", analytic_jacobians=True),
                 np.zeros(3), np.zeros((20, 2))),
}
THETAS = np.array([0.0, 0.01])


def config(adaptive, chunk):
    return dict(iter_max=25, adaptive_eps_init=adaptive, eps_history_cap=64,
                ls_chunk=chunk)


@functools.lru_cache(maxsize=None)
def jax_bank(model, adaptive):
    jprob, _, x0, u0 = MODELS[model]
    return run_jax(jprob(), config(adaptive, 4), x0, u0, THETAS)


@functools.lru_cache(maxsize=None)
def port_bank(model, adaptive, chunk):
    _, tprob, x0, u0 = MODELS[model]
    return run_port(tprob(), config(adaptive, chunk), x0, u0, THETAS)


@pytest.mark.parametrize("chunk", [2, 4])
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("model", list(MODELS))
def test_chunked_ladder_matches_sequential(model, adaptive, chunk):
    assert_same_trials(port_bank(model, adaptive, chunk),
                       port_bank(model, adaptive, 1))


@pytest.mark.parametrize("chunk", [2, 4])
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("model", list(MODELS))
def test_chunked_ladder_matches_jax(model, adaptive, chunk):
    assert_banks_match(port_bank(model, adaptive, chunk),
                       jax_bank(model, adaptive))


def test_unicycle_fixture_backtracks():
    res = port_bank("unicycle", False, 1)
    assert bool((res.eps_count > res.iterations).all()), \
        "every lane must reject some trial, or the ladder is not exercised"
