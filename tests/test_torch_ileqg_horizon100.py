"""Bank parity with JAX at the main path's horizon: the unicycle at T=100
under the benchmark configuration (``bench.py:108-111``), cold and
warm-started, CPU float64 (contract in tests/test_torch_ileqg.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_ileqg import (BENCH, assert_banks_match,  # noqa: E402
                              run_cold_and_warm)


def test_bank_matches_jax_horizon_100():
    (cold_t, cold_j), (warm_t, warm_j) = run_cold_and_warm(100, BENCH)
    assert int(np.asarray(cold_j.iterations)[0]) > 2
    assert_banks_match(cold_t, cold_j, hist=False)
    assert_banks_match(warm_t, warm_j, hist=False)
