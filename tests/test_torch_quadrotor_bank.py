"""The port's solver bank on the n=12 quadrotor against the JAX bank (CPU,
float64), in the three configurations of the model-size bank path:

  (a) the default step (kernel A's path) and the fused candidate (C);
  (b) (a) with the fused step (kernels B and C);
  (c) RAT iLQR's inner configuration: fused step and folded candidate
      evaluation with ``ls_chunk = 4`` (kernels B and D);

each cold from a seeded state and warm-started at a perturbed state from the
cold lane 0's schedule, at T=8 over 4 θ in [0, 0.01], ``iter_max = 6``.  The
contract is that of tests/test_torch_ileqg.py: ``iterations``, ``eps_count``
and ``failed`` equal, ``value`` rtol 1e-9, ``l``, ``L`` and ``x`` atol 1e-8.

The JAX bank at n=12 takes minutes to trace and compile on the CPU (its
unrolled 12x12 closed-form algebra), so its results are frozen in
``tests/golden/torch_quadrotor_bank.json``; regenerate them with the JAX
package by ``python tests/test_torch_quadrotor_bank.py`` (one process per
configuration, run together).
"""
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

GOLDEN = pathlib.Path(__file__).parent / "golden" / "torch_quadrotor_bank.json"
T = 8
THETAS = np.linspace(0.0, 0.01, 4)
X0 = 0.1 * np.random.default_rng(12).standard_normal(12)
X0_WARM = X0 + 0.05 * np.random.default_rng(13).standard_normal(12)
CONFIGS = {
    "a": dict(iter_max=6, adaptive_eps_init=True, eps_history_cap=0,
              fused_candidate_eval=True),
    "b": dict(iter_max=6, adaptive_eps_init=True, eps_history_cap=0,
              fused_candidate_eval=True, fused_step_optimize=True),
    "c": dict(iter_max=6, adaptive_eps_init=True, eps_history_cap=0,
              fused_step_optimize=True, fold_candidate_eval=True, ls_chunk=4),
}
FIELDS = ("x", "l", "L", "value", "eps_count", "iterations", "failed")


def jax_bank(key):
    """Cold and warm results of the JAX bank in configuration ``key``, as
    dictionaries of nested lists."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import ratilqr_tpu as J
    from ratilqr_tpu.models import quadrotor
    from ratilqr_tpu_torch import convert
    bank = J.make_batched_solver(quadrotor(N=T),
                                 J.ILEQGConfig(**CONFIGS[key]))
    cold = bank(jnp.asarray(X0), jnp.zeros((T, 4)), jnp.asarray(THETAS))
    warm = bank(jnp.asarray(X0_WARM), cold.l[0], jnp.asarray(THETAS))
    return {name: {f: a.tolist() for f, a in convert.result_to_numpy(res)
                   .items() if f in FIELDS}
            for name, res in (("cold", cold), ("warm", warm))}


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def port_bank(key):
    import ratilqr_tpu_torch as P
    from ratilqr_tpu_torch.models import quadrotor
    bank = P.make_batched_solver(quadrotor(N=T, device="cpu"),
                                 P.ILEQGConfig(**CONFIGS[key]))
    cold = bank(torch.tensor(X0), torch.zeros((T, 4), dtype=torch.float64),
                torch.tensor(THETAS))
    warm = bank(torch.tensor(X0_WARM), cold.l[0], torch.tensor(THETAS))
    return cold, warm


def assert_matches(res, want):
    from ratilqr_tpu_torch import convert
    got = convert.result_to_numpy(res)
    for name in ("iterations", "eps_count", "failed"):
        np.testing.assert_array_equal(got[name], np.asarray(want[name]),
                                      err_msg=name)
    np.testing.assert_allclose(got["value"], np.asarray(want["value"]),
                               rtol=1e-9)
    ok = ~np.asarray(want["failed"])
    for name in ("l", "L", "x"):
        np.testing.assert_allclose(got[name][ok], np.asarray(want[name])[ok],
                                   rtol=0, atol=1e-8, err_msg=name)


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_quadrotor_bank_matches_jax(golden, key):
    cold, warm = port_bank(key)
    assert cold.L.shape == (4, T, 4, 12) and not bool(cold.failed.any())
    assert_matches(cold, golden[key]["cold"])
    assert_matches(warm, golden[key]["warm"])
    assert int(cold.iterations.max()) > 1, "the cold solve must iterate"


if __name__ == "__main__":
    import concurrent.futures
    import multiprocessing

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    keys = sorted(CONFIGS)
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(len(keys),
                                                mp_context=spawn) as pool:
        results = dict(zip(keys, pool.map(jax_bank, keys)))
    GOLDEN.write_text(json.dumps(results) + "\n")
    print(f"wrote {GOLDEN}")
