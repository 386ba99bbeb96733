"""The port's package surface against the JAX package's, CPU float64.

Every public name of ``ratilqr_tpu``, ``ratilqr_tpu.ops`` and
``ratilqr_tpu.utils`` resolves in the port's twin (the port may export
more), both problem classes share the port's ``OptimalControlProblem``
base, and the README quick start, run with the port's package name, gives
the JAX solve's result: the same iterations and failure flag, value rtol
1e-9, ``l`` and ``L`` atol 1e-8 (the tolerances of
tests/test_torch_ileqg.py).
"""
import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import ratilqr_tpu as J  # noqa: E402
import ratilqr_tpu_torch as P  # noqa: E402
from ratilqr_tpu_torch import problems as port_problems  # noqa: E402
from ratilqr_tpu_torch.solvers import ileqg as port_ileqg  # noqa: E402

SUBPACKAGES = ("", ".ops", ".utils")


def public_names(module) -> set:
    """The names a package's ``__init__`` exports: every public attribute
    that is not a submodule."""
    return {name for name, value in vars(module).items()
            if not name.startswith("_")
            and not isinstance(value, types.ModuleType)}


@pytest.mark.parametrize("sub", SUBPACKAGES,
                         ids=["root", "ops", "utils"])
def test_every_jax_public_name_resolves_in_the_port(sub):
    jax_mod = importlib.import_module("ratilqr_tpu" + sub)
    port_mod = importlib.import_module("ratilqr_tpu_torch" + sub)
    names = public_names(jax_mod)
    assert names, f"ratilqr_tpu{sub} exports nothing"
    missing = sorted(names - public_names(port_mod))
    assert not missing, f"ratilqr_tpu_torch{sub} lacks {missing}"


def test_ileqg_solve_is_the_one_lane_solve():
    assert P.ileqg_solve is port_ileqg.solve
    assert P.solve is port_ileqg.solve   # the port's own name stays


@pytest.mark.parametrize("cls", ["RiskSensitiveProblem", "GenerativeProblem"])
def test_problems_share_the_optimal_control_base(cls):
    assert issubclass(getattr(P, cls), P.OptimalControlProblem)
    assert P.OptimalControlProblem is port_problems.OptimalControlProblem
    assert issubclass(getattr(J, cls), J.OptimalControlProblem)


def _quickstart_jax(N):
    from ratilqr_tpu.problems import RiskSensitiveProblem
    return RiskSensitiveProblem(
        f=lambda x, u: x + u,
        c=lambda k, x, u: 0.5 * (x @ x) + (u @ u),
        h=lambda x: 0.5 * (x @ x),
        W=lambda k: 0.01 * jnp.eye(2),
        N=N)


def _quickstart_port(N):
    from ratilqr_tpu_torch.problems import RiskSensitiveProblem
    W = 0.01 * torch.eye(2, dtype=torch.float64)
    return RiskSensitiveProblem(
        f=lambda x, u: x + u,
        c=lambda k, x, u: 0.5 * (x @ x) + (u @ u),
        h=lambda x: 0.5 * (x @ x),
        W=lambda k: W,
        N=N)


@pytest.mark.parametrize("theta", [0.0, 0.3])
def test_readme_quickstart_with_the_port_name(theta):
    """README.md's quick start with ``ratilqr_tpu`` replaced by
    ``ratilqr_tpu_torch`` (θ = 0.3 as there, and θ = 0, iLQG)."""
    from ratilqr_tpu_torch import (CrossEntropyConfig, ILEQGConfig,
                                   ileqg_solve)
    N = 10
    x0, u0 = np.array([2.0, -1.0]), np.zeros((N, 2))
    got = ileqg_solve(_quickstart_port(N), ILEQGConfig(), torch.tensor(x0),
                      torch.tensor(u0), theta=theta)
    want = J.ileqg_solve(_quickstart_jax(N), J.ILEQGConfig(),
                         jnp.asarray(x0), jnp.asarray(u0), theta=theta)
    assert CrossEntropyConfig().num_samples == J.CrossEntropyConfig(
    ).num_samples
    assert got.value.dtype == torch.float64
    assert tuple(got.l.shape) == (N, 2) and tuple(got.L.shape) == (N, 2, 2)
    assert int(got.iterations) == int(want.iterations)
    assert bool(got.failed) == bool(want.failed) is False
    np.testing.assert_allclose(float(got.value), float(want.value),
                               rtol=1e-9)
    for name in ("l", "L"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-8, err_msg=name)
