"""Solver-state checkpoints across the two packages
(``ratilqr_tpu_torch/utils/checkpoint.py`` against
``ratilqr_tpu/utils/checkpoint.py``): the same ``.npz`` + key-path format,
so a state saved by one package loads in the other, leaf kinds kept.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ratilqr_tpu.solvers import nelder_mead as jnm  # noqa: E402
from ratilqr_tpu.solvers import ratilqr as jrat  # noqa: E402
from ratilqr_tpu.utils import checkpoint as jck  # noqa: E402
from ratilqr_tpu_torch.config import (CrossEntropyConfig,  # noqa: E402
                                      NelderMeadConfig)
from ratilqr_tpu_torch.solvers import nelder_mead as tnm  # noqa: E402
from ratilqr_tpu_torch.solvers import ratilqr as trat  # noqa: E402
from ratilqr_tpu_torch.solvers import ratilqr_jit as tjit  # noqa: E402
from ratilqr_tpu_torch.utils import checkpoint as tck  # noqa: E402
from ratilqr_tpu_torch.utils.tree import (flatten_with_paths,  # noqa: E402
                                          tree_map, unflatten)

CE_VALUES = dict(mu_init=0.2, sigma_init=0.05, mu=0.31, sigma=0.07,
                 theta_min=0.11, theta_max=0.52)
NM_VALUES = (0.5, 1e-8, 0.41, 0.013, 3.25, 4.125, 7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops run faster on one thread than on many,
    and the suite runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_ce_state(iter_current=3):
    return jrat.CEState(**{k: jnp.asarray(v, jnp.float64)
                           for k, v in CE_VALUES.items()},
                        iter_current=iter_current)


def port_ce_state(iter_current=3, dtype=torch.float64):
    return trat.CEState(**{k: torch.tensor(v, dtype=dtype)
                           for k, v in CE_VALUES.items()},
                        iter_current=iter_current)


def assert_ce(got, values, iter_current, dtype):
    for name, v in values.items():
        leaf = getattr(got, name)
        assert isinstance(leaf, torch.Tensor) and leaf.dtype == dtype, name
        np.testing.assert_allclose(float(leaf), v, rtol=0)
    assert got.iter_current == iter_current
    assert type(got.iter_current) is type(iter_current)


def test_ce_state_jax_to_port(tmp_path):
    """A JAX ``CEState`` (int ``iter_current``) loads into the port against
    a port template: tensors in the template's dtype, the int kept."""
    path = str(tmp_path / "ce")
    jck.save_state(path, jax_ce_state())
    got = tck.load_state(path, trat.init_state(CrossEntropyConfig()))
    assert_ce(got, CE_VALUES, 3, torch.float64)
    got32 = tck.load_state(path, trat.init_state(CrossEntropyConfig(),
                                                 torch.float32))
    assert got32.mu.dtype == torch.float32


def test_ce_state_port_to_jax(tmp_path):
    """The port's ``CEState`` loads into JAX against a JAX template, and a
    single-call state (array ``iter_current``) keeps its array kind."""
    path = str(tmp_path / "ce.npz")
    tck.save_state(path, port_ce_state())
    got = jck.load_state(path, jrat.init_state(jrat.CrossEntropyConfig()))
    for name, v in CE_VALUES.items():
        np.testing.assert_allclose(float(getattr(got, name)), v, rtol=0)
    assert got.iter_current == 3 and isinstance(got.iter_current, int)
    tck.save_state(path, port_ce_state(iter_current=torch.tensor(5)))
    got = jck.load_state(path, jrat.init_state(jrat.CrossEntropyConfig()))
    assert isinstance(got.iter_current, jax.Array)
    assert int(got.iter_current) == 5


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_nm_state_floats_load_into_none_template(tmp_path, direction):
    """An ``NMState`` after its bootstrap (``c_high``/``c_low`` floats)
    loads to floats against a fresh template whose costs are still
    ``None``, in either direction (the JAX docstring's case)."""
    path = str(tmp_path / "nm")
    if direction == "jax_to_port":
        jck.save_state(path, jnm.NMState(*NM_VALUES))
        got = tck.load_state(path, tnm.init_state(NelderMeadConfig()))
    else:
        tck.save_state(path, tnm.NMState(*NM_VALUES))
        got = jck.load_state(path, jnm.init_state(jnm.NelderMeadConfig()))
    assert tuple(got) == NM_VALUES
    assert all(type(a) is type(b) for a, b in zip(got, NM_VALUES))


def test_fresh_nm_state_keeps_none(tmp_path):
    """A fresh ``NMState`` (costs ``None``) round-trips with its ``None``s
    through both packages."""
    path = str(tmp_path / "nm0")
    tck.save_state(path, tnm.init_state(NelderMeadConfig()))
    got = jck.load_state(path, jnm.init_state(jnm.NelderMeadConfig()))
    assert got.c_high is None and got.c_low is None
    jck.save_state(path, got)
    back = tck.load_state(path, tnm.init_state(NelderMeadConfig()))
    assert back == tnm.init_state(NelderMeadConfig())


def test_all_array_nm_state_loads_as_tensors(tmp_path):
    """JAX's all-array ``NMState`` (the episode carry of
    ``nelder_mead_jit.bootstrap_state``) loads as 0-d tensors against the
    port's float template, which the port's solvers accept."""
    path = str(tmp_path / "nm_arr")
    jck.save_state(path, jnm.NMState(*(jnp.asarray(v) for v in NM_VALUES)))
    got = tck.load_state(path, tnm.init_state(NelderMeadConfig()))
    assert all(isinstance(v, torch.Tensor) for v in got)
    assert tnm.host_state(got) == tnm.NMState(*NM_VALUES)


def test_fleet_state_on_template_device_and_dtype(tmp_path):
    """A fleet ``CEState`` of ``(S,)`` tensors round-trips in the port
    and loads in JAX with its seed axis."""
    states = [port_ce_state(iter_current=s) for s in range(3)]
    fleet = tjit.stack_states(states)
    path = str(tmp_path / "fleet")
    tck.save_state(path, fleet)
    got = tck.load_state(path, fleet)
    for a, b in zip(got, fleet):
        assert torch.equal(a, b) and a.dtype == b.dtype
    jgot = jck.load_state(path, jrat.CEState(*([jnp.zeros(3)] * 6),
                                             iter_current=jnp.zeros(3, int)))
    np.testing.assert_array_equal(np.asarray(jgot.iter_current), [0, 1, 2])


@pytest.mark.parametrize("wrong", ["other_fields", "more_leaves"])
def test_structure_mismatch_raises(tmp_path, wrong):
    path = str(tmp_path / "ce")
    tck.save_state(path, port_ce_state())
    like = (tnm.init_state(NelderMeadConfig()) if wrong == "other_fields"
            else (port_ce_state(), 1.0))
    with pytest.raises(ValueError):
        tck.load_state(path, like)


def test_key_paths_are_jax_keystr():
    """The port's flattener gives JAX's key paths and leaf order for
    nested named tuples, tuples, lists and dicts (keys sorted), ``None``
    a leaf."""
    def tree(state_type, array):
        return ({"b": 1, "a": [None, 2.0]}, state_type(*NM_VALUES),
                [array(np.zeros(2))], ())

    jpaths, jleaves = zip(*(
        (jax.tree_util.keystr(p), leaf) for p, leaf in
        jax.tree_util.tree_flatten_with_path(
            tree(jnm.NMState, jnp.asarray), is_leaf=lambda x: x is None)[0]))
    tpaths, tleaves = flatten_with_paths(tree(tnm.NMState, torch.tensor))
    assert list(jpaths) == tpaths
    assert len(tleaves) == len(jleaves) == 11
    rebuilt = unflatten(tree(tnm.NMState, torch.tensor), tleaves)
    assert rebuilt[0] == {"b": 1, "a": [None, 2.0]}
    doubled = tree_map(lambda x: None if x is None else 2 * x,
                       tree(tnm.NMState, torch.tensor))
    assert doubled[1].theta_high_init == 1.0 and doubled[0]["b"] == 2
