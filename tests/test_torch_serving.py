"""The bank server and the pipelined map (``ratilqr_tpu_torch/utils/
serving.py``) against an unpadded bank and against JAX's
``ILEQGBankServer`` (CPU, float64)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import ratilqr_tpu as J  # noqa: E402
from ratilqr_tpu.models import lqr_problem as jlqr  # noqa: E402
from ratilqr_tpu.utils.serving import \
    ILEQGBankServer as JServer  # noqa: E402
from ratilqr_tpu_torch import make_batched_solver  # noqa: E402
from ratilqr_tpu_torch.config import ILEQGConfig  # noqa: E402
from ratilqr_tpu_torch.models import lqr_problem as tlqr  # noqa: E402
from ratilqr_tpu_torch.solvers import ileqg as tileqg  # noqa: E402
from ratilqr_tpu_torch.utils.serving import (ILEQGBankServer,  # noqa: E402
                                             pipelined_map)

T = 6
BANK = 8
CONFIG = dict(iter_max=20)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops run faster on one thread than on many,
    and the suite runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def requests(count, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(count, 2)), 0.1 * rng.normal(size=(count, T, 2)),
            rng.uniform(0.0, 0.5, size=count))


@pytest.mark.parametrize("bank_size", [BANK, None])
@pytest.mark.parametrize("count", [5, BANK, 19])
def test_server_equals_unpadded_bank(count, bank_size):
    """Below, at and above the bank size (one padded bank, one full bank,
    three chunks with the last padded), and with no bank size (one bank of
    every request, unpadded): every lane equals a direct bank on the same
    requests."""
    prob = tlqr(N=T, noise=1e-2, device="cpu")
    x0s, us, ths = (torch.tensor(a) for a in requests(count))
    server = ILEQGBankServer(prob, ILEQGConfig(**CONFIG),
                             bank_size=bank_size, depth=2)
    with tileqg.record_banks() as widths:
        got = server.solve_batch(x0s, us, ths)
    assert widths == ([count] if bank_size is None
                      else [BANK] * -(-count // BANK))
    ref = make_batched_solver(prob, ILEQGConfig(**CONFIG))(x0s, us, ths)
    for name, a, b in zip(ref._fields, got, ref):
        assert a.shape[0] == count, name
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-14,
                                   msg=name)
    assert bool(torch.isfinite(got.value).all())


def test_server_matches_jax_server():
    x0s, us, ths = requests(11, seed=1)
    jgot = JServer(jlqr(N=T, noise=1e-2), J.ILEQGConfig(**CONFIG),
                   bank_size=BANK, depth=2).solve_batch(
        jnp.asarray(x0s), jnp.asarray(us), jnp.asarray(ths))
    tgot = ILEQGBankServer(tlqr(N=T, noise=1e-2, device="cpu"),
                           ILEQGConfig(**CONFIG), bank_size=BANK).solve_batch(
        torch.tensor(x0s), torch.tensor(us), torch.tensor(ths))
    for name in ("x", "l", "L", "value"):
        np.testing.assert_allclose(getattr(tgot, name).numpy(),
                                   np.asarray(getattr(jgot, name)),
                                   rtol=1e-9, atol=1e-12, err_msg=name)
    for name in ("iterations", "failed"):
        np.testing.assert_array_equal(getattr(tgot, name).numpy(),
                                      np.asarray(getattr(jgot, name)))


def test_mismatched_request_fields_raise():
    server = ILEQGBankServer(tlqr(N=T, noise=1e-2, device="cpu"),
                             ILEQGConfig(**CONFIG), bank_size=BANK)
    x0s, us, ths = (torch.tensor(a) for a in requests(4))
    with pytest.raises(ValueError, match="disagree"):
        server.solve_batch(x0s[:3], us, ths)
    with pytest.raises(ValueError, match="disagree"):
        server.solve_batch(x0s, us, ths[:2])


@pytest.mark.parametrize("depth", [1, 3])
def test_pipelined_map_order_and_depth(depth):
    """Results come in input order, with at most ``depth`` handled and not
    yet fetched at any time."""
    inflight, most = [0], [0]

    def fn(item):
        inflight[0] += 1
        most[0] = max(most[0], inflight[0])
        return torch.tensor([item * 10])

    def fetch(out):
        inflight[0] -= 1
        return int(out[0])

    out = list(pipelined_map(fn, range(7), depth=depth, fetch=fetch))
    assert out == [10 * i for i in range(7)]
    assert most[0] == depth and inflight[0] == 0
    default = list(pipelined_map(lambda i: {"v": torch.tensor([i])},
                                 range(3), depth=depth))
    assert [int(d["v"][0]) for d in default] == [0, 1, 2]


def test_pipelined_map_rejects_depth_below_one():
    with pytest.raises(ValueError, match="depth"):
        list(pipelined_map(lambda i: i, range(3), depth=0))
