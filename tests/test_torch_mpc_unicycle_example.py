"""The port's MPC demo (``ratilqr_tpu_torch/examples/mpc_unicycle.py``, the
twin of ``examples/mpc_unicycle.py``) run with ``--cpu`` at 2 steps and
horizon 5.  A one-lane float32 unicycle solve runs all 30 inner iterations
on the CPU (~2 s here, RAT iLQR++ ~30 s a re-plan), so the test caps the
demo's inner ``iter_max`` at 3: every controller still plans through
``MPCDriver`` and prints its row of the table.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from ratilqr_tpu_torch.config import ILEQGConfig  # noqa: E402
from ratilqr_tpu_torch.examples import mpc_unicycle  # noqa: E402

CONTROLLERS = ("iLQG (θ=0)", "iLEQG (θ=0.01)", "RAT iLQR", "RAT iLQR++")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops run faster on one thread than on many,
    and the suite runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_example_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(mpc_unicycle, "ILEQGConfig",
                        lambda iter_max: ILEQGConfig(iter_max=3))
    mpc_unicycle.main(["--cpu", "--steps", "2", "--horizon", "5"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split() == ["controller", "final", "dist", "total",
                                "cost", "p50", "plan", "ms"]
    assert len(lines) == 1 + len(CONTROLLERS)
    for name, line in zip(CONTROLLERS, lines[1:]):
        assert line.startswith(name), line
        dist, cost, ms = (float(v) for v in line[len(name):].split())
        assert all(math.isfinite(v) for v in (dist, cost, ms)), line
        # From x0 = 0 two steps barely move toward the goal (5, 5).
        assert 6.0 < dist < 7.5 and cost > 0 and ms > 0, line


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a CPU-only "
                    "torch: on a card the default run is the real one")
def test_example_defaults_to_the_card():
    with pytest.raises((AssertionError, RuntimeError)):
        mpc_unicycle.main(["--steps", "1"])
