"""The port's timing and profiling helpers (``ratilqr_tpu_torch/utils/
profiling.py``), on the CPU: the same result keys as the JAX package's
``time_fn`` and ``PhaseTimer``."""
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ratilqr_tpu.utils import profiling as jprof  # noqa: E402
from ratilqr_tpu_torch.solvers.ratilqr import CEState  # noqa: E402
from ratilqr_tpu_torch.utils import profiling  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops run faster on one thread than on many,
    and the suite runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_time_fn_keys_and_calls():
    calls = []

    def fn(a, b=1):
        calls.append((a, b))
        time.sleep(0.002)
        return torch.tensor([a + b, 0.0])

    stats = profiling.time_fn(fn, 2, b=3, warmup=2, reps=4)
    jstats = jprof.time_fn(lambda: np.zeros(1), warmup=1, reps=1)
    assert set(stats) == set(jstats) == {"best", "median", "mean", "compile"}
    assert len(calls) == 6 and calls[0] == (2, 3)
    assert 0.002 <= stats["best"] <= stats["median"] <= 1.0
    assert stats["compile"] >= 0.002 and stats["mean"] >= stats["best"]


def test_sync_fetches_the_first_tensor_leaf():
    state = CEState(mu_init=1.5, sigma_init=torch.tensor(2.5),
                    mu=torch.tensor([3.5]), sigma=None, theta_min=None,
                    theta_max=None, iter_current=0)
    assert profiling.sync(state) == 2.5
    assert profiling.sync({"a": torch.zeros(0), "b": [torch.ones(2, 2)]}) == 1


def test_phase_timer_summary():
    timer = profiling.PhaseTimer()
    for name in ("plan", "plan", "simulate"):
        with timer.phase(name):
            time.sleep(0.001)
    with pytest.raises(RuntimeError):
        with timer.phase("fails"):
            raise RuntimeError("counted all the same")
    summary = timer.summary()
    assert set(summary) == {"plan", "simulate", "fails"}
    assert summary["plan"]["count"] == 2 and summary["fails"]["count"] == 1
    for entry in summary.values():
        assert set(entry) == {"total_s", "count", "mean_s"}
        assert entry["mean_s"] == pytest.approx(entry["total_s"]
                                                / entry["count"])
    assert summary["plan"]["total_s"] >= 0.002


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_count_host_syncs_counts_nothing_without_cuda():
    with profiling.count_host_syncs() as syncs:
        float(torch.ones(3).sum())
    assert syncs.n == 0
