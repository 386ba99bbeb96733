"""The port's timing and profiling helpers (``ratilqr_tpu_torch/utils/
profiling.py``), on the CPU: the same result keys as the JAX package's
``time_fn``, and the program's ``rq.`` spans and counters over a bank."""
import collections
import ctypes.util
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ratilqr_tpu.utils import profiling as jprof  # noqa: E402
from ratilqr_tpu_torch import models  # noqa: E402
from ratilqr_tpu_torch.config import ILEQGConfig  # noqa: E402
from ratilqr_tpu_torch.ops import _build  # noqa: E402
from ratilqr_tpu_torch.ops.riccati import mu_restart_loop  # noqa: E402
from ratilqr_tpu_torch.solvers import ileqg  # noqa: E402
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


FUSED = dict(fused_step_optimize=True, fused_candidate_eval=True,
             adaptive_eps_init=True, eps_history_cap=0)
# The unicycle from the origin, T=10: every lane of this θ grid takes 11
# iterations and fails none.
BANK_CONFIGS = {"fused": FUSED, "fused_chunk3": {**FUSED, "ls_chunk": 3},
                "default": {}}


def _unicycle_bank(config):
    prob = models.unicycle(N=10, dtype=torch.float64, device="cpu")
    bank = ileqg.make_batched_solver(prob, ILEQGConfig(**config))
    return lambda: bank(torch.zeros(3, dtype=torch.float64),
                        torch.zeros(10, 2, dtype=torch.float64),
                        torch.linspace(0.0, 0.05, 8, dtype=torch.float64))


def _program_spans(log_dir):
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"][len(profiling.SPAN_PREFIX):], float(e["ts"]),
             float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("ph") == "X"
            and str(e.get("name", "")).startswith(profiling.SPAN_PREFIX)]


def _inside(spans, inner, *outer):
    """Every ``inner`` span lies in a span of a name in ``outer``."""
    outers = [(s, t) for n, s, t in spans if n in outer]
    return all(any(s0 <= s and t <= t0 for s0, t0 in outers)
               for n, s, t in spans if n == inner)


@pytest.mark.parametrize("name", BANK_CONFIGS)
def test_bank_spans_nest_and_match_the_counters(tmp_path, name):
    solve = _unicycle_bank(BANK_CONFIGS[name])
    profiling.reset_counters()
    with profiling.trace(str(tmp_path)):
        res = solve()
    spans = _program_spans(str(tmp_path))
    count = collections.Counter(n for n, _, _ in spans)
    counters = profiling.counters
    assert not bool(res.failed.any())
    assert count["bank"] == counters["bank_calls"] == 1
    assert count["initialize"] == 1
    assert count["iteration"] == counters["iterations"] == 11
    assert count["line_search"] == 11
    assert count["ls_round"] == counters["ls_rounds"] > 0
    sites = {n for n in counters if n.startswith("sync.")}
    assert sites == {"sync.bank.active", "sync.ls.running",
                     "sync.mu.need"} | (
        {"sync.eps.restore"} if "adaptive_eps_init" in BANK_CONFIGS[name]
        else set())
    for site in sites:
        assert count[site] == counters[site]
    assert counters["sync.bank.active"] == counters["iterations"] + 1
    assert counters["sync.ls.running"] == (counters["ls_rounds"]
                                           + counters["iterations"])
    # every lane's line search took a rung in every iteration
    assert counters["accepted_lanes"] == int(res.iterations.sum())
    assert counters["candidate_lanes"] >= counters["accepted_lanes"]
    for inner, outer in (("initialize", "bank"), ("iteration", "bank"),
                         ("line_search", "iteration"),
                         ("ls_round", "line_search"),
                         ("sync.bank.active", "bank"),
                         ("sync.ls.running", "line_search"),
                         ("sync.mu.need", "iteration")):
        assert _inside(spans, inner, outer), (inner, outer)
    if name.startswith("fused"):
        # the trajectories come from the candidate evaluations' states
        assert count["rollout_feedback"] == count["rollout_open_loop"] == 0
        assert counters["rollouts_reused"] == counters["iterations"] + 1
        assert counters["rollouts_run"] == 0
        assert _inside(spans, "step_optimize", "iteration")
        assert _inside(spans, "candidate_bank", "ls_round", "initialize")
        assert _inside(spans, "eps_restore", "line_search")
        assert _inside(spans, "sync.eps.restore", "eps_restore")
        assert count["step_optimize"] == counters["iterations"]
        assert count["candidate_bank"] == counters["ls_rounds"] + 1
    else:
        assert _inside(spans, "rollout_feedback", "line_search")
        assert _inside(spans, "rollout_open_loop", "bank")
        assert count["rollout_feedback"] == counters["iterations"]
        assert count["rollout_open_loop"] == 1
        assert counters["rollouts_run"] == counters["iterations"] + 1
        assert counters["rollouts_reused"] == 0
        assert _inside(spans, "rollout_feedback_with_jac", "ls_round")
        assert _inside(spans, "rollout_open_loop_with_jac", "iteration",
                       "initialize")
    if name == "fused_chunk3":
        assert counters["candidate_lanes"] % 3 == 0


def test_no_span_without_a_profiler(monkeypatch, tmp_path):
    """With no profiler recording, a span is the one shared no-op and no
    ``record_function`` is made; a traced solve gives the same bits."""
    solve = _unicycle_bank(FUSED)
    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name) or real(name))
    assert profiling.span("bank") is profiling.span("iteration")
    plain = solve()
    assert made == []
    with profiling.trace(str(tmp_path)):
        traced = solve()
    assert profiling.SPAN_PREFIX + "bank" in made
    for field, a, b in zip(plain._fields, plain, traced):
        assert torch.equal(a, b), field


def test_mu_restarts_are_spanned_and_counted(tmp_path):
    """Lane 0's H check fails until μ ≥ 1e-3: it restarts, lane 1 never."""
    def run(mu):
        h_fail = (mu < 1e-3) & (torch.arange(2) == 0)
        return mu.clone(), torch.zeros(2, dtype=torch.bool), h_fail

    profiling.reset_counters()
    with profiling.trace(str(tmp_path)):
        _, mu, _, failed = mu_restart_loop(run, torch.zeros(2),
                                           torch.ones(2), 1e-6, 2.0, 100)
    restarts = profiling.counters["mu_restarts"]
    assert float(mu[0]) >= 1e-3 and float(mu[1]) == 0.0
    assert not bool(failed.any()) and restarts > 1
    assert profiling.counters["sync.mu.need"] == restarts + 1
    names = [n for n, _, _ in _program_spans(str(tmp_path))]
    assert names.count("mu_restart") == restarts
    assert names.count("sync.mu.need") == restarts + 1


def test_a_library_load_is_spanned_and_counted(tmp_path):
    libm = ctypes.util.find_library("m")
    if libm is None:
        pytest.skip("no C math library to load")
    profiling.reset_counters()
    with profiling.trace(str(tmp_path)):
        lib = _build._load(lambda: libm, ())
    assert lib.cos is not None
    assert profiling.counters["library_loads"] == 1
    assert [n for n, _, _ in _program_spans(str(tmp_path))] == ["build"]
