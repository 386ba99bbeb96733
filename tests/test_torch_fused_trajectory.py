"""The fused bank's nominal trajectory (CPU, float64, the plain path).

With ``fused_candidate_eval`` the line search takes the accepted
candidate's states from its own evaluation and computes the accepted
controls along them; the result returns the carried trajectory and rolls
nothing out again.  Held against the open-loop rollout of the result's
controls, and against the same bank with ``fold_candidate_eval``, whose
line search evaluates the same candidates through the same folded core and
re-rolls the accepted one out (``rollout_feedback``), with ``ls_chunk`` 1
and 3, on a bank whose every lane runs the first round and on one with a
lane that fails at ``initialize`` (θ = 1e6), so every round runs fewer
lanes than the bank has.  The batched policy the line search computes the
accepted controls with is held against the per-step one.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

from ratilqr_tpu_torch import models  # noqa: E402
from ratilqr_tpu_torch.config import ILEQGConfig  # noqa: E402
from ratilqr_tpu_torch.ops.rollout import (  # noqa: E402
    feedback_control, feedback_control_traj, rollout_open_loop)
from ratilqr_tpu_torch.solvers import ileqg  # noqa: E402
from ratilqr_tpu_torch.utils import profiling  # noqa: E402

F64 = torch.float64
MODELS = {   # name: (problem, x0, T, m)
    "unicycle": (lambda: models.unicycle(N=12, device="cpu"), (0.0,) * 3,
                 12, 2),
    "cartpole": (lambda: models.cartpole(N=12, device="cpu"),
                 (0.3, 0.0, 0.4, 0.0), 12, 1),
    "quadrotor": (lambda: models.quadrotor(N=10, device="cpu"), (0.0,) * 12,
                  10, 4),
}
GRID = torch.linspace(0.0, 0.05, 6, dtype=F64)
BANKS = {"every": GRID,
         "stopped": torch.cat([GRID, torch.tensor([1e6], dtype=F64)])}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _problem(model):
    return MODELS[model][0]()


@functools.lru_cache(maxsize=None)
def _solve(model, chunk, bank, evaluation):
    """The bank's result and its counters."""
    _, x0, T, m = MODELS[model]
    config = ILEQGConfig(fused_step_optimize=True, adaptive_eps_init=True,
                         eps_history_cap=16, iter_max=15, ls_chunk=chunk,
                         **{evaluation: True})
    profiling.reset_counters()
    res = ileqg.make_batched_solver(_problem(model), config)(
        torch.tensor(x0, dtype=F64), torch.zeros((T, m), dtype=F64),
        BANKS[bank])
    return res, dict(profiling.counters)


@pytest.mark.parametrize("bank", list(BANKS))
@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("model", list(MODELS))
def test_fused_bank_carries_the_rollout_of_its_controls(model, chunk, bank):
    res, count = _solve(model, chunk, bank, "fused_candidate_eval")
    x0 = torch.tensor(MODELS[model][1], dtype=F64)
    x = rollout_open_loop(_problem(model), x0.expand(res.l.shape[0], -1),
                          res.l)
    torch.testing.assert_close(res.x, x, rtol=0, atol=1e-12)
    assert count["rollouts_reused"] == count["iterations"] + 1
    assert "rollouts_run" not in count
    assert bool(res.failed[-1]) == (bank == "stopped")
    assert not bool(res.failed[:len(GRID)].any())


@pytest.mark.parametrize("bank", list(BANKS))
@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("model", list(MODELS))
def test_fused_bank_matches_a_re_rolled_line_search(model, chunk, bank):
    fused, count = _solve(model, chunk, bank, "fused_candidate_eval")
    rolled, rolled_count = _solve(model, chunk, bank, "fold_candidate_eval")
    assert rolled_count["rollouts_run"] == rolled_count["iterations"] + 1
    assert "rollouts_reused" not in rolled_count
    assert count["ls_rounds"] == rolled_count["ls_rounds"]
    assert torch.equal(fused.iterations, rolled.iterations)
    assert torch.equal(fused.failed, rolled.failed)
    ok = ~fused.failed
    for name in ("l", "L", "x"):
        torch.testing.assert_close(getattr(fused, name),
                                   getattr(rolled, name), rtol=0, atol=1e-12)
    torch.testing.assert_close(fused.value[ok], rolled.value[ok], rtol=0,
                               atol=1e-12)


def test_trajectory_policy_matches_the_per_step_policy():
    """``feedback_control_traj`` over whole trajectories equals
    ``feedback_control`` step by step, also on lane-minor views such as
    kernels B and C return."""
    g = torch.Generator().manual_seed(0)
    B, T, m, n = 5, 7, 3, 4
    l, L, x, x_ref = (torch.randn(shape, generator=g, dtype=F64) for shape in
                      ((B, T, m), (B, T, m, n), (B, T, n), (B, T, n)))
    want = torch.stack([feedback_control(l[:, t], L[:, t], x[:, t],
                                         x_ref[:, t]) for t in range(T)], 1)

    def lane_minor(a):
        return a.movedim(0, -1).contiguous().movedim(-1, 0)

    for args in ((l, L, x, x_ref),
                 (l, lane_minor(L), lane_minor(x), lane_minor(x_ref))):
        torch.testing.assert_close(feedback_control_traj(*args), want,
                                   rtol=0, atol=1e-12)
