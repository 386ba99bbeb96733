"""A run drives the timed path broken underneath and sees ``correct`` come
out false: once for each fault a θ-bank cell can have, and once with the
control (the plain reference in float32 with TF32 products) in the
program's place.  On the CPU at a small width: the program runs its plain
versions, the comparison and the limits are the cell's."""
import pytest
import torch

from portbench.harness import cell as cellmod
from portbench.reference import ileqg as reference
from portbench.tests.support import CPU, checkout, small_cell


class _Result:
    def __init__(self, l, L, value, iterations, failed):
        self.l, self.L, self.value = l, L, value
        self.iterations, self.failed = iterations, failed


def _fields(res):
    return [res.l, res.L, res.value, res.iterations, res.failed]


def _half_batch(bank):
    """Solves the first half of the lanes; the rest are left as they came
    in (the warm start, zero gains, no iteration)."""
    def run(x0, u, thetas):
        half = thetas.shape[0] // 2
        res = bank(x0, u, thetas[:half])
        rest = thetas.shape[0] - half
        left = [u.expand(rest, -1, -1), torch.zeros_like(res.L[:rest]),
                torch.zeros_like(res.value[:rest]),
                torch.zeros_like(res.iterations[:rest]),
                torch.zeros_like(res.failed[:rest])]
        return _Result(*(torch.cat([t, r]) for t, r in zip(_fields(res),
                                                            left)))
    return run


def _altered(bank, lane=1, what="l"):
    """Lane ``lane``'s answer altered as it leaves the bank."""
    def run(x0, u, thetas):
        out = _fields(bank(x0, u, thetas))
        if what == "l":
            out[0] = out[0].clone()
            out[0][lane] *= 1.002
        else:
            out[4] = out[4].clone()
            out[4][lane] = ~out[4][lane]
        return _Result(*out)
    return run


def _theta_mixup(cell):
    """Every lane answered with the plan for the θ a quarter of the grid
    away, up or down, whichever stays on the grid."""
    grid, B = cell.config["theta"], cell.workload["B"]
    shift = (grid["stop"] - grid["start"]) * (B // 4) / (B - 1)

    def wrap(bank):
        def run(x0, u, thetas):
            up = thetas + shift <= grid["stop"] * (1 + 1e-6)
            return bank(x0, u, torch.where(up, thetas + shift,
                                           thetas - shift))
        return run
    return wrap


def _unchanged_step(monkeypatch):
    from ratilqr_tpu_torch.solvers import ileqg

    def step(problem, config, state, theta, x0, noise, active=None):
        return state._replace(iterations=state.iterations + 1)
    monkeypatch.setattr(ileqg, "step", step)


@pytest.fixture
def cell(tmp_path):
    root = checkout(tmp_path)
    return small_cell(root, "quadrotor_fused_warm_262k", B=16, T=10)


def _run(cell, wrap=None):
    return cellmod.run(cell, 2 ** 31 + 5, 0.01, False, CPU,
                       0.0, wrap_bank=wrap)


def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["lines"]


@pytest.mark.parametrize("fault", ["unchanged_step", "half_batch",
                                   "altered_answer", "altered_flag",
                                   "theta_mixup"])
def test_fault_is_caught(cell, fault, monkeypatch):
    wrap = None
    if fault == "unchanged_step":
        _unchanged_step(monkeypatch)
    elif fault == "half_batch":
        wrap = _half_batch
    elif fault == "altered_answer":
        wrap = _altered
    elif fault == "theta_mixup":
        wrap = _theta_mixup(cell)
    else:
        def wrap(bank):
            return _altered(bank, what="failed")
    res = _run(cell, wrap)
    assert not res["correct"], res["lines"]


def _control_bank(cell):
    """The control in the program's place: the plain reference in float32
    with every matrix product's operands rounded to TF32."""
    from portbench.harness import registry
    cfg = cell.config
    fields = reference.Settings.__dataclass_fields__
    solve = reference.Solver(
        registry.reference_model(cfg["model"], cell.root).build(
            cfg["params"], torch.float32, "cpu"),
        reference.Settings(**{k: v for k, v in cell.solver.items()
                              if k in fields}),
        torch.finfo(torch.float32).eps ** 0.5, reference.Products(tf32=True))

    def wrap(_bank):
        def run(x0, u, thetas):
            B = thetas.shape[0]
            x0 = x0.expand(B, -1) if x0.dim() == 1 else x0
            u = u.expand(B, -1, -1) if u.dim() == 2 else u
            return solve(x0, u, thetas)
        return run
    return wrap


def test_control_is_not_correct(tmp_path):
    """At the configuration's own horizon, a few lanes."""
    root = checkout(tmp_path)
    c = small_cell(root, "quadrotor_fused_warm_262k", B=8,
                   judged_lanes_per_replan=3)
    res = _run(c, _control_bank(c))
    assert not res["correct"], res["lines"]
