"""The frozen work counts against a hand count, and the bound that governs
at each cell's shape against what the roofline readers state."""
import pytest

from portbench.harness import registry
from portbench.metrics import work


def test_step_hand_count():
    # n = m = 1, T = 2, B = 3, float32.  A lane reads x0 (1), l (T·m = 2),
    # θ and μ (2) and writes x ((T+1)·n = 3), L and dl (T·(mn + m) = 4)
    # and the value (1): 13 words, 52 bytes, and two flag bytes.  The
    # shared noise model is T·(2n² + 1) = 6 words once.  One optimizing DP
    # step at n = m = 1: factor of M 7, DS, Ds⃗, B^T D s⃗ and g 4, B^T DS and
    # G 3, H 3, L and dl 7, s 22, s⃗ 8, S 9: 63 operations.
    assert work.dp_step_ops(1, 1) == 63
    assert work.stage_work("step", 1, 1, 2, 3) == (3 * (52 + 2) + 24,
                                                   3 * 2 * 63)


def test_candidate_hand_count():
    # n = m = 1, T = 2, B = 3, float32.  A lane reads x̄ ((T+1)·n = 3), l
    # (2), L (2), θ and μ (2) and writes the value (1): 10 words, 40 bytes,
    # and one flag byte; the noise model 24 bytes once.  A step folds (19
    # operations: q̄⃗, Q̄, Ā and the two policy evaluations) and runs one
    # folded evaluating DP step (30).
    assert work.fold_ops(1, 1) == 19
    assert work.folded_step_ops(1) == 30
    assert work.stage_work("candidate", 1, 1, 2, 3) == (3 * (40 + 1) + 24,
                                                        3 * 2 * 49)


@pytest.mark.parametrize("metric", ["step_roofline", "trial_roofline"])
def test_governing_bound_at_each_cell(metric):
    """What the reader states for each configuration holds at the width of
    every cell of it, and at 262,144 lanes."""
    reader = registry.metric_reader(metric)
    bench = registry.load_benchmark()
    widths = {}
    for entry in bench["workloads"]:
        cell = registry.Cell(entry["name"], bench=bench)
        widths.setdefault(entry["config"], []).append(cell.workload["B"])
    for config in {e["config"] for e in bench["workloads"]}:
        assert config in reader.GOVERNS
    for config, stated in reader.GOVERNS.items():
        cfg = registry.load_json("configs", config)
        for B in widths.get(config, []) + [262144]:
            _, governs = work.bound_s(reader.STAGE, cfg["n"], cfg["m"],
                                      cfg["T"], B, cfg["dtype"])
            assert governs == stated, (config, B)


def test_bound_is_the_larger():
    nbytes, ops = work.stage_work("step", 12, 4, 50, 262144)
    t, which = work.bound_s("step", 12, 4, 50, 262144)
    assert which == "operations"
    assert t == pytest.approx(ops / 67e12)
    assert t > nbytes / 3.35e12
