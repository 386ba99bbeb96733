"""On the card: one short run of each cell prints a correct result line.
Run there with ``python3 -m pytest -p no:cacheprovider
portbench/tests/test_portbench_card.py``; skips without a card."""
import json
import subprocess
import sys

import pytest
import torch

from portbench.tests.support import CHECKOUT

WORKLOADS = [w["name"] for w in json.loads(
    (CHECKOUT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_short_run_is_correct(card, workload):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 99), "--seconds", "2", "--trace", "0"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], proc.stderr[-2000:]
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"solves_per_s", "replan_p90_ms",
                                    "setup_s"}
