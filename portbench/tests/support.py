"""Helpers of the benchmark's CPU tests: a temporary checkout holding the
benchmark (and the program beside it), with cells cut to a size a CPU test
run can hold."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from portbench.harness import registry

PORTBENCH = Path(__file__).resolve().parent.parent
CHECKOUT = PORTBENCH.parent


def checkout(tmp: Path, with_program: bool = True) -> Path:
    """Copy ``BENCHMARK.json`` and the benchmark's folder into ``tmp``
    (and link the program beside them); returns the copy's benchmark
    folder."""
    shutil.copytree(PORTBENCH, tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    if with_program:
        (tmp / "ratilqr_tpu_torch").symlink_to(CHECKOUT / "ratilqr_tpu_torch")
    return tmp / "portbench"


def edit_json(path: Path, **changes):
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


def small_cell(root: Path, workload: str, B: int, T: int = 0,
               **traffic) -> registry.Cell:
    """The cell ``workload`` of the copy at ``root`` cut to ``B`` lanes
    (and horizon ``T`` where given), with traffic changes."""
    edit_json(root / "workloads" / f"{workload}.json", B=B)
    cell = registry.Cell(workload, root=root)
    if T:
        cfg = cell.config
        edit_json(root / "configs" / f"{cell.entry['config']}.json", T=T,
                  params={**cfg["params"], "N": T})
    if traffic:
        edit_json(root / "traffic" / f"{cell.entry['traffic']}.json",
                  **traffic)
    return registry.Cell(workload, root=root)


CPU = torch.device("cpu")
