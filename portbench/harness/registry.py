"""Find what belongs to a cell by the names in ``BENCHMARK.json``.

Each configuration, cell, traffic mix and per-layer metric sits in a file
of its own under the benchmark's folder, named after it:

- ``configs/<config>.json``: the problem, horizon, type, start state, θ
  grid and solver settings; ``reference/models/<model>.py``: its plain
  model;
- ``workloads/<cell>.json``: the bank width, the re-plan state and the
  limits of the comparison;
- ``traffic/<traffic>.json``: the parameters the traffic generator reads;
- ``metrics/<metric>.py``: one per-layer metric reader.

Adding one of each is adding files; no file here names them.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent


def benchmark_path(root: Path = ROOT) -> Path:
    """``BENCHMARK.json`` at the root of the checkout that holds ``root``."""
    return root.parent / "BENCHMARK.json"


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads(benchmark_path(root).read_text())


def workload_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    """``<root>/<kind>/<name>.json``."""
    return json.loads((root / kind / f"{name}.json").read_text())


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``."""
    return load_module(root / "metrics" / f"{name}.py",
                       f"portbench_metric_{name}")


def reference_model(model: str, root: Path = ROOT) -> ModuleType:
    """The plain model ``reference/models/<model>.py``."""
    return load_module(root / "reference" / "models" / f"{model}.py",
                       f"portbench_model_{model}")


def metrics_for(bench: dict, section: str, workload: str) -> List[dict]:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that
    the cell reports: those that list it, and those that list no cell."""
    return [m for m in bench[section]
            if workload in m.get("workloads", [workload])]


class Cell:
    """Everything one run reads: the ``BENCHMARK.json`` entry and the
    cell's, configuration's and traffic's files."""

    def __init__(self, workload: str, root: Path = ROOT,
                 bench: Optional[dict] = None):
        self.root = root
        self.bench = bench if bench is not None else load_benchmark(root)
        self.entry = workload_entry(self.bench, workload)
        self.name = workload
        self.workload = load_json("workloads", workload, root)
        self.config = load_json("configs", self.entry["config"], root)
        self.traffic = load_json("traffic", self.entry["traffic"], root)

    @property
    def solver(self) -> Dict:
        """The configuration's solver settings, updated by the cell's."""
        return {**self.config["solver"], **self.workload.get("solver", {})}

    def metrics(self, section: str) -> List[dict]:
        return metrics_for(self.bench, section, self.name)
