"""Run one cell of the benchmark of ratilqr_tpu_torch on one card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Loads and warms up the cell (``setup_s``),
then with ``--trace 0`` re-plans closed loop for ``--seconds`` and reports
the cell's end-to-end metrics, or with ``--trace 1`` profiles a few
re-plans and reports its per-layer metrics.  Either way it then holds the
judged lanes against the plain reference, prints each number compared
beside its limit as the last lines on standard error, and prints the
result as one JSON object on the last line of standard output.  Exits
non-zero, printing no result, without a card, with fewer cards than the
cell asks for, or if the JAX package or JAX was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ratilqr_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, the
    whole name compared."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return proc.stdout.strip().splitlines()[0] if proc.stdout else "not read"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from portbench.harness import cell as cellmod
    from portbench.harness import judge, registry

    cell = registry.Cell(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s), found "
              f"{found}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = cellmod.run(cell, args.seed, args.seconds, bool(args.trace),
                      device, T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: loaded {', '.join(loaded)}", file=sys.stderr)
        return 3

    info = {k: res[k] for k in ("replans", "window_s", "replan_p50_ms",
                                "replan_mean_ms", "replan_max_ms",
                                "gc_collections", "latency_samples", "setup_seconds",
                                "reference_s") if k in res}
    print(f"portbench: {args.workload} seed {args.seed} trace {args.trace} "
          f"on {power_limit()}: {json.dumps(info)}", flush=True)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device_info}
    if args.trace:
        device_info.update(busy_s=res["busy_s"], window_s=res["window_s"])
        line["breakdown"] = res["breakdown"]
    limits = cell.workload["limits"]
    line["reported"] = {k: v for k, v in res["judge"].items()
                        if k not in judge.COMPARED}
    line["checked"] = {k: {"value": res["judge"][k], "limit": limits[k]}
                       for k in judge.COMPARED}
    for text in res["lines"]:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
