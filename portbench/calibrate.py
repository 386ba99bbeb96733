"""Readings that set a cell's limits: the program's comparison numbers over
many seeds, the control's, and a θ mix-up's, in one process on the card.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,...,12 \\
        --control-seeds 1,2,3 --mixup-seeds 1,2,3 --replans 16 --lanes 64

The program is the cell's θ-bank at the cell's width, built once; for each
seed it runs that seed's cold solve, re-plans ``--replans`` times closed
loop from that seed's states and is judged on the cold lanes and
``--lanes`` lanes a re-plan, as a run is.  The control is the plain
reference computed in float32 with every matrix product's operands rounded
to TF32, on the card, put in the program's place on the same lanes (the
lanes of a bank are independent, so its outputs there are those it would
give at the cell's width).  The θ mix-up is the program answering each
judged re-plan lane with its answer for the lane a quarter of the grid
away.  All are held against the float64 reference.  Prints one line of
numbers per seed and side, and a JSON summary as the last line.  Not run
by the benchmark's runs.
"""
import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--mixup-seeds", default="")
    p.add_argument("--replans", type=int, default=16)
    p.add_argument("--lanes", type=int, default=64)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def quarter_away(lanes, B: int):
    """The lane a quarter of the grid away from each of ``lanes``."""
    return (lanes + B // 4).where(lanes < B - B // 4, lanes - B // 4)


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from portbench.harness import cell as cellmod
    from portbench.harness import judge, registry, traffic
    from portbench.reference import ileqg as reference

    device = torch.device(args.device)
    seeds, control = _seeds(args.seeds), _seeds(args.control_seeds)
    mixup = _seeds(args.mixup_seeds)
    cell = registry.Cell(args.workload)
    cell.traffic = {**cell.traffic, "judged_lanes_per_replan": args.lanes}
    cfg = cell.config
    n, B = cfg["n"], cell.workload["B"]
    x_mpc = torch.tensor(cell.workload["x_mpc"], dtype=torch.float64)
    plans = {s: traffic.plan(s, cell.traffic, n, B, args.replans)
             for s in sorted(set(seeds) | set(control) | set(mixup))}

    prog = cellmod.build(cell, seeds[0], device)
    outs, mixed = {}, {}
    for s in sorted(set(seeds) | set(mixup)):
        t = time.perf_counter()
        prog.plan = plans[s]
        prog.xs = (x_mpc + plans[s].deltas).to(device=device,
                                                 dtype=prog.x0.dtype)
        cellmod.cold_solve(prog)
        win = cellmod.Window([], 0.0, 0, 0, [])
        for i in range(args.replans):
            cellmod.replan(prog, i, win)
        outs[s] = judge.cat([prog.cold, cellmod.to_host(win.judged)])
        print(f"seed {s}: cold solve and {args.replans} re-plans "
              f"{time.perf_counter() - t:.1f} s, re-plan median "
              f"{1e3 * sorted(win.latencies)[len(win.latencies) // 2]:.1f}"
              f" ms, failed lanes {int(win.failed)}", flush=True)
        if s in mixup:
            prog.plan = traffic.Plan(plans[s].deltas,
                                     quarter_away(plans[s].lanes, B),
                                     plans[s].cold_lanes)
            win = cellmod.Window([], 0.0, 0, 0, [])
            for i in range(args.replans):
                cellmod.replan(prog, i, win)
            mixed[s] = judge.cat([prog.cold, cellmod.to_host(win.judged)])
    thetas, x0 = prog.thetas.cpu(), prog.x0.cpu()
    inputs = {}
    for s in plans:
        prog.plan = plans[s]
        prog.xs = (x_mpc + plans[s].deltas).to(dtype=prog.x0.dtype)
        inputs[s] = cellmod.judged_inputs(prog, args.replans)
    del prog
    if device.type == "cuda":
        torch.cuda.empty_cache()

    summary = {"workload": args.workload, "program": {}, "control": {},
               "mixup": {}}
    for s in plans:
        t = time.perf_counter()
        ref = cellmod.Reference(cell, thetas, x0, plans[s].cold_lanes)
        sides = []
        if s in outs and s in seeds:
            sides.append(("program", outs[s]))
        if s in mixed:
            sides.append(("mixup", mixed[s]))
        if s in control:
            ctrl = cellmod.Reference(cell, thetas, x0, plans[s].cold_lanes,
                                     reference.Products(tf32=True),
                                     torch.float32, args.device)
            sides.append(("control", ctrl.lanes(*inputs[s])))
        for side, out in sides:
            nums = cellmod.compare(ref, out, *inputs[s])
            summary[side][s] = nums
            print(f"{side} seed {s}: {json.dumps(nums)}", flush=True)
        print(f"seed {s}: reference {time.perf_counter() - t:.1f} s",
              flush=True)
    for side in ("program", "control", "mixup"):
        for k in judge.COMPARED + ("value_gap",):
            vals = [v[k] for v in summary[side].values()]
            if vals:
                summary[f"{side}_{k}"] = [min(vals), max(vals)]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
