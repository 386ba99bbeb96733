"""One run of one cell: set-up, the measured window (or the traced
sub-window), the reference, and the comparison.

The system under test is the program's θ-bank,
``ratilqr_tpu_torch.solvers.ileqg.make_batched_solver(problem, config)``,
driven closed loop: one controller, one re-plan in flight, each re-plan
issued once the previous one's ``value`` and ``failed`` are on the host.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, List, Optional

import torch

from portbench.harness import judge, registry, stats, traffic
from portbench.harness.spans import PREFIX, Spans
from portbench.harness.trace import WINDOW_SPAN, chrome_events, reduce
from portbench.reference import ileqg as reference

Tensor = torch.Tensor
MAX_REPLANS = 20_000


@dataclasses.dataclass
class Program:
    """The system under test at the cell's size, and its inputs."""
    bank: Callable
    module: object          # the program's solvers.ileqg
    thetas: Tensor          # (B,) on the device
    x0: Tensor              # (n,)
    u0: Tensor              # (T, m) zeros: the cold start
    xs: Tensor              # (R, n): re-plan i starts from xs[i]
    x_mpc: Tensor           # (n,): the warm-up re-plans' start
    plan: traffic.Plan
    u_warm: Optional[Tensor] = None   # (T, m): the cold solve's lane 0
    cold: Optional[judge.Lanes] = None  # the cold solve's lanes, on the host


def build(cell: registry.Cell, seed: int, device: torch.device,
          wrap_bank: Optional[Callable] = None) -> Program:
    from ratilqr_tpu_torch import models
    from ratilqr_tpu_torch.config import ILEQGConfig
    from ratilqr_tpu_torch.solvers import ileqg

    cfg = cell.config
    dtype = getattr(torch, cfg["dtype"])
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    n, m, T, B = cfg["n"], cfg["m"], cfg["T"], cell.workload["B"]
    problem = getattr(models, cfg["model"])(**cfg["params"], dtype=dtype,
                                            device=device)
    bank = ileqg.make_batched_solver(problem, ILEQGConfig(**cell.solver),
                                     device=device)
    if wrap_bank is not None:
        bank = wrap_bank(bank)
    grid = cfg["theta"]
    thetas = torch.linspace(grid["start"], grid["stop"], B,
                            dtype=torch.float64, device=device).to(dtype)
    plan = traffic.plan(seed, cell.traffic, n, B, MAX_REPLANS)
    x_mpc = torch.tensor(cell.workload["x_mpc"], dtype=torch.float64)
    return Program(
        bank=bank, module=ileqg, thetas=thetas,
        x0=torch.tensor(cfg["x0"], dtype=dtype, device=device),
        u0=torch.zeros((T, m), dtype=dtype, device=device),
        xs=(x_mpc + plan.deltas).to(device=device, dtype=dtype),
        x_mpc=x_mpc.to(device=device, dtype=dtype), plan=plan)


def gather(res, lanes: Tensor) -> judge.Lanes:
    idx = lanes.to(res.value.device)
    return judge.Lanes(res.l[idx], res.L[idx], res.value[idx],
                       res.iterations[idx], res.failed[idx])


def to_host(parts: List[judge.Lanes]) -> judge.Lanes:
    return judge.cat([judge.Lanes(*(t.cpu() for t in p)) for p in parts])


@dataclasses.dataclass
class Window:
    latencies: List[float]
    seconds: float
    lanes_done: int
    failed: object              # lanes failed or not finite (a tensor)
    judged: List[judge.Lanes]   # on the device until the window closes
    end: float = 0.0            # when the last re-plan was on the host
    gc_collections: Optional[List[int]] = None   # per generation


def replan(prog: Program, i: int, win: Window):
    """Re-plan ``i``: issue, wait for ``value`` and ``failed`` on the
    host, and keep the judged lanes."""
    t0 = time.perf_counter()
    res = prog.bank(prog.xs[i], prog.u_warm, prog.thetas)
    with torch.profiler.record_function(PREFIX + "fetch"):
        value, failed = res.value.cpu(), res.failed.cpu()
    win.end = time.perf_counter()
    win.latencies.append(win.end - t0)
    win.judged.append(gather(res, prog.plan.lanes[i]))
    win.lanes_done += value.numel()
    # counted on the device, read once the window has closed
    win.failed = win.failed + (res.failed | ~torch.isfinite(res.value)).sum()


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(prog: Program, seconds: float) -> Window:
    """Re-plans back to back until ``seconds`` have passed since the first
    was issued; the window ends when the last one's outputs are on the
    host."""
    win = Window([], 0.0, 0, 0, [])
    gc_before = [g["collections"] for g in gc.get_stats()]
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        if i == MAX_REPLANS:
            raise RuntimeError(f"more than {MAX_REPLANS} re-plans in the "
                               f"window: raise MAX_REPLANS")
        replan(prog, i, win)
        i += 1
    win.seconds = win.end - t0
    win.gc_collections = [g["collections"] - b for g, b in
                          zip(gc.get_stats(), gc_before)]
    return win


def traced(prog: Program, cell: registry.Cell, device: torch.device):
    """The traced sub-window: ``trace_replans`` re-plans under the profiler
    with the benchmark's spans, then ``sync_count_replans`` re-plans under
    the host-sync counter.  Returns the window (for the comparison), the
    trace data and the breakdown."""
    from torch.profiler import ProfilerActivity, profile

    from ratilqr_tpu_torch.utils.profiling import count_host_syncs

    spans = Spans(prog.module, device_markers=device.type == "cuda")
    win = Window([], 0.0, 0, 0, [])
    n_trace = cell.traffic["trace_replans"]
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with spans.installed():
        sync(device)
        spans.enabled = True
        with profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW_SPAN):
                for i in range(n_trace):
                    with torch.profiler.record_function(PREFIX + "replan"):
                        replan(prog, i, win)
                sync(device)
        spans.enabled = False
    syncs = []
    for i in range(n_trace, n_trace + cell.traffic["sync_count_replans"]):
        with count_host_syncs() as count:
            replan(prog, i, win)
        syncs.append(count.n)
    data, brk = reduce(chrome_events(prof), spans.stage_calls, n_trace, syncs,
                       cell.config["dtype"])
    return win, data, brk


class Reference:
    """The plain reference of a cell in ``dtype`` on ``device`` (the
    control: float32 with TF32 ``products``), from the same inputs as the
    program: its own cold solve of lanes ``cold_lanes``, whose lane 0 is its
    own warm start."""

    def __init__(self, cell: registry.Cell, thetas: Tensor, x0: Tensor,
                 cold_lanes: Tensor,
                 products: Optional[reference.Products] = None,
                 dtype=torch.float64, device="cpu"):
        cfg = cell.config
        problem = registry.reference_model(cfg["model"], cell.root).build(
            cfg["params"], dtype, device)
        fields = reference.Settings.__dataclass_fields__
        settings = reference.Settings(**{k: v for k, v in cell.solver.items()
                                         if k in fields})
        rtol = torch.finfo(getattr(torch, cfg["dtype"])).eps ** 0.5
        self.solve = reference.Solver(problem, settings, rtol, products)
        self.T, self.m = cfg["T"], cfg["m"]
        self.dtype, self.device = dtype, device
        self.thetas = thetas.to(device, dtype)
        self.cold_lanes = cold_lanes
        c = cold_lanes.numel()
        self.cold = self.solve(x0.to(device, dtype).expand(c, -1),
                               torch.zeros((c, self.T, self.m), dtype=dtype,
                                           device=device),
                               self.thetas[cold_lanes.to(device)])

    def warm(self, xs: Tensor, lanes: Tensor):
        """Re-plans of lanes ``lanes`` from states ``xs``, one a lane."""
        return self.solve(xs.to(self.device, self.dtype),
                          self.cold.l[0].expand(lanes.numel(), self.T,
                                                self.m),
                          self.thetas[lanes.to(self.device)])

    def lanes(self, xs: Tensor, lanes: Tensor) -> judge.Lanes:
        """The cold solve's lanes and the re-plans' lanes, on the host."""
        return judge.cat([_host(self.cold), _host(self.warm(xs, lanes))])


def _host(res) -> judge.Lanes:
    return judge.Lanes(*(getattr(res, f).cpu() for f in judge.Lanes._fields))


def judged_inputs(prog: Program, replans: int):
    """Start state and lane of every judged re-plan lane, on the host."""
    k = prog.plan.lanes.shape[1]
    return (prog.xs[:replans].cpu().repeat_interleave(k, 0),
            prog.plan.lanes[:replans].reshape(-1))


def compare(ref: Reference, out: judge.Lanes, xs: Tensor, lanes: Tensor):
    """The comparison's numbers of ``out`` (the cold solve's lanes, then
    the judged re-plan lanes) against the reference."""
    every = torch.cat([ref.cold_lanes, lanes])
    nums = judge.numbers(out, ref.lanes(xs, lanes))
    # where the largest gap lies: the solve, its lane and θ
    j = nums.pop("worst_position")
    nums["worst_in"] = "cold" if j < ref.cold_lanes.numel() else "replan"
    nums["worst_lane"] = int(every[j])
    nums["worst_lane_theta"] = float(ref.thetas.cpu()[every[j]])
    return nums


def cold_solve(prog: Program):
    """The cold solve from ``x0`` with ``u = 0`` over the plan's cold lanes
    (lane 0 first): its lane 0 is the warm start, its lanes are judged."""
    lanes = prog.plan.cold_lanes
    cold = prog.bank(prog.x0, prog.u0, prog.thetas[lanes.to(
        prog.thetas.device)])
    prog.u_warm = cold.l[0].contiguous()
    prog.cold = _host(cold)


def setup(prog: Program, cell: registry.Cell, device: torch.device):
    """The cold solve and the warm-up re-plans at the cell's width."""
    cold_solve(prog)
    for _ in range(cell.traffic["warmup_replans"]):
        res = prog.bank(prog.x_mpc, prog.u_warm, prog.thetas)
        res.value.cpu()
        del res
    sync(device)


def run(cell: registry.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float,
        wrap_bank: Optional[Callable] = None) -> Dict:
    """One run; returns the result's fields and the comparison's lines."""
    prog = build(cell, seed, device, wrap_bank)
    setup(prog, cell, device)
    setup_s = time.perf_counter() - t_start
    if trace:
        win, data, brk = traced(prog, cell, device)
    else:
        win = measure(prog, seconds)
    replans = len(win.latencies)
    failed = int(win.failed)
    out = judge.cat([prog.cold, to_host(win.judged)])
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del prog.bank, win.judged
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = Reference(cell, prog.thetas.cpu(), prog.x0.cpu(),
                    prog.plan.cold_lanes)
    nums = compare(ref, out, *judged_inputs(prog, replans))
    ref_s = time.perf_counter() - t_ref
    correct, lines = judge.decide(nums, cell.workload["limits"])

    result = {"correct": correct, "attempted": win.lanes_done,
              "failed": failed, "replans": replans,
              "memory_peak_bytes": peak, "judge": nums, "lines": lines,
              "setup_seconds": setup_s, "reference_s": ref_s}
    if trace:
        metrics = {}
        for entry in cell.metrics("per_layer"):
            value = registry.metric_reader(entry["name"], cell.root).read(
                data)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
        result.update(metrics=metrics, busy_s=data.busy_s,
                      window_s=data.window_s, breakdown=brk)
    else:
        e2e = {"solves_per_s": stats.rate(win.lanes_done, win.seconds),
               "replan_p90_ms": 1e3 * stats.percentile(win.latencies, 90),
               "setup_s": setup_s}
        result.update(
            metrics={e["name"]: {"value": e2e[e["name"]], "unit": e["unit"]}
                     for e in cell.metrics("end_to_end")},
            window_s=win.seconds,
            replan_p50_ms=1e3 * stats.percentile(win.latencies, 50),
            replan_mean_ms=1e3 * win.seconds / replans,
            replan_max_ms=1e3 * max(win.latencies),
            gc_collections=win.gc_collections, latency_samples=replans)
    return result
