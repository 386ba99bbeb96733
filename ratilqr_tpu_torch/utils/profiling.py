"""Profiling and timing: steady-state timing that waits for the device,
named phase timers, ``torch.profiler`` traces, counting the host's waits
on the device, and the device's busy time.

Counterpart of :mod:`ratilqr_tpu.utils.profiling` (``sync``,
``time_fn``, ``trace``, ``PhaseTimer``), plus :func:`count_host_syncs`
and :func:`device_busy`.
"""
from __future__ import annotations

import contextlib
import os
import statistics
import time
import warnings
from typing import Callable, Dict, List

import torch

from ratilqr_tpu_torch.utils.tree import flatten_with_paths


def sync(tree) -> float:
    """Wait for the computation behind ``tree`` by fetching one element of
    its first tensor leaf to the host (which waits for every earlier
    operation on that tensor's stream); returns that element."""
    leaf = next(x for x in flatten_with_paths(tree)[1]
                if isinstance(x, torch.Tensor) and x.numel() > 0)
    return float(leaf.reshape(-1)[:1].cpu()[0])


def time_fn(fn: Callable, *args, warmup: int = 1, reps: int = 5,
            **kwargs) -> Dict[str, float]:
    """Steady-state wall-clock timing of ``fn(*args, **kwargs)``: each
    call ends in :func:`sync` of its output.  Returns seconds, ``{"best",
    "median", "mean", "compile"}``, where ``compile`` is the first
    (warm-up) call's time: on the card it holds the kernels' first-use
    build and load."""
    t0 = time.perf_counter()
    sync(fn(*args, **kwargs))
    compile_s = time.perf_counter() - t0
    for _ in range(warmup - 1):
        sync(fn(*args, **kwargs))
    times: List[float] = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sync(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return {"best": min(times), "median": statistics.median(times),
            "mean": statistics.fmean(times), "compile": compile_s}


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block (host activity, and
    the card's where CUDA is available) into ``<log_dir>/trace.json``
    (Chrome trace format; open it in Perfetto)::

        with profiling.trace("traces/bank"):
            bank(x0, u0, thetas)
    """
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class PhaseTimer:
    """Accumulating named-phase wall timer for host-orchestrated loops
    (CE generations, NM vertex evaluations, MPC re-plans)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_s": self.totals[k] / self.counts[k]}
                for k in self.totals}


class SyncCount:
    """Result of :func:`count_host_syncs`: ``n`` after the block ends."""
    n: int = 0


@contextlib.contextmanager
def count_host_syncs():
    """Count the synchronizing CUDA operations in the block (``.item()``,
    ``bool()`` of a device tensor, ``nonzero``, device-to-host copies,
    stream synchronizations): every one PyTorch's sync debug mode reports.
    Counts nothing where CUDA is not available."""
    count = SyncCount()
    if not torch.cuda.is_available():
        yield count
        return
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield count
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    # Only the per-operation report: enabling the mode also warns once
    # that it is a prototype, and that message mentions synchronizing too.
    count.n = sum("called a synchronizing CUDA operation" in str(w.message)
                  for w in caught)


def device_busy(fn):
    """Run ``fn()`` once on a synchronized CUDA device under
    ``torch.profiler`` (device activity only); returns ``(out, wall s,
    busy s)``, where busy is the union of the device's kernel and copy
    intervals, so ``1 − busy/wall`` is the device's idle share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return out, wall, busy_us * 1e-6
