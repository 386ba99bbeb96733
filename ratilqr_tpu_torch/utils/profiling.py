"""Profiling and timing: steady-state timing that waits for the device,
``torch.profiler`` traces, the program's spans and counters, counting the
host's waits on the device, and the device's busy time.

Counterpart of :mod:`ratilqr_tpu.utils.profiling` (``sync``,
``time_fn``, ``trace``), plus :func:`span` (:func:`spanned`),
:data:`counters`, :func:`host_sync`, :func:`count_host_syncs` and
:func:`device_busy`.

The program opens spans named ``rq.<name>`` at its layer boundaries (the
solver bank, the stages, the kernel wrappers' layout copies and launches,
the rollouts, the kernel build) while a ``torch.profiler`` records, so they
lie on the profiler's clock beside the device trace; otherwise a span is
one check.  :data:`counters` always counts: bank calls, iterations,
line-search rounds and lanes, μ-restarts, library loads, each host sync by
its site (``sync.<site>``), and the bank's trajectories by their source
(``rollouts_reused``: taken from a candidate evaluation's states;
``rollouts_run``: a plain rollout run again).  Kernel launches are counted in
``ops._build.launch_counts``.
"""
from __future__ import annotations

import collections
import contextlib
import functools
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
    (Chrome trace format; open it in Perfetto), the program's ``rq.``
    spans (:func:`span`) among its host events::

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


SPAN_PREFIX = "rq."
_NO_SPAN = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled

counters: collections.Counter = collections.Counter()


def reset_counters() -> None:
    counters.clear()


def span(name: str):
    """A ``torch.profiler.record_function`` span ``rq.<name>`` while a
    torch profiler records (:func:`trace`, or any ``torch.profiler.profile``
    block); otherwise one shared no-op context::

        with profiling.span("line_search"):
            ...
    """
    if not _profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name)


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)``,
    whatever its call site."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def host_sync(site: str, fn: Callable, *args):
    """``fn(*args)``, a call that waits for the device (``bool`` of a device
    tensor, ``torch.nonzero``), as the host sync at ``site``: counts
    ``sync.<site>`` and opens span ``sync.<site>`` around the wait."""
    name = "sync." + site
    counters[name] += 1
    with span(name):
        return fn(*args)


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
