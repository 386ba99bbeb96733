"""Counting the host's waits on the device, and the device's busy time."""
from __future__ import annotations

import contextlib
import time
import warnings

import torch


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
