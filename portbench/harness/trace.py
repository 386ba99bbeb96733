"""Reduce a ``torch.profiler`` trace of the traced sub-window to what the
per-layer metric readers read (:class:`TraceData`) and to the result's
``breakdown``.

The trace is read from the profiler's Chrome trace export: times in
microseconds on one clock for the host and the device.  Device operations
are the card's kernels, copies and sets; the markers of
:mod:`portbench.harness.spans` are left out of every sum.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

from portbench.harness.spans import MARKER_KERNEL, PREFIX

WINDOW_SPAN = PREFIX + "window"
TOP = 10
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_us: float
    dur_us: float


@dataclasses.dataclass
class StageCall:
    stage: str
    shape: Tuple[int, int, int, int]   # (n, m, T, B)
    device_s: float                    # everything between its markers


@dataclasses.dataclass
class TraceData:
    """What a per-layer metric reader reads."""
    replans: int
    window_s: float
    busy_s: float
    device_ops: List[DeviceOp]          # inside the window, in start order
    stage_calls: Optional[List[StageCall]]   # None: markers did not pair
    host_syncs: List[int]               # per counted re-plan
    dtype: str


def _union_s(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy * 1e-6


def _short(name: str) -> str:
    return name if len(name) <= 96 else name[:93] + "..."


def chrome_events(prof) -> List[dict]:
    """The complete events of a finished profile, through its Chrome trace
    export (written to a temporary file under ``TMPDIR`` and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f)["traceEvents"]
                    if e.get("ph") == "X"]
    finally:
        os.remove(path)


def reduce(events: List[dict], stage_calls, replans: int,
           host_syncs: List[int], dtype: str) -> Tuple[TraceData, Dict]:
    """``events``: :func:`chrome_events`; ``stage_calls``: the spans'
    recorded stage calls.  Returns the trace data and the breakdown."""
    host, device = [], []
    for e in events:
        span = (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if e.get("cat") in DEVICE_CATEGORIES:
            device.append(span)
        elif e.get("cat") == "user_annotation" and e["name"].startswith(
                PREFIX):
            host.append(span)
    window = [h for h in host if h[0] == WINDOW_SPAN]
    if len(window) != 1:
        raise RuntimeError(f"expected one {WINDOW_SPAN} span, found "
                           f"{len(window)}")
    w0, w1 = window[0][1], window[0][2]
    device.sort(key=lambda d: d[1])
    ops, markers = [], []
    for name, s, t in device:
        if MARKER_KERNEL in name:
            markers.append(s)
            continue
        if s >= w0 and s < w1:
            ops.append(DeviceOp(name, s, t - s))
    busy = _union_s((o.start_us, min(o.start_us + o.dur_us, w1))
                    for o in ops)

    calls: Optional[List[StageCall]] = None
    if len(markers) == 2 * len(stage_calls):
        calls = []
        for (stage, shape), (m0, m1) in zip(stage_calls,
                                            zip(markers[::2], markers[1::2])):
            inside = sum(o.dur_us for o in ops if m0 < o.start_us < m1)
            calls.append(StageCall(stage, shape, inside * 1e-6))

    data = TraceData(replans=replans, window_s=(w1 - w0) * 1e-6, busy_s=busy,
                     device_ops=ops, stage_calls=calls, host_syncs=host_syncs,
                     dtype=dtype)
    return data, breakdown(ops, host, w0, w1)


def breakdown(ops: List[DeviceOp], host, w0: float, w1: float) -> Dict:
    """The device operations that took most time, by name, and the idle
    time of the device by the innermost benchmark span open on the host
    (``between`` where none was), summed over the window's idle gaps."""
    by_name: Dict[str, float] = collections.defaultdict(float)
    for o in ops:
        by_name[_short(o.name)] += o.dur_us * 1e-6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    spans = [h for h in host if h[0] != WINDOW_SPAN]
    idle: Dict[str, float] = collections.defaultdict(float)
    cursor = w0
    for o in sorted(ops, key=lambda o: o.start_us) + [DeviceOp("", w1, 0.0)]:
        if o.start_us > cursor:
            mid = 0.5 * (cursor + o.start_us)
            open_ = [h for h in spans if h[1] <= mid < h[2]]
            label = (max(open_, key=lambda h: h[1])[0][len(PREFIX):]
                     if open_ else "between")
            idle[label] += (o.start_us - cursor) * 1e-6
        cursor = max(cursor, o.start_us + o.dur_us)
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k, v] for k, v in top_ops],
            "idle_gaps": [[k, v] for k, v in top_idle]}
