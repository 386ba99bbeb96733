"""Spans from the benchmark's side around the calls into the program.

While a :class:`Spans` is installed it replaces names that
``solvers/ileqg.py`` calls through its module globals with wrappers, and
restores them after.  When enabled, every wrapper opens a
``torch.profiler.record_function`` span ``pb.<name>`` on the host.  Around a
stage's entry (``step_optimize``: the fused outer step; ``candidate_bank``:
one line-search trial) it also launches a marker kernel on the current
stream before and after the call (``torch.cuda._sleep(0)``, a kernel named
``spin_kernel``), so that in the device trace everything the call ran lies
between its two markers, and records the call's shape ``(n, m, T, B)``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

STAGES = {"step_optimize": "step", "candidate_bank": "candidate"}
HOST_SPANS = ("initialize", "line_search", "rollout_feedback",
              "rollout_open_loop")
MARKER_KERNEL = "spin_kernel"
PREFIX = "pb."


class Spans:
    def __init__(self, module, device_markers: bool):
        self.module = module
        self.device_markers = device_markers
        self.enabled = False
        # (stage, (n, m, T, B)) of every stage call while enabled, in order
        self.stage_calls: List[Tuple[str, Tuple[int, int, int, int]]] = []

    def _mark(self):
        if self.device_markers:
            torch.cuda._sleep(0)

    def _wrap(self, name: str, fn):
        stage = STAGES.get(name)

        def wrapped(*args, **kwargs):
            if not self.enabled:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(PREFIX + name):
                if stage is None:
                    return fn(*args, **kwargs)
                # step_optimize(problem, x0, l, ...) and
                # candidate_bank(problem, x_ref, l_cand, ...)
                x, l = args[1], args[2]
                Bn, T, m = l.shape
                self.stage_calls.append((stage, (x.shape[-1], m, T, Bn)))
                self._mark()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self._mark()

        return wrapped

    @contextlib.contextmanager
    def installed(self):
        originals: Dict[str, object] = {}
        try:
            for name in (*STAGES, *HOST_SPANS):
                originals[name] = getattr(self.module, name)
                setattr(self.module, name, self._wrap(name, originals[name]))
            yield self
        finally:
            for name, fn in originals.items():
                setattr(self.module, name, fn)
