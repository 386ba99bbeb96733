"""Device time per re-plan of every operation that is not one of the
port's hand-written kernels: the plain PyTorch rollouts, selects and
reductions, the layout copies into and out of the kernels' lane-minor
layout, and the copies to the host.  The port's kernels are named by
``HAND_WRITTEN`` (the ``__global__`` functions of ``csrc/*.cu``)."""
import re

LAYER = ("Plain ops and layout copies (ops/rollout.py, ops/approx.py, "
         "copies in ops/*_cuda.py)")
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "solves_per_s"

HAND_WRITTEN = re.compile(
    r"\b(?:step|candidate|riccati|riccati_folded)(?:_team|_small)?_kernel\b")


def read(trace):
    if not trace.device_ops or trace.replans == 0:
        return None
    plain_us = sum(o.dur_us for o in trace.device_ops
                   if not HAND_WRITTEN.search(o.name))
    return plain_us * 1e-3 / trace.replans
