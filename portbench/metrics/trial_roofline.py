"""The line-search trial's share of its roofline: the least time of the
trial's work (closed-loop rollout, quadratization, fold, folded evaluating
DP) over the device time of everything the port ran inside the benchmark's
span around ``candidate_bank`` (kernel C and its layout copies), over
every trial and the initial evaluation.

The work is the frozen count of ``work.stage_work("candidate", n, m, T,
B)`` for each call, ``B`` the lanes it evaluated.  At the quadrotor's shape
(n=12, m=4, T=50) the operations govern the bound (67 TFLOP/s f32); at the
unicycle's (n=3, m=2, T=100) the bytes (3.35 TB/s)."""
from portbench.metrics.work import bound_s

LAYER = "Kernels: the fused line-search trial (csrc/candidate.cu, kernel C)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "solves_per_s"
STAGE = "candidate"
# The bound that governs at each configuration's shape (the CPU tests
# check it from the frozen counts).
GOVERNS = {"quadrotor_t50": "operations", "unicycle_t100": "bytes"}


def read(trace):
    calls = [c for c in trace.stage_calls or () if c.stage == STAGE]
    device_s = sum(c.device_s for c in calls)
    if not calls or device_s <= 0:
        return None
    least = sum(bound_s(STAGE, *c.shape, trace.dtype)[0] for c in calls)
    return 100.0 * least / device_s
