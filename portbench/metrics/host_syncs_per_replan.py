"""Host waits on the device per re-plan: every synchronizing CUDA operation
PyTorch's sync debug mode reports (``.item()``, ``bool()`` of a device
tensor, ``nonzero``, device-to-host copies) in the counted re-plans,
fetching ``value`` and ``failed`` included (the program's
``utils.profiling.count_host_syncs``)."""
LAYER = "Solver bank (solvers/ileqg.py, make_batched_solver)"
UNIT = "count"
SOURCE = "program_counter"
MOVES = "replan_p90_ms"


def read(trace):
    if not trace.host_syncs:
        return None
    return sum(trace.host_syncs) / len(trace.host_syncs)
