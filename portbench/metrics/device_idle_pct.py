"""The card's idle share over the traced sub-window: one minus the union
of its kernel, copy and set intervals over the sub-window's length (the
program's ``utils.profiling.device_busy`` method), with the profiler on."""
LAYER = "Device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "solves_per_s"


def read(trace):
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
