"""Per-layer metric readers, one file each, named after the metric in
``BENCHMARK.json``.  Each declares its ``LAYER``, ``UNIT``, ``SOURCE`` and
the end-to-end metric it ``MOVES``, and ``read(trace)`` returns its value
from a :class:`portbench.harness.trace.TraceData`, or ``None`` where the
trace holds nothing to read.  ``work`` holds the frozen work counts the
roofline readers use."""
