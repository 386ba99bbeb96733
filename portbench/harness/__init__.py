"""The benchmark's general parts: finding cells, configurations, traffic
and metric readers by name; the traffic generator; the run; the reduction
of traces to metrics; and the comparison that decides ``correct``."""
