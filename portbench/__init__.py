"""Benchmark of ratilqr_tpu_torch on one NVIDIA H100: ``python3
portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout (see ``BENCHMARK.json``)."""
