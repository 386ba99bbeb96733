"""Measure the largest dimension kernels A and D take on one CUDA card.

For each n of the probe list, builds kernel A at (n, n) and kernel D at n
for float32 and float64 (every unit in its own ``nvcc``, all started
together), then holds a B=4,099 launch of each against its plain version
on :func:`~ratilqr_tpu_torch.kernel_check.random_linear` ``(n, n)`` at
T=20: kernel A optimizing and evaluating with full outputs, kernel D with
a shared noise model.  (n, n) is the largest working set of any shape
whose n and m are at most n.  Prints one line per n and type with the
build's registers and stack frame, the check's result and the launch
time, then the limit: the largest n probed at which every check passed,
with every smaller n passing too.  ``ops/riccati_cuda.MAX_DIM`` holds the
measured value.

Run on a machine with a CUDA card, from the repository root:
``python -m ratilqr_tpu_torch.dim_limit [n ...]``.
"""
from __future__ import annotations

import concurrent.futures
import sys
import time

import torch

from ratilqr_tpu_torch import kernel_check
from ratilqr_tpu_torch.ops import _build, riccati_cuda

PROBE_DIMS = (6, 8, 16, 24, 32, 48, 64)
T = 20
B = 4_099
DTYPES = (torch.float32, torch.float64)


def _units(n: int):
    return [(kernel, shape, suffix)
            for kernel, shape in (("riccati", (n, n)), ("riccati_folded", (n,)))
            for suffix in ("f32", "f64")]


def _ptxas(kernel: str, shape, suffix: str) -> str:
    lib = _build.BUILD_DIR / _build.source_hash() / (
        f"shape_{kernel}_{_build.shape_tag(shape)}")
    log = (lib / "build.log").read_text()
    part = log[log.rfind(f"nvcc {kernel}.cu {suffix}"):]
    rows = _build.ptxas_report(part.split("\nnvcc ")[0])
    return "; ".join(f"{regs} registers, {stack} B stack"
                     for _, regs, _, _, stack in rows)


def probe(dims) -> int:
    """Build every unit, check each n in order; returns the limit (0 when
    the smallest n fails)."""
    units = [u for n in dims for u in _units(n)]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        futures = {u: pool.submit(_build.build_shape, *u) for u in units}
    built = {u: f.exception() for u, f in futures.items()}
    print(f"dim_limit: built {len(units)} units in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    riccati_cuda.MAX_DIM = max(dims)   # probe past the recorded limit
    device = torch.device("cuda", 0)
    limit = 0
    for n in sorted(dims):
        ok = True
        for unit in _units(n):
            if built[unit] is not None:
                ok = False
                print(f"n={n} {unit[0]} {unit[2]}: build failed: "
                      f"{str(built[unit])[-600:]}", flush=True)
            else:
                print(f"n={n} {unit[0]} {unit[2]}: ptxas "
                      f"{_ptxas(*unit)}", flush=True)
        for dtype in DTYPES if ok else ():
            model = f"linear{n}x{n}"
            try:
                t1 = time.perf_counter()
                err = max(
                    kernel_check.check_riccati(
                        model, T, B, dtype, device, optimizing=o, slim=False,
                        shared_w=True, has_dl=False)[0] for o in (True, False))
                err = max(err, kernel_check.check_riccati_folded(
                    model, T, B, dtype, device, True)[0])
                torch.cuda.synchronize()
                secs = time.perf_counter() - t1
                times = kernel_check.kernel_timings(model, T, B, dtype,
                                                    device, kernels=(
                                                        "riccati",
                                                        "riccati_folded"))
                print(f"n={n} {dtype}: agree, max |kernel - plain| "
                      f"{err:.3e} ({secs:.1f} s with the plain versions); "
                      "launch alone " + ", ".join(
                          f"{k} {v[1]:.3f} ms" for k, v in times.items()),
                      flush=True)
            except (AssertionError, RuntimeError, NotImplementedError,
                    torch.cuda.OutOfMemoryError) as e:
                ok = False
                print(f"n={n} {dtype}: FAILED: {str(e)[-600:]}", flush=True)
                break
            finally:
                kernel_check.clear_caches()
                torch.cuda.empty_cache()
        if not ok:
            break
        limit = n
    return limit


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("dim_limit: no CUDA device", file=sys.stderr)
        return 1
    dims = tuple(int(a) for a in argv) or PROBE_DIMS
    limit = probe(dims)
    print(f"dim_limit: the largest n probed ({', '.join(map(str, dims))}) at "
          f"which kernels A and D build and agree with their plain versions "
          f"at B={B}: {limit}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
