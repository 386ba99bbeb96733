"""Time the one-solve-per-team design of kernel C (``candidate``), B
(``step``), A (``riccati``, its slim optimizing pass) or D
(``riccati_folded``, shared noise model) in other team shapes, and kernel
A's and D's two staging forms.

Builds ``csrc/<kernel>.cu`` once per variant and working type with
``-DRQ_TEAM_LANES`` (lanes per team) and ``-DRQ_TEAMS`` (teams per
block), and for kernels A and D ``-DRQ_STAGE_BUFFERS`` (1: each step's
streamed blocks staged synchronously; 2: double-buffered, the next step's
copied by cp.async during this one), every unit in its own ``nvcc``, all
started together; prints each variant's registers, spills, stack frame and
shared memory a block; then times each variant's launch alone (median of
5, CUDA events) on the quadrotor at T=50 — float32 at B=16,384 and
262,144, float64 at 16,384 — in two passes, the variants in order and then
in reverse, and checks that each gives the shipped kernel's outputs
(kernels C and D: value; kernel B: x, value, L, dl; kernel A: value, L,
dl) and fail flags bit for bit.

Run on a machine with a CUDA card, from the repository root:
``python -m ratilqr_tpu_torch.team_sweep
[candidate|step|riccati|riccati_folded]`` (kernel C without an argument).
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import sys
import time

import torch

from ratilqr_tpu_torch import kernel_check
from ratilqr_tpu_torch.ops import (_build, candidate_cuda, riccati_cuda,
                                   step_cuda, tile_model)

# (lanes per team, teams per block); the first is shipped.
VARIANTS = ((16, 8), (16, 4), (16, 16), (32, 8), (32, 4))
# Kernels A's and D's: (lanes per team, teams per block, staging
# buffers); the first is shipped.
RICCATI_VARIANTS = ((16, 8, 2), (16, 8, 1), (16, 4, 2), (16, 16, 2),
                    (16, 16, 1), (32, 8, 2))
T = 50
WIDTHS = {torch.float32: (16_384, 262_144), torch.float64: (16_384,)}
LAUNCHES = {"candidate": candidate_cuda.launch_candidate,
            "step": step_cuda.launch_step,
            "riccati": lambda ins, shape, entry=None:
                riccati_cuda.launch_riccati(ins, shape, True, entry),
            "riccati_folded": riccati_cuda.launch_folded}
# Arguments of each kernel's shared-memory query on the quadrotor (kernel
# A: its slim optimizing pass; A and D: a shared noise model).
SMEM_QUERY = {"riccati": (12, 4, 1, 1), "riccati_folded": (12, 1)}


def variants(kernel):
    return (RICCATI_VARIANTS if kernel in ("riccati", "riccati_folded")
            else VARIANTS)


def _shared_memory(kernel, lib, suffix):
    """Shared memory a block of the variant ``lib`` takes on the quadrotor
    (``SMEM_QUERY``)."""
    teams, lanes = ctypes.c_int(), ctypes.c_int()
    query = getattr(lib, f"ratilqr_{kernel}_smem_{suffix}")
    shape = SMEM_QUERY.get(kernel, (tile_model.QUADROTOR,))
    return query(*shape, ctypes.byref(teams), ctypes.byref(lanes))


def _build_variant(kernel, variant, suffix):
    lanes, teams, *buffers = variant
    out_dir = (_build.BUILD_DIR / _build.source_hash()
               / f"team_{kernel}_{'x'.join(map(str, variant))}")
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{kernel}_{suffix}.so"
    proc, secs = _build._run([
        _build._nvcc(), *_build.CODEGEN_FLAGS, *_build.LINK_FLAGS,
        f"-DRQ_DTYPE={_build._SUFFIXES.index(suffix)}",
        f"-DRQ_TEAM_LANES={lanes}", f"-DRQ_TEAMS={teams}",
        *(f"-DRQ_STAGE_BUFFERS={b}" for b in buffers), "-o", str(lib),
        str(_build.CSRC_DIR / f"{kernel}.cu")])
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {variant} ({suffix}):\n"
                           f"{proc.stderr[-3000:]}")
    rows = [r for r in _build.ptxas_report(proc.stdout + proc.stderr)
            if f"{kernel}_team_kernel" in r[0]]
    return _build._bind(ctypes.CDLL(str(lib)), (suffix,)), rows, secs


def _same(a, b) -> bool:
    """Every output of two launches equal bit for bit (NaN equal to NaN)."""
    return all(torch.equal(x.nan_to_num(), y.nan_to_num())
               for x, y in zip(a, b))


def sweep(kernel, device) -> None:
    units = [(v, s) for v in variants(kernel) for s in ("f32", "f64")]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        built = dict(zip(units, pool.map(
            lambda u: _build_variant(kernel, *u), units)))
    print(f"team sweep {kernel}: built {len(units)} units in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    entries = {}
    for (variant, suffix), (lib, rows, secs) in built.items():
        entries[variant, suffix] = getattr(lib, f"ratilqr_{kernel}_{suffix}")
        nbytes = _shared_memory(kernel, lib, suffix)
        for name, regs, stores, _, stack in rows:
            print(f"team sweep {variant} {suffix} {_build.short_name(name)}: "
                  f"{regs} registers, {stores} B spill stores, {stack} B "
                  f"stack frame ({secs:.1f} s nvcc); {nbytes} B shared "
                  "memory a block", flush=True)
    for dtype, widths in WIDTHS.items():
        suffix = _build.dtype_suffix(dtype)
        for B in widths:
            case = kernel_check.timing_cases("quadrotor", T, B, dtype,
                                             device)[kernel]()
            args = case[1]()
            launch = LAUNCHES[kernel]
            shipped = launch(*args)
            times = {}
            for variant in variants(kernel) + variants(kernel)[::-1]:
                entry = entries[variant, suffix]
                out = launch(*args, entry)
                times.setdefault(variant, []).append(kernel_check.time_ms(
                    lambda: launch(*args, entry)))
                if len(times[variant]) == 2:
                    print(f"team sweep {kernel} {dtype} B={B} (lanes, teams"
                          f"{', buffers' if len(variant) > 2 else ''}) "
                          f"{variant}: launch alone "
                          f"{times[variant][0]:.3f} / {times[variant][1]:.3f}"
                          f" ms (two passes); shipped outputs and flags: "
                          f"{_same(out, shipped)}", flush=True)
            del case, args, shipped
            torch.cuda.empty_cache()


def main(argv=()) -> int:
    kernel = argv[0] if argv else "candidate"
    if kernel not in LAUNCHES or len(argv) > 1:
        print(f"usage: python -m ratilqr_tpu_torch.team_sweep "
              f"[{'|'.join(LAUNCHES)}]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("team_sweep: no CUDA device", file=sys.stderr)
        return 1
    sweep(kernel, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
