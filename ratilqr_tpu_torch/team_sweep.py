"""Time the one-solve-per-team design of kernel C (``candidate``), B
(``step``), A (``riccati``, its slim optimizing pass) or D
(``riccati_folded``, shared noise model) in other team shapes, and kernel
A's and D's two staging forms; for kernels C, B, A and D also their n ≤ 4
design in other team widths, block sizes and (C, A) staging forms, and at
the main paths' widths.

Builds ``csrc/<kernel>.cu`` (kernel A: its (12, 4) alone,
``-DRQ_SHAPE_N/M``) once per variant and working type with
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

Kernels C, B, A and D at n ≤ 4 (``candidate``, ``step``, ``riccati``,
``riccati_folded``; float32): each ``SMALL_VARIANTS`` (C),
``STEP_VARIANTS`` (B), ``RICCATI_SMALL_VARIANTS`` (A) or
``RICCATI_FOLDED_SMALL_VARIANTS`` (D) entry — lanes a solve K of 1 or 4,
threads a block and, for C, staging by cp.async on or off where K > 1,
for A how a team gets each step's blocks (read from device memory into
registers or staged by cp.async) — builds with ``-DRQ_SMALL_LANES``,
``-DRQ_SMALL_THREADS`` (and ``-DRQ_WIDE_THREADS``, the threads at K = 1),
``-DRQ_SMALL_STAGE`` or ``-DRQ_STEP_FORM``, as do the flag check's
builds below; the sweep prints each one's ptxas report and,
where the toolkit has ``cuobjdump``, the count of each kind of load,
store, shuffle and barrier in its SASS; it times each (the variants and
the flag check's builds) at ``SMALL_CELLS`` / ``STEP_CELLS`` /
``RICCATI_CELLS`` / ``RICCATI_FOLDED_CELLS`` (the unicycle T=30 at B=1
and 942, B's and D's also at RAT iLQR's T=100, B=10, A's and D's at
T=100, B=8,192, the unicycle T=100 and the cartpole T=50 at B=16,384 and
262,144) in two passes and checks each against the shipped build (whose
launch picks K) bit for bit; kernel A in both slim passes, optimizing
and evaluating, kernel D with a shared and a per-lane noise model
(``PASSES``).  Then it times the shipped launch at ``WIDTH_CELLS`` /
``STEP_WIDTH_CELLS`` / ``RICCATI_WIDTH_CELLS`` /
``RICCATI_FOLDED_WIDTH_CELLS`` (the unicycle T=30 and T=100 and the
cartpole T=50, each at B = 1, 256, 640, 942, 16,384, 32,768, 65,536 and
262,144 for C, 1, 10, 256, 942, 16,384, 32,768 and 262,144 for B, and
for A and D the paths' widths and the edges of their bands, ``WIDTHS_A``
and ``WIDTHS_D``) with the K (and A's form) it picks.  ``--baseline DIR``
also builds ``DIR/<kernel>.cu`` (the csrc directory of another checkout,
e.g. the parent commit's) and times
it beside the shipped build at every width cell, in turns (baseline,
shipped, shipped, baseline, ``TURNS`` times, with the medians), with its
largest difference from the shipped values and whether its fail flags
are equal.  Last, at
``FLAG_CASE`` (the cartpole fixture on which the float32 fail flags
disagreed with the plain version before the contraction policy of
``csrc/smallmat.cuh``), it lists the lanes whose float32 fail flags
differ from float64's in the shipped build, a build without fused
multiply-adds (``-fmad=false``), a build at each level of the policy
(``-DRQ_PSD_ROUNDING`` = 0: off, 1: M and the pivots, 2: also the S
update), the baseline and the plain version; and for kernel D, at
``DRIFT_CASE``, each one's largest float32 value error against float64
and its ratio to the drift rule of ``kernel_check`` (``drift_check``).
With each lane it names, kernel D's checks print the smallest eigenvalue
of M over the float64 pass, relative to W⁻¹'s scale: how near the lane
is to neurotic breakdown.

``policy`` builds every kernel with the contraction policy off and times
each beside the shipped build at ``POLICY_CELLS`` (``chip_smoke.py``
phase 9's cells), in turns; ``flags [--baseline DIR]`` runs the flag
check of kernels C, B, A and D alone.

Run on a machine with a CUDA card, from the repository root:
``python -m ratilqr_tpu_torch.team_sweep [candidate|step|riccati|
riccati_folded [--baseline DIR]|policy|flags [--baseline DIR]]`` (kernel
C without an argument).
"""
from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from ratilqr_tpu_torch import kernel_check
from ratilqr_tpu_torch.ops import (_build, candidate_cuda, riccati_cuda,
                                   step_cuda, tile_model)
from ratilqr_tpu_torch.ops.approx import Approximation

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
# A: a width, its optimizing pass; A and D: a width and a shared noise
# model; B and C: a width).
SMEM_QUERY = {"riccati": (12, 4, 16_384, 1, 1),
              "riccati_folded": (12, 16_384, 1),
              "candidate": (tile_model.QUADROTOR, 16_384),
              "step": (tile_model.QUADROTOR, 16_384)}
# Kernel C at n <= 4: (lanes a solve, threads a block, staged where
# K > 1); the shipped build picks the lanes from the width ((1, 64, 0) and
# (4, 128, 1) are its kernels).
SMALL_VARIANTS = ((1, 64, 0), (1, 128, 0), (1, 32, 0), (4, 128, 1),
                  (4, 128, 0), (4, 64, 1))
SMALL_CELLS = (("unicycle", 30, 1), ("unicycle", 30, 942),
               ("unicycle", 100, 16_384), ("unicycle", 100, 262_144),
               ("cartpole", 50, 16_384), ("cartpole", 50, 262_144))
WIDTHS_C = (1, 256, 640, 942, 16_384, 32_768, 65_536, 262_144)
WIDTH_CELLS = tuple((model, T_, B) for model, T_ in (
    ("unicycle", 30), ("unicycle", 100), ("cartpole", 50))
    for B in WIDTHS_C)
# Kernel B at n <= 4: (lanes a solve, threads a block); the shipped build
# picks the lanes from the width ((4, 128) and (1, 64) are its kernels;
# no step is staged, and the model blocks are a step ahead at every K).
STEP_VARIANTS = ((4, 128), (4, 64), (1, 64), (1, 128), (1, 32))
STEP_CELLS = (("unicycle", 30, 1), ("unicycle", 100, 10),
              ("unicycle", 30, 942), ("unicycle", 100, 16_384),
              ("unicycle", 100, 262_144), ("cartpole", 50, 16_384),
              ("cartpole", 50, 262_144))
WIDTHS_B = (1, 10, 256, 942, 16_384, 32_768, 262_144)
STEP_WIDTH_CELLS = tuple((model, T_, B) for model, T_ in (
    ("unicycle", 30), ("unicycle", 100), ("cartpole", 50))
    for B in WIDTHS_B)
# Kernel A at n, m <= 4: (lanes a solve, threads a block, form: 0 each
# step's blocks read from device memory into registers, 1 staged by
# cp.async in two shared buffers; -DRQ_STEP_FORM); the shipped build picks
# the lanes and the form from the width.  Both slim passes (optimizing;
# evaluating with no dl stream, as the bank's line search).
RICCATI_SMALL_VARIANTS = ((4, 128, 0), (4, 128, 1), (4, 64, 1), (1, 64, 0),
                          (1, 64, 1), (1, 128, 0), (1, 32, 0))
RICCATI_CELLS = (("unicycle", 30, 1), ("unicycle", 30, 942),
                 ("unicycle", 100, 8_192), ("cartpole", 50, 16_384),
                 ("unicycle", 100, 262_144), ("cartpole", 50, 262_144))
# Rounds of turns at each width cell (baseline, shipped, shipped,
# baseline): a kernel of 0.1-0.3 ms varies by ±10% between timings.
TURNS = 2
# The paths' widths and the edges of the launch's bands on 132 SMs.
WIDTHS_A = (1, 10, 64, 256, 640, 942, 2_004, 8_448, 8_449, 16_384, 16_896,
            16_897, 32_768, 262_144)
RICCATI_WIDTH_CELLS = tuple((model, T_, B) for model, T_ in (
    ("unicycle", 30), ("unicycle", 100), ("cartpole", 50))
    for B in WIDTHS_A)
PASSES = {"riccati": ("riccati", "riccati_evaluating"),
          "riccati_folded": ("riccati_folded", "riccati_folded_lane_w")}
# Kernel D at n <= 4: (lanes a solve, threads a block); 1 lane a solve is
# the one-solve-per-thread kernel, 128 threads a block, which the shipped
# build takes above the 4-lane band.  A shared and a per-lane noise model
# (``PASSES``).
RICCATI_FOLDED_SMALL_VARIANTS = ((4, 128), (4, 64), (1, 128))
# RAT iLQR's banks (T=100, B=10), its CE generation's (T=100, B=16,384),
# RAT iLQR++'s widths (T=30, B=1 and 942), both sides of the 4-lane band's
# edge and the widest banks.
RICCATI_FOLDED_CELLS = (("unicycle", 100, 10), ("unicycle", 30, 1),
                        ("unicycle", 30, 942), ("unicycle", 100, 8_192),
                        ("unicycle", 30, 16_384), ("unicycle", 100, 16_384),
                        ("cartpole", 50, 16_384), ("unicycle", 30, 16_897),
                        ("unicycle", 100, 16_897), ("cartpole", 50, 16_897),
                        ("unicycle", 100, 32_768),
                        ("unicycle", 100, 262_144),
                        ("cartpole", 50, 262_144))
WIDTHS_D = (1, 10, 64, 256, 942, 8_448, 8_449, 16_384, 16_896, 16_897,
            32_768, 262_144)
RICCATI_FOLDED_WIDTH_CELLS = tuple((model, T_, B) for model, T_ in (
    ("unicycle", 30), ("unicycle", 100), ("cartpole", 50))
    for B in WIDTHS_D)
# The float32 fail flags of kernels C and B disagreed with the plain
# version's on a near-breakdown lane of this fixture before the
# contraction policy (csrc/smallmat.cuh): (model, horizon, width).
FLAG_CASE = ("cartpole", 20, 33_793)
# Kernel D's float32 value on one lane of this fixture (a per-lane noise
# model) differed from the plain version's by more than the drift rule
# allows at the contraction policy's kCarry: (model, horizon, width).
DRIFT_CASE = ("cartpole", 30, 16_897)
# The contraction policy's levels (-DRQ_PSD_ROUNDING; 1, kFactor, is
# smallmat.cuh's default, 2, kCarry, candidate.cu's) and the cells at which "policy" times every kernel with it off
# and on: chip_smoke.py phase 9's.
PSD_LEVELS = (0, 1, 2)
POLICY_CELLS = (("unicycle", 100, 262_144), ("quadrotor", 50, 16_384),
                ("quadrotor", 50, 262_144), ("cartpole", 50, 16_384),
                ("unicycle", 30, 1), ("unicycle", 30, 942))
SASS_OPS = ("LDG", "LDS", "LDGSTS", "LDL", "STG", "STS", "STL", "SHFL",
            "BAR", "MUFU")


def variants(kernel):
    return (RICCATI_VARIANTS if kernel in ("riccati", "riccati_folded")
            else VARIANTS)


def _shared_memory(kernel, lib, suffix):
    """Shared memory a block of the variant ``lib`` takes on the quadrotor
    (``SMEM_QUERY``)."""
    teams, lanes = ctypes.c_int(), ctypes.c_int()
    query = getattr(lib, f"ratilqr_{kernel}_smem_{suffix}")
    shape = SMEM_QUERY[kernel]
    return query(*shape, ctypes.byref(teams), ctypes.byref(lanes))


def _compile(source, tag, suffix, defines):
    """Build ``source`` (a ``.cu`` path) with ``defines`` into
    ``_build/<hash>/<tag>/``; returns (library path, ptxas rows, seconds)."""
    out_dir = _build.BUILD_DIR / _build.source_hash() / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{source.stem}_{suffix}.so"
    proc, secs = _build._run([
        _build._nvcc(), *_build.CODEGEN_FLAGS, *_build.LINK_FLAGS,
        f"-DRQ_DTYPE={_build._SUFFIXES.index(suffix)}", *defines, "-o",
        str(lib), str(source)])
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {tag} ({suffix}):\n"
                           f"{proc.stderr[-3000:]}")
    return lib, _build.ptxas_report(proc.stdout + proc.stderr), secs


def _build_variant(kernel, variant, suffix):
    lanes, teams, *buffers = variant
    shape = ["-DRQ_SHAPE_N=12", "-DRQ_SHAPE_M=4"] if kernel == "riccati" else []
    lib, rows, secs = _compile(
        _build.CSRC_DIR / f"{kernel}.cu",
        f"team_{kernel}_{'x'.join(map(str, variant))}", suffix,
        [f"-DRQ_TEAM_LANES={lanes}", f"-DRQ_TEAMS={teams}",
         *(f"-DRQ_STAGE_BUFFERS={b}" for b in buffers), *shape])
    rows = [r for r in rows if f"{kernel}_team_kernel" in r[0]]
    return _build._bind(ctypes.CDLL(str(lib)), (suffix,)), rows, secs


def _same(a, b) -> bool:
    """Every output of two launches equal bit for bit (NaN equal to NaN;
    an output one pass does not give is None in both)."""
    return all((x is None and y is None) or (
        x is not None and y is not None
        and torch.equal(x.nan_to_num(), y.nan_to_num())) for x, y in zip(a, b))


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


def _cuobjdump():
    """The toolkit's ``cuobjdump`` beside ``nvcc``, or None."""
    try:
        tool = Path(_build._nvcc()).parent / "cuobjdump"
    except RuntimeError:
        return None
    return str(tool) if tool.exists() else shutil.which("cuobjdump")


def sass_counts(lib, name: str):
    """``{function: {op: count}}`` of the SASS of every function of ``lib``
    whose (demangled) name holds ``name``, for the ops of ``SASS_OPS``
    (an op counts each of its variants, e.g. ``LDG.E.64``); None without
    ``cuobjdump``."""
    tool = _cuobjdump()
    if tool is None:
        return None
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = collections.Counter()
            continue
        m = re.search(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if m and fn is not None:
            counts[fn][m.group(1)] += 1
    names = dict(zip(counts, counts))
    cxxfilt = shutil.which("c++filt")
    if counts and cxxfilt:
        demangled = subprocess.run([cxxfilt], input="\n".join(counts),
                                   capture_output=True, text=True).stdout
        names = dict(zip(counts, demangled.splitlines()))
    return {_build.short_name(names[f]): {op: c[op] for op in SASS_OPS}
            | {"all": sum(c.values())}
            for f, c in counts.items() if name in names[f]}


def _small_names(kernel):
    """The function names of the kernel's n <= 4 design (not the team
    kernel's); kernel D's also its one-solve-per-thread kernel, which a
    baseline may run at n <= 4 (the shipped library instantiates it at no
    shipped n)."""
    return {"riccati": ("riccati_small_kernel",),
            "riccati_folded": ("riccati_folded_small_kernel",
                               "riccati_folded_kernel")}.get(
        kernel, (f"{kernel}_kernel",))


def _print_small_build(kernel, label, lib, rows, secs):
    for name in _small_names(kernel):
        for fn, regs, stores, loads, stack in rows:
            if name in fn:
                print(f"small sweep {kernel} {label} "
                      f"{_build.short_name(fn)}: {regs} registers, {stack} B "
                      f"stack frame, {stores} B spill stores, {loads} B "
                      f"spill loads ({secs:.1f} s nvcc)", flush=True)
        counts = sass_counts(lib, name)
        if counts is None:
            print(f"small sweep {kernel} {label}: no cuobjdump, no SASS "
                  "counts", flush=True)
            return
        for fn, c in counts.items():
            print(f"small sweep {kernel} {label} SASS {fn}: "
                  + ", ".join(f"{op} {n}" for op, n in c.items()),
                  flush=True)


def _diff(out, ref) -> str:
    """Kernel B's or C's largest value difference from the shipped build's
    on the lanes that did not fail, and whether the fail flags agree."""
    failed = [f for f in ("m_fail", "h_fail") if hasattr(out, f)]
    bad = out.m_fail | ref.m_fail
    for f in failed[1:]:
        bad = bad | getattr(out, f) | getattr(ref, f)
    ok = ~bad
    err = float((out.value[ok].double() - ref.value[ok].double()).abs()
                .max()) if bool(ok.any()) else 0.0
    same = all(torch.equal(getattr(out, f), getattr(ref, f)) for f in failed)
    return (f"max |value - shipped| {err:.3e} on lanes that did not fail, "
            f"fail flags equal: {same}")


def _small_defines(kernel, variant):
    """``-D`` flags of a few-lane variant: (lanes, threads) and, for
    kernel C, whether it stages its steps where K > 1, for kernel A how a
    team gets its steps' blocks (``RICCATI_SMALL_VARIANTS``)."""
    K, threads, *form = variant
    macro = {"candidate": "RQ_SMALL_STAGE", "riccati": "RQ_STEP_FORM"}
    return [f"-DRQ_SMALL_LANES={K}", f"-DRQ_SMALL_THREADS={threads}",
            f"-DRQ_WIDE_THREADS={threads}",
            *(f"-D{macro[kernel]}={v}" for v in form)]


MODEL_IDS = {"unicycle": tile_model.UNICYCLE, "lqr": tile_model.LQR,
             "cartpole": tile_model.CARTPOLE,
             "quadrotor": tile_model.QUADROTOR}
MODEL_DIMS = {"unicycle": (3, 2), "lqr": (2, 2), "cartpole": (4, 1),
              "quadrotor": (12, 4)}


def _riccati_query(model, dtype, B, case_name):
    return riccati_cuda.block_shared_memory(
        *MODEL_DIMS[model], dtype, B, case_name == "riccati")


def _folded_query(model, dtype, B, case_name):
    return riccati_cuda.folded_block_shared_memory(
        MODEL_DIMS[model][0], dtype, case_name == "riccati_folded", B)


SMALL = {   # kernel: (variants, variant cells, width cells, launch, query)
    "candidate": (SMALL_VARIANTS, SMALL_CELLS, WIDTH_CELLS,
                  candidate_cuda.launch_candidate,
                  lambda model, dtype, B, _:
                      candidate_cuda.block_shared_memory(
                          MODEL_IDS[model], dtype, B)),
    "step": (STEP_VARIANTS, STEP_CELLS, STEP_WIDTH_CELLS,
             step_cuda.launch_step,
             lambda model, dtype, B, _: step_cuda.block_shared_memory(
                 MODEL_IDS[model], dtype, B)),
    "riccati": (RICCATI_SMALL_VARIANTS, RICCATI_CELLS, RICCATI_WIDTH_CELLS,
                LAUNCHES["riccati"], _riccati_query),
    "riccati_folded": (RICCATI_FOLDED_SMALL_VARIANTS, RICCATI_FOLDED_CELLS,
                       RICCATI_FOLDED_WIDTH_CELLS,
                       LAUNCHES["riccati_folded"], _folded_query)}


def _bound_entry(kernel, lib, suffix="f32"):
    return getattr(_build._bind(ctypes.CDLL(str(lib)), (suffix,)),
                   f"ratilqr_{kernel}_{suffix}")


def small_sweep(kernel, device, baseline=None) -> None:
    """Kernel C, B or A at n <= 4: its variants at its variant cells, then
    the shipped launch (and ``baseline``'s source) at its width cells, then
    the flag check with the contraction policy's levels; kernel A in both
    slim passes (``PASSES``)."""
    f32 = torch.float32
    variants, cells, width_cells, launch, query = SMALL[kernel]
    source = _build.CSRC_DIR / f"{kernel}.cu"
    units = {v: (source, f"small_{kernel}_{'x'.join(map(str, v))}",
                 _small_defines(kernel, v)) for v in variants}
    units.update(_flag_units(kernel, baseline))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        built = dict(zip(units, pool.map(
            lambda u: _compile(u[0], u[1], "f32", u[2]), units.values())))
    print(f"small sweep {kernel}: built {len(units)} units in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    shipped_lib = _build.build()
    _print_small_build(kernel, "shipped", shipped_lib, _build.ptxas_report(
        (shipped_lib.parent / "build.log").read_text()), 0.0)
    entries = {}
    for v, (lib, rows, secs) in built.items():
        _print_small_build(kernel, v, lib, rows, secs)
        entries[v] = _bound_entry(kernel, lib)
    passes = PASSES.get(kernel, (kernel,))
    for (model, horizon, B), case_name in ((c, p) for c in cells
                                           for p in passes):
        case = kernel_check.timing_cases(model, horizon, B, f32,
                                         device)[case_name]()
        args = case[1]()
        shipped = launch(*args)
        times = {}
        timed = (*variants, *_flag_units(kernel))   # with the policy levels
        for v in timed + timed[::-1]:
            out = launch(*args, entries[v])
            times.setdefault(v, []).append(kernel_check.time_ms(
                lambda: launch(*args, entries[v])))
            if len(times[v]) == 2:
                print(f"small sweep {case_name} {model} T={horizon} B={B} "
                      f"f32 {v}: launch alone {times[v][0]:.4f} / "
                      f"{times[v][1]:.4f} ms (two passes); shipped outputs "
                      f"and flags bit for bit: {_same(out, shipped)}; "
                      f"{_diff(out, shipped)}", flush=True)
        del case, args, shipped
        torch.cuda.empty_cache()
    for (model, horizon, B), case_name in ((c, p) for c in width_cells
                                           for p in passes):
        nbytes, solves, lanes = query(model, f32, B, case_name)
        case = kernel_check.timing_cases(model, horizon, B, f32,
                                         device)[case_name]()
        args = case[1]()
        shipped = launch(*args)
        order = (["baseline", "shipped", "shipped", "baseline"] * TURNS
                 if baseline is not None else ["shipped", "shipped"] * TURNS)
        times = {}
        for name in order:
            entry = entries.get(name)
            times.setdefault(name, []).append(kernel_check.time_ms(
                lambda: launch(*args, entry)))
        line = (f"width {case_name} {model} T={horizon} B={B} f32: shipped "
                f"(K={lanes}, {solves} solves a block, {nbytes} B shared) "
                "launch alone "
                + " / ".join(f"{t:.4f}" for t in times["shipped"])
                + f" ms (median {statistics.median(times['shipped']):.4f})")
        if baseline is not None:
            out = launch(*args, entries["baseline"])
            line += (", baseline " + " / ".join(
                f"{t:.4f}" for t in times["baseline"]) + " ms (median "
                f"{statistics.median(times['baseline']):.4f}; turns: "
                f"baseline, shipped, shipped, baseline, {TURNS} times); "
                "baseline " + _diff(out, shipped))
        print(line, flush=True)
        del case, args, shipped
        torch.cuda.empty_cache()
    builds = {name: entries[name] for name in _flag_units(kernel, baseline)}
    flag_check(kernel, device, builds)
    if kernel == "riccati_folded":
        drift_check(device, builds)


def _flag_units(kernel, baseline=None):
    """``{name: (source, tag, defines)}`` of the builds the flag check
    holds beside the shipped one: without fused multiply-adds, at each
    level of the contraction policy, and ``baseline``'s source."""
    source = _build.CSRC_DIR / f"{kernel}.cu"
    units = {"no_fma": (source, f"small_{kernel}_no_fma", ["-fmad=false"])}
    for level in PSD_LEVELS:
        units[f"policy{level}"] = (source, f"small_{kernel}_policy{level}",
                                   [f"-DRQ_PSD_ROUNDING={level}"])
    if baseline is not None:
        units["baseline"] = (Path(baseline).resolve() / f"{kernel}.cu",
                             f"small_{kernel}_baseline", [])
    return units


def flags_sweep(device, baseline=None) -> None:
    """The flag check of kernels C, B, A and D alone (``flags``)."""
    units = {(kernel, name): unit for kernel in SMALL
             for name, unit in _flag_units(kernel, baseline).items()}
    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        built = dict(zip(units, pool.map(
            lambda u: _compile(u[0], u[1], "f32", u[2]), units.values())))
    for kernel in SMALL:
        builds = {name: _bound_entry(kernel, built[k, name][0])
                  for k, name in built if k == kernel}
        flag_check(kernel, device, builds)
        if kernel == "riccati_folded":
            drift_check(device, builds)


FLAG_INPUTS = {   # kernel: (inputs, plain version, layout, launch)
    "candidate": (kernel_check.candidate_inputs,
                  candidate_cuda.candidate_bank_plain,
                  candidate_cuda.candidate_layout,
                  candidate_cuda.launch_candidate),
    "step": (kernel_check.step_inputs,
             step_cuda.step_optimize_bank_plain, step_cuda.step_layout,
             step_cuda.launch_step),
    "riccati": (None, lambda ap, theta, mu: riccati_cuda.riccati_bank_plain(
        ap, theta, mu, slim=True), riccati_cuda.riccati_layout,
        LAUNCHES["riccati"]),
    "riccati_folded": (kernel_check.folded_inputs,
                       riccati_cuda.riccati_bank_folded_plain,
                       riccati_cuda.folded_layout,
                       riccati_cuda.launch_folded)}


def _flag_args(kernel, device):
    """At ``FLAG_CASE``: (the float32 arguments of the kernel's plain
    version, their float64 twins, θ); kernel A's slim optimizing pass,
    kernel D's shared noise model."""
    model, horizon, B = FLAG_CASE
    f32 = torch.float32
    if kernel == "riccati_folded":
        fa, theta = kernel_check.folded_inputs(model, horizon, B, f32, device)
        return ((fa, theta), (type(fa)(*map(kernel_check._f64, fa)),
                              kernel_check._f64(theta)), theta)
    if kernel == "riccati":
        ap, _, _, theta, mu = kernel_check._riccati_fixture(
            model, horizon, B, f32, device, True)
        args = (ap, theta, mu)
        return args, (Approximation(*map(kernel_check._f64, ap)),
                      kernel_check._f64(theta), kernel_check._f64(mu)), theta
    args = FLAG_INPUTS[kernel][0](model, horizon, B, f32, device)
    prob64, noise64 = kernel_check._problem64(model, horizon, device)
    theta = args[5] if kernel == "candidate" else args[3]
    return args, (prob64, *map(kernel_check._f64, args[1:-1]),
                  noise64), theta


def flag_check(kernel, device, builds) -> None:
    """At ``FLAG_CASE`` in float32: the lanes whose fail flags (m_fail,
    and h_fail for kernels B and A) differ from the float64 plain
    version's, for the shipped build, each of ``builds`` (name: entry
    point) and the plain version."""
    model, horizon, B = FLAG_CASE
    _, plain, layout_of, launch = FLAG_INPUTS[kernel]
    args, args64, theta = _flag_args(kernel, device)
    ref = plain(*args64)
    layout = layout_of(*args)
    outs = {"shipped": launch(*layout),
            **{name: launch(*layout, entry) for name, entry in builds.items()},
            "plain": plain(*args)}
    for name, got in outs.items():
        for flag in ("m_fail", "h_fail"):
            if not hasattr(got, flag):
                continue
            g, r = getattr(got, flag), getattr(ref, flag)
            lanes = torch.nonzero(g != r).flatten().tolist()[:8]
            margins = (kernel_check.folded_margins(*args64, lanes)
                       if kernel == "riccati_folded" and lanes
                       else [None] * len(lanes))
            print(f"flag check {kernel} {model} T={horizon} B={B} f32, "
                  f"{name}: {int((g != r).sum())} lanes' {flag} differ from "
                  "float64's" + "".join(
                      f", lane {b} (θ {float(theta[b]):g}, {bool(g[b])}"
                      + ("" if m is None else
                         f"; float64 M's smallest eigenvalue {m:.3e} of "
                         "W⁻¹'s scale") + ")"
                      for b, m in zip(lanes, margins)), flush=True)
    kernel_check.clear_caches()


def drift_check(device, builds) -> None:
    """Kernel D at ``DRIFT_CASE`` in float32, with a shared and a per-lane
    noise model: for the shipped build, each of ``builds`` (name: entry
    point) and the plain version, the largest error of the value against
    the float64 plain version on the lanes that did not fail, its three
    worst lanes (θ, error, float64 value), and the largest ratio of
    |kernel − plain| to what ``kernel_check``'s drift rule allows."""
    model, horizon, B = DRIFT_CASE
    for shared_w in (True, False):
        fa, theta = kernel_check.folded_inputs(model, horizon, B,
                                               torch.float32, device,
                                               shared_w)
        ref = riccati_cuda.riccati_bank_folded_plain(
            type(fa)(*map(kernel_check._f64, fa)), kernel_check._f64(theta))
        plain = riccati_cuda.riccati_bank_folded_plain(fa, theta)
        layout = riccati_cuda.folded_layout(fa, theta)
        outs = {"shipped": riccati_cuda.launch_folded(*layout),
                **{name: riccati_cuda.launch_folded(*layout, entry)
                   for name, entry in builds.items()}, "plain": plain}
        ok = ~(plain.m_fail | ref.m_fail)
        fa64 = type(fa)(*map(kernel_check._f64, fa))
        for name, got in outs.items():
            err = torch.where(ok, (got.value.double() - ref.value).abs(),
                              torch.zeros_like(ref.value))
            worst = err.argsort(descending=True)[:3].tolist()
            margins = kernel_check.folded_margins(
                fa64, kernel_check._f64(theta), worst)
            try:
                ratio = "{:.3f}".format(kernel_check._compare(
                    got, plain, ref, theta, [("value", "value")],
                    torch.float32).ratio)
            except AssertionError as e:
                ratio = f"outside it ({e})"
            print(f"drift check riccati_folded {model} T={horizon} B={B} "
                  f"f32 {'shared' if shared_w else 'per-lane'} W, {name}: "
                  f"max |value - float64| {float(err.max()):.3e}; worst "
                  "lanes " + ", ".join(
                      f"{b} (θ {float(theta[b]):g}, {float(err[b]):.3e} of "
                      f"{float(ref.value[b]):.6e}, float64 M's smallest "
                      f"eigenvalue {m:.3e} of W⁻¹'s scale)"
                      for b, m in zip(worst, margins))
                  + f"; against the plain version, drift rule: {ratio}",
                  flush=True)
        del fa, fa64, theta, ref, plain, layout, outs
    kernel_check.clear_caches()


def policy_sweep(device) -> None:
    """Every kernel's launch alone with the contraction policy off
    (``-DRQ_PSD_ROUNDING=0``) and as shipped, at ``POLICY_CELLS`` in
    float32, in turns (off, shipped, shipped, off), with the largest
    difference between the two."""
    kernels = ("riccati", "step", "candidate", "riccati_folded")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        built = dict(zip(kernels, pool.map(lambda k: _compile(
            _build.CSRC_DIR / f"{k}.cu", f"policy0_{k}", "f32",
            ["-DRQ_PSD_ROUNDING=0"]), kernels)))
    print(f"policy sweep: built {len(kernels)} units in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    off = {k: _bound_entry(k, lib) for k, (lib, _, _) in built.items()}
    for model, horizon, B in POLICY_CELLS:
        cases = kernel_check.timing_cases(model, horizon, B, torch.float32,
                                          device)
        for kernel in kernels:
            case = cases[kernel]()
            args = case[1]()
            launch = LAUNCHES[kernel]
            times = {}
            for name in ("off", "shipped", "shipped", "off"):
                entry = off[kernel] if name == "off" else None
                times.setdefault(name, []).append(kernel_check.time_ms(
                    lambda: launch(*args, entry)))
            a, b = launch(*args, off[kernel]), launch(*args)
            print(f"policy {kernel} {model} T={horizon} B={B} f32: launch "
                  "alone, policy off " + " / ".join(
                      f"{t:.4f}" for t in times["off"]) + " ms, shipped "
                  + " / ".join(f"{t:.4f}" for t in times["shipped"])
                  + " ms (turns: off, shipped, shipped, off); outputs bit "
                  f"for bit: {_same(a, b)}", flush=True)
            del case, args, a, b
            torch.cuda.empty_cache()


def main(argv=()) -> int:
    kernel = argv[0] if argv else "candidate"
    rest = list(argv[1:])
    baseline = None
    if ((kernel in SMALL or kernel == "flags") and len(rest) == 2
            and rest[0] == "--baseline"):
        baseline, rest = rest[1], []
    if (kernel not in LAUNCHES and kernel not in ("policy", "flags")
            or rest):
        print("usage: python -m ratilqr_tpu_torch.team_sweep "
              "[candidate|step|riccati|riccati_folded [--baseline DIR]|"
              "policy|flags [--baseline DIR]]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("team_sweep: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(f"team_sweep {kernel}: {torch.cuda.get_device_name(0)}",
          flush=True)
    if kernel == "policy":
        policy_sweep(device)
        return 0
    if kernel == "flags":
        flags_sweep(device, baseline)
        return 0
    if kernel in SMALL:
        small_sweep(kernel, device, baseline)
    sweep(kernel, device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
