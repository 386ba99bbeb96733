"""Time the one-solve-per-team design of kernel C (``candidate``), B
(``step``), A (``riccati``, its slim optimizing pass) or D
(``riccati_folded``, shared noise model) in other team shapes, and kernel
A's and D's two staging forms; for kernel C also its n ≤ 4 design in other
team widths, block sizes and staging forms, and at the main path's widths.

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

Kernels C and B at n ≤ 4 (``candidate``, ``step``; float32): each
``SMALL_VARIANTS`` (C) or ``STEP_VARIANTS`` (B) entry — lanes a solve K of
1 or 4, threads a block and, for C, staging by cp.async on or off where
K > 1 — builds with ``-DRQ_SMALL_LANES``, ``-DRQ_SMALL_THREADS`` (and
``-DRQ_WIDE_THREADS``, the threads at K = 1) and ``-DRQ_SMALL_STAGE``, as
do the flag check's builds below; the sweep prints each one's ptxas
report and, where the toolkit has ``cuobjdump``, the count of each kind
of load, store, shuffle and barrier in its SASS; it times each (the
variants and the flag check's builds) at ``SMALL_CELLS`` / ``STEP_CELLS`` (the
unicycle T=30 at B=1 and 942, B's also at RAT iLQR's T=100, B=10, the
unicycle T=100 and the cartpole T=50 at B=16,384 and 262,144) in two
passes and checks each against the shipped build (whose launch picks K)
bit for bit.  Then it times the shipped launch at ``WIDTH_CELLS`` /
``STEP_WIDTH_CELLS`` (the unicycle T=30 and T=100 and the cartpole T=50,
each at B = 1, 256, 640, 942, 16,384, 32,768, 65,536 and 262,144 for C,
and 1, 10, 256, 942, 16,384, 32,768 and 262,144 for B) with the K it
picks.  ``--baseline DIR`` also builds ``DIR/<kernel>.cu`` (the csrc
directory of another checkout, e.g. the parent commit's) and times it
beside the shipped build at every width cell, in turns (baseline,
shipped, shipped, baseline), with its largest difference from the
shipped values and whether its fail flags are equal.  Last, at
``FLAG_CASE`` (the cartpole fixture on which the float32 fail flags
disagreed with the plain version before the contraction policy of
``csrc/smallmat.cuh``), it lists the lanes whose float32 fail flags
differ from float64's in the shipped build, a build without fused
multiply-adds (``-fmad=false``), a build at each level of the policy
(``-DRQ_PSD_ROUNDING`` = 0: off, 1: M and the pivots, 2: also the S
update), the baseline and the plain version.

``policy`` builds every kernel with the contraction policy off and times
each beside the shipped build at ``POLICY_CELLS`` (``chip_smoke.py``
phase 9's cells), in turns; ``flags [--baseline DIR]`` runs the flag
check of kernels C and B alone.

Run on a machine with a CUDA card, from the repository root:
``python -m ratilqr_tpu_torch.team_sweep [candidate [--baseline DIR]|
step [--baseline DIR]|riccati|riccati_folded|policy|flags [--baseline
DIR]]`` (kernel C without an argument).
"""
from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

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
# A: its slim optimizing pass; A and D: a shared noise model; B and C: a
# width).
SMEM_QUERY = {"riccati": (12, 4, 1, 1), "riccati_folded": (12, 1),
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
# The float32 fail flags of kernels C and B disagreed with the plain
# version's on a near-breakdown lane of this fixture before the
# contraction policy (csrc/smallmat.cuh): (model, horizon, width).
FLAG_CASE = ("cartpole", 20, 33_793)
# The contraction policy's levels (-DRQ_PSD_ROUNDING; 2, kCarry, is
# shipped) and the cells at which "policy" times every kernel with it off
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
    lib, rows, secs = _compile(
        _build.CSRC_DIR / f"{kernel}.cu",
        f"team_{kernel}_{'x'.join(map(str, variant))}", suffix,
        [f"-DRQ_TEAM_LANES={lanes}", f"-DRQ_TEAMS={teams}",
         *(f"-DRQ_STAGE_BUFFERS={b}" for b in buffers)])
    rows = [r for r in rows if f"{kernel}_team_kernel" in r[0]]
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


def _print_small_build(kernel, label, lib, rows, secs):
    name = f"{kernel}_kernel"   # not {kernel}_team_kernel
    for fn, regs, stores, loads, stack in rows:
        if name in fn:
            print(f"small sweep {kernel} {label} {_build.short_name(fn)}: "
                  f"{regs} registers, {stack} B stack frame, {stores} B spill"
                  f" stores, {loads} B spill loads ({secs:.1f} s nvcc)",
                  flush=True)
    counts = sass_counts(lib, name)
    if counts is None:
        print(f"small sweep {kernel} {label}: no cuobjdump, no SASS counts",
              flush=True)
        return
    for fn, c in counts.items():
        print(f"small sweep {kernel} {label} SASS {fn}: "
              + ", ".join(f"{op} {n}" for op, n in c.items()), flush=True)


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


def _small_defines(variant):
    """``-D`` flags of a few-lane variant: (lanes, threads) and, for
    kernel C, whether it stages its steps where K > 1."""
    K, threads, *staged = variant
    return [f"-DRQ_SMALL_LANES={K}", f"-DRQ_SMALL_THREADS={threads}",
            f"-DRQ_WIDE_THREADS={threads}",
            *(f"-DRQ_SMALL_STAGE={v}" for v in staged)]


SMALL = {   # kernel: (variants, variant cells, width cells, launch, query)
    "candidate": (SMALL_VARIANTS, SMALL_CELLS, WIDTH_CELLS,
                  candidate_cuda.launch_candidate,
                  candidate_cuda.block_shared_memory),
    "step": (STEP_VARIANTS, STEP_CELLS, STEP_WIDTH_CELLS,
             step_cuda.launch_step, step_cuda.block_shared_memory)}
MODEL_IDS = {"unicycle": tile_model.UNICYCLE, "lqr": tile_model.LQR,
             "cartpole": tile_model.CARTPOLE,
             "quadrotor": tile_model.QUADROTOR}


def _bound_entry(kernel, lib, suffix="f32"):
    return getattr(_build._bind(ctypes.CDLL(str(lib)), (suffix,)),
                   f"ratilqr_{kernel}_{suffix}")


def small_sweep(kernel, device, baseline=None) -> None:
    """Kernel C or B at n <= 4: its variants at its variant cells, then
    the shipped launch (and ``baseline``'s source) at its width cells, then
    the flag check with the contraction policy's levels."""
    f32 = torch.float32
    variants, cells, width_cells, launch, query = SMALL[kernel]
    source = _build.CSRC_DIR / f"{kernel}.cu"
    units = {v: (source, f"small_{kernel}_{'x'.join(map(str, v))}",
                 _small_defines(v)) for v in variants}
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
    for model, horizon, B in cells:
        case = kernel_check.timing_cases(model, horizon, B, f32,
                                         device)[kernel]()
        args = case[1]()
        shipped = launch(*args)
        times = {}
        timed = (*variants, *_flag_units(kernel))   # with the policy levels
        for v in timed + timed[::-1]:
            out = launch(*args, entries[v])
            times.setdefault(v, []).append(kernel_check.time_ms(
                lambda: launch(*args, entries[v])))
            if len(times[v]) == 2:
                print(f"small sweep {kernel} {model} T={horizon} B={B} f32 "
                      f"{v}: launch alone {times[v][0]:.4f} / "
                      f"{times[v][1]:.4f} ms (two passes); shipped outputs "
                      f"and flags bit for bit: {_same(out, shipped)}; "
                      f"{_diff(out, shipped)}", flush=True)
        del case, args, shipped
        torch.cuda.empty_cache()
    for model, horizon, B in width_cells:
        nbytes, solves, lanes = query(MODEL_IDS[model], f32, B)
        case = kernel_check.timing_cases(model, horizon, B, f32,
                                         device)[kernel]()
        args = case[1]()
        shipped = launch(*args)
        order = (["baseline", "shipped", "shipped", "baseline"]
                 if baseline is not None else ["shipped", "shipped"])
        times = {}
        for name in order:
            entry = entries.get(name)
            times.setdefault(name, []).append(kernel_check.time_ms(
                lambda: launch(*args, entry)))
        line = (f"width {kernel} {model} T={horizon} B={B} f32: shipped "
                f"(K={lanes}, {solves} solves a block, {nbytes} B shared) "
                "launch alone "
                + " / ".join(f"{t:.4f}" for t in times["shipped"]) + " ms")
        if baseline is not None:
            out = launch(*args, entries["baseline"])
            line += (", baseline " + " / ".join(
                f"{t:.4f}" for t in times["baseline"]) + " ms (turns: "
                "baseline, shipped, shipped, baseline); baseline "
                + _diff(out, shipped))
        print(line, flush=True)
        del case, args, shipped
        torch.cuda.empty_cache()
    flag_check(kernel, device, {name: entries[name]
                                for name in _flag_units(kernel, baseline)})


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
    """The flag check of kernels C and B alone (``flags``)."""
    units = {(kernel, name): unit for kernel in SMALL
             for name, unit in _flag_units(kernel, baseline).items()}
    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        built = dict(zip(units, pool.map(
            lambda u: _compile(u[0], u[1], "f32", u[2]), units.values())))
    for kernel in SMALL:
        flag_check(kernel, device, {
            name: _bound_entry(kernel, built[k, name][0])
            for k, name in built if k == kernel})


FLAG_INPUTS = {   # kernel: (inputs, plain version, layout, launch)
    "candidate": (kernel_check.candidate_inputs,
                  candidate_cuda.candidate_bank_plain,
                  candidate_cuda.candidate_layout,
                  candidate_cuda.launch_candidate),
    "step": (kernel_check.step_inputs,
             step_cuda.step_optimize_bank_plain, step_cuda.step_layout,
             step_cuda.launch_step)}


def flag_check(kernel, device, builds) -> None:
    """At ``FLAG_CASE`` in float32: the lanes whose fail flags (m_fail,
    and h_fail for kernel B) differ from the float64 plain version's, for
    the shipped build, each of ``builds`` (name: entry point) and the
    plain version."""
    model, horizon, B = FLAG_CASE
    inputs, plain, layout_of, launch = FLAG_INPUTS[kernel]
    args = inputs(model, horizon, B, torch.float32, device)
    prob64, noise64 = kernel_check._problem64(model, horizon, device)
    ref = plain(prob64, *map(kernel_check._f64, args[1:-1]), noise64)
    layout = layout_of(*args)
    outs = {"shipped": launch(*layout),
            **{name: launch(*layout, entry) for name, entry in builds.items()},
            "plain": plain(*args)}
    theta = args[5] if kernel == "candidate" else args[3]
    for name, got in outs.items():
        for flag in ("m_fail", "h_fail"):
            if not hasattr(got, flag):
                continue
            g, r = getattr(got, flag), getattr(ref, flag)
            lanes = torch.nonzero(g != r).flatten().tolist()
            print(f"flag check {kernel} {model} T={horizon} B={B} f32, "
                  f"{name}: {len(lanes)} lanes' {flag} differ from float64's"
                  + "".join(f", lane {b} (θ {float(theta[b]):g}, "
                            f"{bool(g[b])})" for b in lanes[:8]), flush=True)


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
              "[candidate [--baseline DIR]|step [--baseline DIR]|riccati|"
              "riccati_folded|policy|flags [--baseline DIR]]",
              file=sys.stderr)
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
