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

Kernel C at n ≤ 4 (``candidate``, float32): each ``SMALL_VARIANTS`` entry
(lanes a solve K of 1 or 4, threads a block, staging by cp.async on or
off where K > 1; the fold-ahead pipeline is on wherever K > 1) builds
with ``-DRQ_SMALL_LANES``, ``-DRQ_SMALL_THREADS`` (and
``-DRQ_WIDE_THREADS``, the threads at K = 1) and ``-DRQ_SMALL_STAGE``;
the sweep prints its ptxas report and, where the toolkit has
``cuobjdump``, the count of each kind of load, store, shuffle and barrier
in its SASS; it times each at ``SMALL_CELLS`` (the unicycle T=30 at B=1
and 942, the unicycle T=100 and the cartpole T=50 at B=16,384 and
262,144) in two passes and checks each
against the shipped build (whose launch picks K) bit for bit.  Then it
times the shipped launch at ``WIDTH_CELLS`` (B = 1, 256, 640, 942,
16,384, 32,768, 65,536 and 262,144 on the unicycle T=30 and T=100 and the
cartpole T=50) with
the K it picks.  ``--baseline DIR`` also builds ``DIR/candidate.cu`` (the
csrc directory of another checkout, e.g. the parent commit's) and times it
beside the shipped build at every width cell, in turns (baseline, shipped,
shipped, baseline), with its largest difference from the shipped values
and whether its fail flags are equal.  Last, at ``FLAG_CASE`` (the
cartpole fixture on which kernel C's float32 fail flag disagrees with the
plain version), it lists the lanes whose float32 fail flag differs from
float64's in the shipped build, a build without fused multiply-adds
(``-fmad=false``), the baseline and the plain version.

Run on a machine with a CUDA card, from the repository root:
``python -m ratilqr_tpu_torch.team_sweep
[candidate [--baseline DIR]|step|riccati|riccati_folded]`` (kernel C
without an argument).
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
# A: its slim optimizing pass; A and D: a shared noise model; C: a width).
SMEM_QUERY = {"riccati": (12, 4, 1, 1), "riccati_folded": (12, 1),
              "candidate": (tile_model.QUADROTOR, 16_384)}
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
# Kernel C's float32 fail flag disagrees with the plain version's on a
# near-breakdown lane of this fixture: (model, horizon, width).
FLAG_CASE = ("cartpole", 20, 33_793)
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
    shape = SMEM_QUERY.get(kernel, (tile_model.QUADROTOR,))
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


def _print_small_build(label, lib, rows, secs):
    for fn, regs, stores, loads, stack in rows:
        if "candidate_kernel" in fn:
            print(f"small sweep {label} {_build.short_name(fn)}: {regs} "
                  f"registers, {stack} B stack frame, {stores} B spill "
                  f"stores, {loads} B spill loads ({secs:.1f} s nvcc)",
                  flush=True)
    counts = sass_counts(lib, "candidate_kernel")
    if counts is None:
        print(f"small sweep {label}: no cuobjdump, no SASS counts",
              flush=True)
        return
    for fn, c in counts.items():
        print(f"small sweep {label} SASS {fn}: "
              + ", ".join(f"{op} {n}" for op, n in c.items()), flush=True)


def _diff(out, ref) -> str:
    ok = ~(out.m_fail | ref.m_fail)
    err = float((out.value[ok].double() - ref.value[ok].double()).abs()
                .max()) if bool(ok.any()) else 0.0
    return (f"max |value - shipped| {err:.3e} on lanes that did not fail, "
            f"fail flags equal: {torch.equal(out.m_fail, ref.m_fail)}")


def small_sweep(device, baseline=None) -> None:
    """Kernel C at n <= 4: ``SMALL_VARIANTS`` at ``SMALL_CELLS``, then the
    shipped launch (and ``baseline``'s candidate.cu) at ``WIDTH_CELLS``."""
    f32 = torch.float32
    units = {v: (_build.CSRC_DIR / "candidate.cu",
                 f"small_candidate_{'x'.join(map(str, v))}",
                 [f"-DRQ_SMALL_LANES={v[0]}", f"-DRQ_SMALL_THREADS={v[1]}",
                  f"-DRQ_WIDE_THREADS={v[1]}", f"-DRQ_SMALL_STAGE={v[2]}"])
             for v in SMALL_VARIANTS}
    units["no_fma"] = (_build.CSRC_DIR / "candidate.cu",
                       "small_candidate_no_fma", ["-fmad=false"])
    if baseline is not None:
        units["baseline"] = (Path(baseline).resolve() / "candidate.cu",
                             "small_candidate_baseline", [])
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        built = dict(zip(units, pool.map(
            lambda u: _compile(u[0], u[1], "f32", u[2]), units.values())))
    print(f"small sweep: built {len(units)} units in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    shipped_lib = _build.build()
    _print_small_build("shipped", shipped_lib, _build.ptxas_report(
        (shipped_lib.parent / "build.log").read_text()), 0.0)
    entries = {}
    for v, (lib, rows, secs) in built.items():
        _print_small_build(v, lib, rows, secs)
        entries[v] = getattr(_build._bind(ctypes.CDLL(str(lib)), ("f32",)),
                             "ratilqr_candidate_f32")
    for model, horizon, B in SMALL_CELLS:
        case = kernel_check.timing_cases(model, horizon, B, f32,
                                         device)["candidate"]()
        args = case[1]()
        shipped = candidate_cuda.launch_candidate(*args)
        times = {}
        for v in SMALL_VARIANTS + SMALL_VARIANTS[::-1]:
            out = candidate_cuda.launch_candidate(*args, entries[v])
            times.setdefault(v, []).append(kernel_check.time_ms(
                lambda: candidate_cuda.launch_candidate(*args, entries[v])))
            if len(times[v]) == 2:
                print(f"small sweep {model} T={horizon} B={B} f32 (lanes, "
                      f"threads, staged) {v}: launch alone "
                      f"{times[v][0]:.4f} / {times[v][1]:.4f} ms (two "
                      f"passes); shipped outputs and flags bit for bit: "
                      f"{_same(out, shipped)}; {_diff(out, shipped)}",
                      flush=True)
        del case, args, shipped
        torch.cuda.empty_cache()
    for model, horizon, B in WIDTH_CELLS:
        model_id = {"unicycle": tile_model.UNICYCLE,
                    "cartpole": tile_model.CARTPOLE}[model]
        nbytes, solves, lanes = candidate_cuda.block_shared_memory(
            model_id, f32, B)
        case = kernel_check.timing_cases(model, horizon, B, f32,
                                         device)["candidate"]()
        args = case[1]()
        shipped = candidate_cuda.launch_candidate(*args)
        order = (["baseline", "shipped", "shipped", "baseline"]
                 if baseline is not None else ["shipped", "shipped"])
        times = {}
        for name in order:
            entry = entries.get(name)
            times.setdefault(name, []).append(kernel_check.time_ms(
                lambda: candidate_cuda.launch_candidate(*args, entry)))
        line = (f"width {model} T={horizon} B={B} f32: shipped (K={lanes}, "
                f"{solves} solves a block, {nbytes} B shared) launch alone "
                + " / ".join(f"{t:.4f}" for t in times["shipped"]) + " ms")
        if baseline is not None:
            out = candidate_cuda.launch_candidate(*args, entries["baseline"])
            line += (", baseline " + " / ".join(
                f"{t:.4f}" for t in times["baseline"]) + " ms (turns: "
                "baseline, shipped, shipped, baseline); baseline "
                + _diff(out, shipped))
        print(line, flush=True)
        del case, args, shipped
        torch.cuda.empty_cache()
    flag_check(device, {name: entries[name] for name in ("no_fma", "baseline")
                        if name in entries})


def flag_check(device, builds) -> None:
    """At ``FLAG_CASE`` in float32: the lanes whose fail flag differs from
    the float64 plain version's, for the shipped build, each of ``builds``
    (name: entry point) and the plain version."""
    model, horizon, B = FLAG_CASE
    args = kernel_check.candidate_inputs(model, horizon, B, torch.float32,
                                         device)
    prob64, noise64 = kernel_check._problem64(model, horizon, device)
    ref = candidate_cuda.candidate_bank_plain(
        prob64, *map(kernel_check._f64, args[1:-1]), noise64).m_fail
    layout = candidate_cuda.candidate_layout(*args)
    flags = {"shipped": candidate_cuda.launch_candidate(*layout).m_fail,
             **{name: candidate_cuda.launch_candidate(*layout, entry).m_fail
                for name, entry in builds.items()},
             "plain": candidate_cuda.candidate_bank_plain(*args).m_fail}
    theta = args[5]
    for name, got in flags.items():
        lanes = torch.nonzero(got != ref).flatten().tolist()
        print(f"flag check {model} T={horizon} B={B} f32, {name}: "
              f"{len(lanes)} lanes' fail flags differ from float64's "
              + ", ".join(f"lane {b} (θ {float(theta[b]):g}, {bool(got[b])})"
                          for b in lanes[:8]), flush=True)


def main(argv=()) -> int:
    kernel = argv[0] if argv else "candidate"
    rest = list(argv[1:])
    baseline = None
    if kernel == "candidate" and len(rest) == 2 and rest[0] == "--baseline":
        baseline, rest = rest[1], []
    if kernel not in LAUNCHES or rest:
        print(f"usage: python -m ratilqr_tpu_torch.team_sweep "
              f"[candidate [--baseline DIR]|"
              f"{'|'.join(k for k in LAUNCHES if k != 'candidate')}]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("team_sweep: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(f"team_sweep {kernel}: {torch.cuda.get_device_name(0)}",
          flush=True)
    if kernel == "candidate":
        small_sweep(device, baseline)
    sweep(kernel, device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
