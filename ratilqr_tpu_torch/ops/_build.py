"""Build the CUDA kernels from ``ratilqr_tpu_torch/csrc`` and load them.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` twice, once per
working type (``-DRQ_DTYPE=0`` float32, ``1`` float64), each translation
unit in its own process, all started together, and links the objects into
one shared library with a plain C interface (no PyTorch headers), written
to ``ratilqr_tpu_torch/_build/<content hash>/``; ``ctypes`` loads it.  Each
kernel has one C entry point per type (``ratilqr_step_f32``, ...).  The
build runs once per process, at the first launch on a CUDA tensor.  A
missing ``nvcc`` or a failed build raises; nothing falls back.

Kernels A and D (``riccati.cu``, ``riccati_folded.cu``) hold the shapes of
the shipped models in that library.  Any other shape is built at its first
use: :func:`shape_library` compiles the one source for that shape and type
alone (``-DRQ_SHAPE_N=n [-DRQ_SHAPE_M=m]``) into
``_build/<content hash>/shape_<kernel>_<shape>/`` and loads it with a
``ctypes.CDLL`` of its own, once per process.

Each kernel wrapper adds one to ``launch_counts[<kernel>]`` for every
launch it makes, so a run can show which kernels its path went through.
"""
from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libratilqr_kernels.so"
CODEGEN_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
COMPILE_FLAGS = CODEGEN_FLAGS + ("-c",)
LINK_FLAGS = ("-shared",)
# The CUDA toolkit's default install prefix, used when nvcc is not on PATH.
_DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
# Entry-point suffix of each working type, indexed by its RQ_DTYPE code
# (csrc/dtype.cuh).
_SUFFIXES = ("f32", "f64")
MAX_PARAMS = 8   # rq::kMaxParams (csrc/tile_model.cuh)

launch_counts: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def _source_files():
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    """Hash of every kernel source and the compiler flags."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for p in _source_files():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if _DEFAULT_NVCC.exists():
        return str(_DEFAULT_NVCC)
    raise RuntimeError("nvcc not found: the CUDA kernels of ratilqr_tpu_torch "
                       "are built from csrc/ at first use and need the CUDA "
                       "toolkit")


def _run(cmd):
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          cwd=str(CSRC_DIR))
    return proc, time.perf_counter() - t0


def build() -> Path:
    """Compile the kernels unless this source hash is already built;
    returns the library's path.  Every ``.cu`` compiles once per working
    type, each in its own ``nvcc`` process, all started together;
    ``build.log`` beside the library keeps each one's wall time
    (``nvcc <file> <type>: <s> s``) and the compiler's register and spill
    report."""
    out_dir = BUILD_DIR / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    units = [(p, code, suffix) for p in _source_files() if p.suffix == ".cu"
             for code, suffix in enumerate(_SUFFIXES)]
    objects = [out_dir / f"{p.stem}.{suffix}.{tag}.o"
               for p, _, suffix in units]
    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        runs = list(pool.map(_run, [
            [nvcc, *COMPILE_FLAGS, f"-DRQ_DTYPE={code}", "-o", str(o), str(p)]
            for (p, code, _), o in zip(units, objects)]))
    log = []
    for (src, _, suffix), (proc, secs) in zip(units, runs):
        log.append(f"nvcc {src.name} {suffix}: {secs:.1f} s, "
                   f"exit {proc.returncode}")
        log.append(proc.stdout + proc.stderr)
    (out_dir / "build.log").write_text("\n".join(log))
    failed = [(src, suffix, proc)
              for (src, _, suffix), (proc, _) in zip(units, runs)
              if proc.returncode != 0]
    if failed:
        src, suffix, proc = failed[0]
        raise RuntimeError(f"nvcc failed on {src.name} ({suffix}) with exit "
                           f"code {proc.returncode}:\n{proc.stderr[-4000:]}")
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    proc, _ = _run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objects)])
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed with exit code "
                           f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    for o in objects:
        o.unlink()
    os.replace(tmp, lib)
    return lib


def shape_tag(shape) -> str:
    """``"6x3"`` for kernel A's (n, m), ``"6"`` for kernel D's (n,)."""
    return "x".join(str(int(d)) for d in shape)


def build_shape(kernel: str, shape, suffix: str) -> Path:
    """Compile ``csrc/<kernel>.cu`` for one shape and working type unless
    built; returns the library's path.  ``shape`` is ``(n, m)`` for
    ``riccati``, ``(n,)`` for ``riccati_folded``.  ``build.log`` in the
    shape's directory gets the nvcc time and the ptxas report."""
    code = _SUFFIXES.index(suffix)
    tag = shape_tag(shape)
    out_dir = BUILD_DIR / source_hash() / f"shape_{kernel}_{tag}"
    lib = out_dir / f"lib{kernel}_{tag}_{suffix}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    defines = [f"-DRQ_SHAPE_{d}={int(v)}" for d, v in zip("NM", shape)]
    tmp = out_dir / f"{lib.name}.{os.getpid()}.tmp"
    proc, secs = _run([_nvcc(), *CODEGEN_FLAGS, *LINK_FLAGS,
                       f"-DRQ_DTYPE={code}", *defines, "-o", str(tmp),
                       str(CSRC_DIR / f"{kernel}.cu")])
    with open(out_dir / "build.log", "a") as log:
        log.write(f"nvcc {kernel}.cu {suffix} shape {tag}: {secs:.1f} s, "
                  f"exit {proc.returncode}\n{proc.stdout}{proc.stderr}\n")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {kernel}.cu ({suffix}, shape "
                           f"{tag}) with exit code {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def ptxas_report(log: str):
    """``(kernel, registers, spill stores, spill loads, stack frame)`` per
    entry function, from the ``-Xptxas -v`` lines of a ``build.log``
    (bytes; names demangled where ``c++filt`` is found)."""
    rows, name, frame = [], None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append((name, int(m.group(1)), frame[1], frame[2],
                         frame[0]))
            name, frame = None, (0, 0, 0)
    cxxfilt = shutil.which("c++filt")
    if rows and cxxfilt:
        names = subprocess.run([cxxfilt], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True).stdout
        rows = [(n, *r[1:]) for n, r in zip(names.splitlines(), rows)]
    return rows


def report(lib: Path):
    """Lines on a build (the shipped library or a shape's): each
    translation unit's nvcc time, then each kernel's registers, spills and
    stack frame."""
    log = (lib.parent / "build.log").read_text()
    lines = [line for line in log.splitlines() if line.startswith("nvcc ")]
    return lines + [f"ptxas {name}: {regs} registers, {stores} B spill "
                    f"stores, {loads} B spill loads, {stack} B stack frame"
                    for name, regs, stores, loads, stack in ptxas_report(log)]


_P = ctypes.c_void_p
_I = ctypes.c_int
_PARAMS = ctypes.POINTER(ctypes.c_double)   # host array of MAX_PARAMS
_SIGNATURES = {   # of each type's entry point, <name>_f32 and <name>_f64
    "ratilqr_riccati": [_I] * 8 + [_P] * 18 + [_P] * 11 + [_P],
    "ratilqr_riccati_smem": [_I] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2,
    "ratilqr_step": [_I] * 3 + [_PARAMS] + [_P] * 7 + [_P] * 6 + [_P],
    "ratilqr_step_smem": [_I] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2,
    "ratilqr_candidate": [_I] * 3 + [_PARAMS] + [_P] * 8 + [_P] * 3 + [_P],
    "ratilqr_candidate_smem": [_I] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2,
    "ratilqr_riccati_folded": [_I] * 4 + [_P] * 11 + [_P] * 2 + [_P],
    "ratilqr_riccati_folded_smem": [_I] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2,
}


def params_array(params):
    """A device model's parameters as the kernels' host array of
    ``MAX_PARAMS`` doubles, zero-padded; raises for more than that."""
    if len(params) > MAX_PARAMS:
        raise ValueError(f"a device model takes at most {MAX_PARAMS} "
                         f"parameters, got {len(params)}")
    padded = list(map(float, params)) + [0.0] * (MAX_PARAMS - len(params))
    return (ctypes.c_double * MAX_PARAMS)(*padded)


def _bind(lib: ctypes.CDLL, suffixes) -> ctypes.CDLL:
    for name, argtypes in _SIGNATURES.items():
        for suffix in suffixes:
            fn = getattr(lib, f"{name}_{suffix}", None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    return _bind(ctypes.CDLL(str(build())), _SUFFIXES)


@functools.lru_cache(maxsize=None)
def shape_library(kernel: str, shape: tuple, suffix: str) -> ctypes.CDLL:
    """Build (if needed) and load kernel ``kernel`` for one shape and
    working type, once per process (:func:`build_shape`)."""
    return _bind(ctypes.CDLL(str(build_shape(kernel, shape, suffix))),
                 (suffix,))


def entry(kernel: str, dtype, shape: tuple = (), name: str = ""):
    """The C entry point ``ratilqr_<kernel>_<f32|f64>`` (or, given
    ``name``, ``ratilqr_<name>_<f32|f64>`` of the same source): from the
    shipped library, or, given ``shape``, from the library built for that
    shape alone."""
    suffix = dtype_suffix(dtype)
    lib = shape_library(kernel, tuple(shape), suffix) if shape else library()
    return getattr(lib, f"ratilqr_{name or kernel}_{suffix}")


def short_name(fn: str) -> str:
    """A kernel's name and template arguments from an entry function's
    (demangled) name in a ptxas report."""
    m = re.search(r"(\w+<[^()]*>)\(", fn)
    return m.group(1) if m else fn


def check(rc: int, kernel: str, detail: str = "") -> None:
    """Raise on a refused or failed launch (``cudaGetLastError`` code);
    ``detail`` is added to the message of a failed one."""
    if rc == -1:
        raise NotImplementedError(f"{kernel}: no kernel instantiated for "
                                  "this shape or model")
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with "
                           f"cudaError {rc}" + (f" ({detail})" if detail
                                                else ""))


def block_shared_memory(kernel: str, model_id: int, dtype, *args):
    """``(bytes, teams, lanes)`` of kernel ``kernel`` (``"step"`` or
    ``"candidate"``) on a device model: the dynamic shared memory a block
    takes, its teams (solves) per block and lanes per team.  ``args`` go
    before the two outputs: the bank's width B, from which the launch
    picks the lanes a solve at n ≤ ``kUnrollMax`` (4 or 1; 16 on the
    quadrotor).  Builds the library if needed."""
    teams, lanes = ctypes.c_int(), ctypes.c_int()
    nbytes = entry(f"{kernel}_smem", dtype)(model_id, *args,
                                            ctypes.byref(teams),
                                            ctypes.byref(lanes))
    check(nbytes if nbytes < 0 else 0, kernel)
    return nbytes, teams.value, lanes.value


def first_widths(kernel: str, model_id: int, dtype, B_max: int = 1 << 30
                 ) -> Dict[int, int]:
    """``{lanes a solve: the narrowest width B ≤ B_max whose launch takes
    it}`` of kernel ``kernel`` (``"step"`` or ``"candidate"``) on a device
    model on the current card, read from :func:`block_shared_memory` (the
    launch takes fewer lanes a solve as the bank widens)."""
    def lanes(B):
        return block_shared_memory(kernel, model_id, dtype, B)[2]

    widths, B = {}, 1
    while B <= B_max:
        K = lanes(B)
        widths[K] = B
        lo, hi = B, B_max + 1   # lanes(lo) == K; hi: the first to take fewer
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (lo, mid) if lanes(mid) < K else (mid, hi)
        B = hi
    return widths


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def dtype_suffix(dtype) -> str:
    """``"f32"`` or ``"f64"``; raises for a type the kernels do not take."""
    import torch
    suffix = {torch.float32: "f32", torch.float64: "f64"}.get(dtype)
    if suffix is None:
        raise NotImplementedError(f"CUDA kernels take float32 or float64, "
                                  f"not {dtype}")
    return suffix


def lane_minor(x):
    """``(B, ...) -> (..., B)`` contiguous, so a warp's loads coalesce."""
    return x.movedim(0, -1).contiguous()


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream

