"""Build the CUDA kernels from ``ratilqr_tpu_torch/csrc`` and load them.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds),
written to ``ratilqr_tpu_torch/_build/<content hash>/``; ``ctypes`` loads
it.  The build runs once per process, at the first launch on a CUDA
tensor.  A missing ``nvcc`` or a failed build raises; nothing falls back.

Each kernel wrapper adds one to ``launch_counts[<kernel>]`` for every
launch it makes, so a run can show which kernels its path went through.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libratilqr_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The CUDA toolkit's default install prefix, used when nvcc is not on PATH.
_DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")

launch_counts: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def _source_files():
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    """Hash of every kernel source and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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


def build() -> Path:
    """Compile the kernels unless this source hash is already built;
    returns the library's path.  The compiler's register and spill report
    is kept beside it in ``build.log``."""
    out_dir = BUILD_DIR / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    sources = [str(p) for p in _source_files() if p.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *sources]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          cwd=str(CSRC_DIR))
    (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    "ratilqr_riccati": [_I] * 9 + [_P] * 18 + [_P] * 11 + [_P],
    "ratilqr_step": [_I] * 4 + [_D] * 4 + [_P] * 7 + [_P] * 6 + [_P],
    "ratilqr_candidate": [_I] * 4 + [_D] * 4 + [_P] * 8 + [_P] * 3 + [_P],
}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, kernel: str) -> None:
    """Raise on a refused or failed launch (``cudaGetLastError`` code)."""
    if rc == -1:
        raise NotImplementedError(f"{kernel}: no kernel instantiated for "
                                  "this dtype and shape")
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with "
                           f"cudaError {rc}")


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def dtype_code(dtype) -> int:
    import torch
    if dtype == torch.float32:
        return 0
    if dtype == torch.float64:
        return 1
    raise NotImplementedError(f"CUDA kernels take float32 or float64, not "
                              f"{dtype}")


def lane_minor(x):
    """``(B, ...) -> (..., B)`` contiguous, so a warp's loads coalesce."""
    return x.movedim(0, -1).contiguous()


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
