"""Build a kernel source of ``ratilqr_tpu_torch/csrc`` for the CPU against
``cuda_runtime.h`` beside this file, and load it.

The source's launches ``kernel<<<grid, block, bytes, stream>>>(args);``
become ``emulated_launch(kernel, grid, block, args);`` and its
``extern __shared__`` buffer goes (the header has one); each working type
compiles with ``g++ -std=c++20`` in its own process, both at once, and its
entry points are bound with the same ``ctypes`` signatures as on the card.
"""
import concurrent.futures
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from ratilqr_tpu_torch.ops import _build

HERE = Path(__file__).resolve().parent
LAUNCH = re.compile(r"(\w[\w<>, ]*?)<<<([^,]*), ([^,]*), ([^,]*), ([^>]*)>>>"
                    r"\((\w+)\);")
SHARED = "extern __shared__ __align__(16) unsigned char smem_raw[];"
DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def emulated_libraries(source: str, launches: int, out_dir: Path,
                       defines=()) -> dict:
    """``{dtype: ctypes.CDLL}`` of ``csrc/<source>`` built for the CPU with
    the macro definitions ``defines`` (``"NAME=value"``), which must hold
    ``launches`` kernel launches; skips the calling test without a C++20
    compiler."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler (g++) to emulate the kernel")
    src, n = LAUNCH.subn(r"emulated_launch(\1, \2, \3, \6);",
                         (_build.CSRC_DIR / source).read_text())
    assert n == launches, f"{source} launches {n} kernels, not {launches}"
    path = out_dir / f"{Path(source).stem}_emulated.cpp"
    path.write_text(src.replace(SHARED, ""))

    def compile_one(suffix):
        lib = out_dir / f"lib{path.stem}_{suffix}.so"
        proc = subprocess.run(
            [cxx, "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
             f"-I{HERE}", f"-I{_build.CSRC_DIR}",
             f"-DRQ_DTYPE={_build._SUFFIXES.index(suffix)}",
             *(f"-D{d}" for d in defines), "-o", str(lib),
             str(path)], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return _build._bind(ctypes.CDLL(str(lib)), (suffix,))

    with concurrent.futures.ThreadPoolExecutor(len(DTYPES)) as pool:
        return dict(zip(DTYPES, pool.map(compile_one, DTYPES.values())))
