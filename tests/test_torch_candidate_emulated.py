"""Kernel C's CUDA source, compiled for the CPU and run there, against its
plain PyTorch version.

``csrc/candidate.cu`` is built with the host C++ compiler against
``tests/cuda_emulation/cuda_runtime.h`` (threads and barriers in place of
the card's), its launches rewritten to the emulated launch, and called
through the same C entry point and ``ctypes`` signature as on the card.
The quadrotor runs the one-solve-per-team kernel: a lone team, one block,
a ragged last block, one step and 50; the small models run the
one-solve-per-thread kernel.  Tolerances are ``kernel_check``'s: float64
within 1e-10, float32 within the JAX tolerances plus the per-θ drift
rule, fail flags equal, every θ = 1e6 lane latched.  The card's own
checks are ``tests/test_torch_cuda_kernels.py``; this file needs only a
C++20 compiler (``g++``), and skips without one.
"""
import concurrent.futures
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from ratilqr_tpu_torch import kernel_check as kc  # noqa: E402
from ratilqr_tpu_torch.ops import _build  # noqa: E402
from ratilqr_tpu_torch.ops.candidate_cuda import (  # noqa: E402
    CandidateOut, candidate_bank_plain, candidate_layout)

EMULATION = Path(__file__).resolve().parent / "cuda_emulation"
LAUNCH = re.compile(r"(\w[\w<>, ]*?)<<<([^,]*), ([^,]*), ([^,]*), ([^>]*)>>>"
                    r"\((\w+)\);")
DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def _source(out_dir: Path) -> Path:
    src = (_build.CSRC_DIR / "candidate.cu").read_text()
    src, n = LAUNCH.subn(r"emulated_launch(\1, \2, \3, \6);", src)
    assert n == 2, "candidate.cu launches two kernels"
    src = src.replace("extern __shared__ __align__(16) unsigned char "
                      "smem_raw[];", "")
    path = out_dir / "candidate_emulated.cpp"
    path.write_text(src)
    return path


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler (g++) to emulate the kernel")
    out_dir = tmp_path_factory.mktemp("kernel_c")
    src = _source(out_dir)

    def compile_one(code):
        lib = out_dir / f"libcandidate_{code}.so"
        proc = subprocess.run(
            [cxx, "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
             f"-I{EMULATION}", f"-I{_build.CSRC_DIR}", f"-DRQ_DTYPE={code}",
             "-o", str(lib), str(src)], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return lib

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(compile_one, (0, 1)))
    entries = {}
    for (dtype, suffix), lib in zip(DTYPES.items(), libs):
        fn = getattr(ctypes.CDLL(str(lib)), f"ratilqr_candidate_{suffix}")
        fn.argtypes = _build._SIGNATURES["ratilqr_candidate"]
        fn.restype = ctypes.c_int
        entries[dtype] = fn
    return entries


def _run(entry, args) -> CandidateOut:
    tm, ins = candidate_layout(*args)
    (T1, n, B), T = ins[0].shape, ins[1].shape[0]
    x_scratch = torch.empty((T1, n, B), dtype=ins[0].dtype)
    value = torch.empty(B, dtype=ins[0].dtype)
    m_fail = torch.empty(B, dtype=torch.bool)
    rc = entry(tm.model_id, B, T, _build.params_array(tm.params),
               *(x.data_ptr() for x in ins), x_scratch.data_ptr(),
               value.data_ptr(), m_fail.data_ptr(), None)
    assert rc == 0, rc
    return CandidateOut(value, m_fail)


def _check(entries, model, T, B, dtype):
    args = kc.candidate_inputs(model, T, B, dtype, "cpu")
    got = _run(entries[dtype], args)
    want = candidate_bank_plain(*args)
    ref = None
    if dtype == torch.float32:
        prob64, noise64 = kc._problem64(model, T, "cpu")
        ref = candidate_bank_plain(prob64, *map(kc._f64, args[1:-1]),
                                   noise64)
    kc._compare(got, want, ref, args[5], [("value", "value")], dtype)
    assert bool(got.m_fail[args[5] == 1e6].all())


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
@pytest.mark.parametrize("T,B", [(1, 1), (1, 8), (50, 8), (50, 37)],
                         ids=["lone-team", "one-step", "one-block",
                              "ragged"])
def test_team_kernel_emulated_matches_plain(emulated, T, B, dtype):
    _check(emulated, "quadrotor", T, B, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
@pytest.mark.parametrize("model", ["unicycle", "lqr", "cartpole"])
def test_thread_kernel_emulated_matches_plain(emulated, model, dtype):
    _check(emulated, model, 20, 5, dtype)
