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
C++20 compiler (``g++``), and skips without one
(``tests/cuda_emulation/emulate.py`` builds the source).
"""
import pytest

torch = pytest.importorskip("torch")

from cuda_emulation.emulate import DTYPES, emulated_libraries  # noqa: E402
from ratilqr_tpu_torch import kernel_check as kc  # noqa: E402
from ratilqr_tpu_torch.ops import _build  # noqa: E402
from ratilqr_tpu_torch.ops.candidate_cuda import (  # noqa: E402
    CandidateOut, candidate_bank_plain, candidate_layout)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    libs = emulated_libraries("candidate.cu", 2,
                              tmp_path_factory.mktemp("kernel_c"))
    return {dtype: getattr(lib, f"ratilqr_candidate_{DTYPES[dtype]}")
            for dtype, lib in libs.items()}


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
