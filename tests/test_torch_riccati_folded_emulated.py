"""Kernel D's CUDA source, compiled for the CPU and run there, against its
plain PyTorch version.

``csrc/riccati_folded.cu`` is built with the host C++ compiler against
``tests/cuda_emulation/cuda_runtime.h`` (threads and barriers in place of
the card's, the cp.async copies done at once; ``tests/cuda_emulation/
emulate.py`` builds it), and called through the same C entry point and
``ctypes`` signature as on the card.  The quadrotor (n=12) runs the
one-solve-per-team kernel with a shared and a per-lane noise model: a lone
team over one step, one block, and a ragged last block over the bank
path's 50 steps; the unicycle and the cartpole run the one-solve-per-thread
kernel.  ``kernel_check.check_riccati_folded`` holds each value: float64
within 1e-10 and float32 within the JAX tolerances plus the per-θ drift
rule, m_fail equal on every lane and latched on every θ = 1e6 lane.  The
card's own checks are ``tests/test_torch_cuda_kernels.py``; this file
needs only a C++20 compiler (``g++``), and skips without one.
"""
import ctypes

import pytest

torch = pytest.importorskip("torch")

from cuda_emulation.emulate import DTYPES, emulated_libraries  # noqa: E402
from ratilqr_tpu_torch import kernel_check as kc  # noqa: E402
from ratilqr_tpu_torch.ops.riccati_cuda import (BankFolded,  # noqa: E402
                                                folded_layout)

NOISE = [True, False]
NOISE_IDS = ["shared-W", "per-lane-W"]


@pytest.fixture(scope="module")
def libraries(tmp_path_factory):
    return emulated_libraries("riccati_folded.cu", 2,
                              tmp_path_factory.mktemp("kernel_d"))


@pytest.fixture(scope="module")
def emulated(libraries):
    return {dtype: getattr(lib, f"ratilqr_riccati_folded_{DTYPES[dtype]}")
            for dtype, lib in libraries.items()}


def _kernel(entry):
    """:func:`riccati_bank_folded` on CPU tensors through ``entry``."""
    def run(fa, theta):
        ins, w_shared = folded_layout(fa, theta)
        n, (T, B) = ins[3].shape[-3], ins[0].shape
        value = torch.empty(B, dtype=ins[0].dtype)
        m_fail = torch.empty(B, dtype=torch.bool)
        rc = entry(n, B, T, int(w_shared), *(x.data_ptr() for x in ins),
                   value.data_ptr(), m_fail.data_ptr(), None)
        assert rc == 0, rc
        return BankFolded(value, m_fail)
    return run


def _check(emulated, model, T, B, dtype, shared_w):
    kc.check_riccati_folded(model, T, B, dtype, "cpu", shared_w,
                            kernel=_kernel(emulated[dtype]))


@pytest.mark.parametrize("shared_w", NOISE, ids=NOISE_IDS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
@pytest.mark.parametrize("T,B", [(1, 1), (50, 8), (50, 37)],
                         ids=["lone-team", "one-block", "ragged"])
def test_team_kernel_emulated_matches_plain(emulated, T, B, dtype, shared_w):
    _check(emulated, "quadrotor", T, B, dtype, shared_w)


@pytest.mark.parametrize("shared_w", NOISE, ids=NOISE_IDS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
@pytest.mark.parametrize("model", ["unicycle", "cartpole"])
def test_thread_kernel_emulated_matches_plain(emulated, model, dtype,
                                              shared_w):
    _check(emulated, model, 20, 5, dtype, shared_w)


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
def test_shared_memory_query_follows_the_shape(libraries, dtype):
    """``ratilqr_riccati_folded_smem``: 0 B (one solve per thread) at the
    small shipped n, a block's dynamic shared memory within the H100's
    limit at n=12 — more for a per-lane noise model — and −1 for an n the
    library does not hold."""
    query = getattr(libraries[dtype],
                    f"ratilqr_riccati_folded_smem_{DTYPES[dtype]}")
    teams, lanes = ctypes.c_int(), ctypes.c_int()

    def smem(n, w_shared=1):
        return query(n, w_shared, ctypes.byref(teams), ctypes.byref(lanes))

    assert [smem(n, w) for n in (3, 2, 4) for w in (1, 0)] == [0] * 6
    assert smem(6) == -1
    assert (teams.value, lanes.value) == (8, 16)
    shared, per_lane = smem(12), smem(12, w_shared=0)
    assert 0 < shared < per_lane <= 232_448
