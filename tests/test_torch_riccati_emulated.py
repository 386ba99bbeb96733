"""Kernel A's CUDA source, compiled for the CPU and run there, against its
plain PyTorch version.

``csrc/riccati.cu`` is built with the host C++ compiler against
``tests/cuda_emulation/cuda_runtime.h`` (threads and barriers in place of
the card's, the cp.async copies done at once; ``tests/cuda_emulation/
emulate.py`` builds it), and called through the same C entry point and
``ctypes`` signature as on the card.  The quadrotor (12, 4) runs the
one-solve-per-team kernel in every variant of
``kernel_check.RICCATI_VARIANTS`` (optimizing or evaluating, slim or full,
shared or per-lane noise model, with or without a dl stream): a lone team
over one step, one block, and a ragged last block over the bank path's 50
steps; the n=12 h_fail fixture (``kernel_check.H_FAIL``: μ = −1e6 lanes
latch h_fail, θ = 1e6 lanes m_fail) runs the optimizing variants; the
unicycle and the cartpole run the one-solve-per-thread kernel in every
variant.  ``kernel_check.check_riccati`` holds each output: float64 within
1e-10 and float32 within the JAX tolerances plus the per-θ drift rule,
m_fail and h_fail equal on every lane.  The card's own checks are
``tests/test_torch_cuda_kernels.py``; this file needs only a C++20
compiler (``g++``), and skips without one.
"""
import ctypes

import pytest

torch = pytest.importorskip("torch")

from cuda_emulation.emulate import DTYPES, emulated_libraries  # noqa: E402
from ratilqr_tpu_torch import kernel_check as kc  # noqa: E402
from ratilqr_tpu_torch.ops.riccati_cuda import (BankDP,  # noqa: E402
                                                BankSlim, riccati_layout)

VARIANTS = kc.RICCATI_VARIANTS
VARIANT_IDS = ["-".join(k for k, b in v.items() if b) or "evaluating"
               for v in VARIANTS]
OPTIMIZING = [v for v in VARIANTS if v["optimizing"]]


@pytest.fixture(scope="module")
def libraries(tmp_path_factory):
    return emulated_libraries("riccati.cu", 3,
                              tmp_path_factory.mktemp("kernel_a"))


@pytest.fixture(scope="module")
def emulated(libraries):
    return {dtype: getattr(lib, f"ratilqr_riccati_{DTYPES[dtype]}")
            for dtype, lib in libraries.items()}


def _kernel(entry):
    """:func:`riccati_bank` on CPU tensors through ``entry``."""
    def run(approx, theta, mu, L_in=None, dl_in=None, *, slim=False):
        ins, (n, m, w_shared) = riccati_layout(approx, theta, mu, L_in,
                                               dl_in)
        (T, B), dtype = ins[0].shape, ins[0].dtype
        optimizing, full = L_in is None, not slim

        def empty(*shape, dt=dtype, keep=True):
            return torch.empty(shape, dtype=dt) if keep else None

        value = empty(B)
        L = empty(T, m, n, B, keep=optimizing or full)
        dl = empty(T, m, B, keep=optimizing or full)
        s, s_vec, S = (empty(T, B, keep=full), empty(T, n, B, keep=full),
                       empty(T, n, n, B, keep=full))
        g, G, H = (empty(T, m, B, keep=full), empty(T, m, n, B, keep=full),
                   empty(T, m, m, B, keep=full))
        m_fail, h_fail = empty(B, dt=torch.bool), empty(B, dt=torch.bool)
        outs = [value, s, s_vec, S, g, G, H, L, dl, m_fail, h_fail]
        rc = entry(n, m, B, T, int(optimizing), int(slim), int(w_shared),
                   int(dl_in is not None),
                   *(None if x is None else x.data_ptr() for x in ins),
                   *(None if x is None else x.data_ptr() for x in outs),
                   None)
        assert rc == 0, rc

        def back(x):
            return None if x is None else x.movedim(-1, 0)

        if slim:
            return BankSlim(value, back(L), back(dl), m_fail, h_fail)
        return BankDP(back(s), back(s_vec), back(S), back(g), back(G),
                      back(H), back(L), back(dl), m_fail, h_fail)
    return run


def _check(emulated, model, T, B, dtype, variant):
    kc.check_riccati(model, T, B, dtype, "cpu", **variant,
                     kernel=_kernel(emulated[dtype]))


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
@pytest.mark.parametrize("T,B", [(1, 1), (50, 8), (50, 37)],
                         ids=["lone-team", "one-block", "ragged"])
def test_team_kernel_emulated_matches_plain(emulated, T, B, dtype, variant):
    _check(emulated, "quadrotor", T, B, dtype, variant)


@pytest.mark.parametrize("variant", OPTIMIZING,
                         ids=[i for i, v in zip(VARIANT_IDS, VARIANTS)
                              if v["optimizing"]])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
def test_team_kernel_emulated_latches_h_fail(emulated, dtype, variant):
    _check(emulated, kc.H_FAIL, 20, 10, dtype, variant)


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
@pytest.mark.parametrize("model,T", [("unicycle", 20), ("cartpole", 20)])
def test_thread_kernel_emulated_matches_plain(emulated, model, T, dtype,
                                              variant):
    _check(emulated, model, T, 5, dtype, variant)


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
def test_shared_memory_query_follows_the_shape(libraries, dtype):
    """``ratilqr_riccati_smem``: 0 B (one solve per thread) at the small
    shipped shapes, a block's dynamic shared memory within the H100's
    limit at (12, 4) in each variant — more for a per-lane noise model
    and for the evaluating pass's staged policy — and −1 for a shape the
    library does not hold."""
    query = getattr(libraries[dtype], f"ratilqr_riccati_smem_{DTYPES[dtype]}")
    teams, lanes = ctypes.c_int(), ctypes.c_int()

    def smem(n, m, optimizing=1, w_shared=1):
        return query(n, m, optimizing, w_shared, ctypes.byref(teams),
                     ctypes.byref(lanes))

    assert [smem(n, m) for n, m in ((3, 2), (2, 2), (4, 1))] == [0, 0, 0]
    assert smem(6, 3) == -1
    assert (teams.value, lanes.value) == (8, 16)
    opt, per_lane = smem(12, 4), smem(12, 4, w_shared=0)
    evaluating = smem(12, 4, optimizing=0)
    assert 0 < opt < evaluating and opt < per_lane <= 232_448
