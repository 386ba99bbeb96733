"""Kernel C's CUDA source, compiled for the CPU and run there, against its
plain PyTorch version.

``csrc/candidate.cu`` is built with the host C++ compiler against
``tests/cuda_emulation/cuda_runtime.h`` (threads and barriers in place of
the card's), its launches rewritten to the emulated launch, and called
through the same C entry point and ``ctypes`` signature as on the card.
The quadrotor runs the one-solve-per-team kernel: a lone team, one block,
a ragged last block, one step and 50.  The small models (the unicycle,
LQR, the cartpole) run one solve per team of K lanes, K = 4 or 1: each
K from a build that fixes it (``-DRQ_SMALL_LANES=K``) over a lone solve,
one block and a ragged bank of several blocks, and from the shipped build,
whose launch picks K from the bank's width and the card's SM count (the
emulated card's, set through ``rq_emu_set_sm_count``).  Each compares the
value and the states of the closed-loop rollout the kernel returns.
Tolerances are
``kernel_check``'s: float64 within 1e-10, float32 within the JAX
tolerances plus the per-θ drift rule, fail flags equal, every θ = 1e6
lane latched.  The card's own checks are
``tests/test_torch_cuda_kernels.py``; this file needs only a C++20
compiler (``g++``), and skips without one
(``tests/cuda_emulation/emulate.py`` builds the source).
"""
import concurrent.futures
import ctypes

import pytest

torch = pytest.importorskip("torch")

from cuda_emulation.emulate import DTYPES, emulated_libraries  # noqa: E402
from ratilqr_tpu_torch import kernel_check as kc  # noqa: E402
from ratilqr_tpu_torch.ops import _build  # noqa: E402
from ratilqr_tpu_torch.ops.candidate_cuda import (  # noqa: E402
    CandidateOut, candidate_bank_plain, candidate_layout)


LANES = (1, 4)   # the lanes a solve the launch picks from at n <= 4
SMALL = ("unicycle", "lqr", "cartpole")


def _entries(libs):
    return {dtype: getattr(lib, f"ratilqr_candidate_{DTYPES[dtype]}")
            for dtype, lib in libs.items()}


@pytest.fixture(scope="module")
def emulated_libs(tmp_path_factory):
    libs = emulated_libraries("candidate.cu", 2,
                              tmp_path_factory.mktemp("kernel_c"))
    yield libs
    for lib in libs.values():
        lib.rq_emu_set_sm_count(132)


@pytest.fixture(scope="module")
def emulated(emulated_libs):
    return _entries(emulated_libs)


@pytest.fixture(scope="module")
def forced(tmp_path_factory):
    """``{K: {dtype: entry}}``: kernel C built with K lanes a solve."""
    dirs = [tmp_path_factory.mktemp(f"kernel_c_lanes{k}") for k in LANES]
    with concurrent.futures.ThreadPoolExecutor(len(LANES)) as pool:
        libs = pool.map(lambda kd: emulated_libraries(
            "candidate.cu", 2, kd[1], (f"RQ_SMALL_LANES={kd[0]}",)),
            zip(LANES, dirs))
        return {k: _entries(lib) for k, lib in zip(LANES, libs)}


@pytest.fixture
def sm_count(emulated_libs):
    """Set the emulated card's SM count; put the H100's 132 back after."""
    def set_count(sms):
        for lib in emulated_libs.values():
            lib.rq_emu_set_sm_count(sms)
    yield set_count
    set_count(132)


def _launch_shape(lib, dtype, model, B):
    """``ratilqr_candidate_smem``: (shared memory a block, solves a block,
    lanes a solve) of the launch on ``model`` at width B."""
    from ratilqr_tpu_torch.ops import tile_model
    model_id = {"unicycle": tile_model.UNICYCLE, "lqr": tile_model.LQR,
                "cartpole": tile_model.CARTPOLE,
                "quadrotor": tile_model.QUADROTOR}.get(model, 99)
    query = getattr(lib, f"ratilqr_candidate_smem_{DTYPES[dtype]}")
    solves, lanes = ctypes.c_int(), ctypes.c_int()
    nbytes = query(model_id, B, ctypes.byref(solves), ctypes.byref(lanes))
    return nbytes, solves.value, lanes.value


def _run(entry, args) -> CandidateOut:
    tm, ins = candidate_layout(*args)
    (T1, n, B), T = ins[0].shape, ins[1].shape[0]
    x = torch.empty((T1, n, B), dtype=ins[0].dtype)
    value = torch.empty(B, dtype=ins[0].dtype)
    m_fail = torch.empty(B, dtype=torch.bool)
    rc = entry(tm.model_id, B, T, _build.params_array(tm.params),
               *(a.data_ptr() for a in ins), x.data_ptr(),
               value.data_ptr(), m_fail.data_ptr(), None)
    assert rc == 0, rc
    return CandidateOut(value, m_fail, x.movedim(-1, 0))


def _check(entries, model, T, B, dtype):
    args = kc.candidate_inputs(model, T, B, dtype, "cpu")
    got = _run(entries[dtype], args)
    want = candidate_bank_plain(*args)
    ref = None
    if dtype == torch.float32:
        prob64, noise64 = kc._problem64(model, T, "cpu")
        ref = candidate_bank_plain(prob64, *map(kc._f64, args[1:-1]),
                                   noise64)
    kc._compare(got, want, ref, args[5], kc.CANDIDATE_FIELDS, dtype)
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


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
@pytest.mark.parametrize("T,B", [(1, 1), (20, 5), (20, 133)],
                         ids=["lone-solve", "one-block", "ragged"])
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("model", SMALL)
def test_small_kernel_emulated_matches_plain(forced, model, lanes, T, B,
                                             dtype):
    """K lanes a solve: a lone solve over one step, one block and a bank of
    133 lanes, ragged over 3 blocks of 64 solves (K = 1) or 5 of 32
    (K = 4)."""
    _check(forced[lanes], model, T, B, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
@pytest.mark.parametrize("B,lanes", [(127, 4), (129, 1)])
@pytest.mark.parametrize("model", SMALL)
def test_launch_picks_lanes_and_matches_plain(emulated_libs, emulated,
                                              sm_count, model, B, lanes,
                                              dtype):
    """On a card of one SM the shipped launch takes 4 lanes a solve at
    B=127 (ragged over 4 blocks) and 1 at B=129 (over 3)."""
    sm_count(1)
    assert _launch_shape(emulated_libs[dtype], dtype, model, B)[2] == lanes
    _check(emulated, model, 20, B, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
def test_launch_shape_follows_the_source_note(emulated_libs, sm_count,
                                              dtype):
    """``ratilqr_candidate_smem`` gives the launch ``csrc/candidate.cu``'s
    note describes: at n <= 4, 4 lanes a solve while the bank stays within
    512 threads an SM (up to B=16,896 on 132 SMs, 128 on one), 32 solves
    a block and three staged steps of shared memory (f32: unicycle 5,604
    B, cartpole 5,388 B, LQR 3,948 B; twice that in f64), else 1 lane, 64
    solves a block and none; the quadrotor teams of 16 lanes, 8 a block."""
    lib = emulated_libs[dtype]
    w = torch.empty((), dtype=dtype).element_size() // 4
    staged = {"unicycle": 5_604 * w, "cartpole": 5_388 * w,
              "lqr": 3_948 * w}
    for sms, last in ((132, 16_896), (1, 128)):
        sm_count(sms)
        for model in SMALL:
            for B in (1, last, last + 1, 262_144):
                want = ((staged[model], 32, 4) if B <= last else (0, 64, 1))
                assert _launch_shape(lib, dtype, model, B) == want
        nbytes, teams, lanes = _launch_shape(lib, dtype, "quadrotor", 1)
        assert (teams, lanes) == (8, 16) and 0 < nbytes <= 232_448
    assert _launch_shape(lib, dtype, "none", 1)[0] == -1
