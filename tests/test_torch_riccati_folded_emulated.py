"""Kernel D's CUDA source, compiled for the CPU and run there, against its
plain PyTorch version.

``csrc/riccati_folded.cu`` is built with the host C++ compiler against
``tests/cuda_emulation/cuda_runtime.h`` (threads and barriers in place of
the card's, the cp.async copies done at once; ``tests/cuda_emulation/
emulate.py`` builds it), and called through the same C entry point and
``ctypes`` signature as on the card, with a shared and a per-lane noise
model, on each design:
  - the quadrotor (n=12), one solve per team of 16 lanes: a lone team over
    one step, one block, and a ragged last block over the bank path's 50
    steps;
  - the unicycle, LQR and the cartpole (n ≤ 4), one solve per team of 4
    lanes, each step's blocks read into registers, or one per thread above
    the 4-lane band: each from a build that fixes K
    (``-DRQ_SMALL_LANES=K``) over a lone solve, one block and a bank
    ragged over several blocks, the θ = 1e6 lanes latching m_fail; the
    shipped build, whose launch picks K from the width and the emulated
    card's SM count (``rq_emu_set_sm_count``), on each side of the band
    edge;
  - n=1, built at its first use (``-DRQ_SHAPE_N``), on the few-lane
    kernel, and n=16, built at its first use, one solve per thread.
``kernel_check.check_riccati_folded`` holds each value: float64 within
1e-10 and float32 within the JAX tolerances plus the per-θ drift rule,
m_fail equal on every lane and latched on every θ = 1e6 lane.  The card's
own checks are ``tests/test_torch_cuda_kernels.py``; this file needs only
a C++20 compiler (``g++``), and skips without one.
"""
import concurrent.futures
import ctypes

import pytest

torch = pytest.importorskip("torch")

from cuda_emulation.emulate import DTYPES, emulated_libraries  # noqa: E402
from ratilqr_tpu_torch import kernel_check as kc  # noqa: E402
from ratilqr_tpu_torch.ops.riccati_cuda import (BankFolded,  # noqa: E402
                                                folded_layout,
                                                riccati_bank_folded_plain)

NOISE = [True, False]
NOISE_IDS = ["shared-W", "per-lane-W"]
LAUNCHES = 3     # kernel launches in riccati_folded.cu
LANES = (1, 4)   # the lanes a solve the launch picks from at n <= 4
SMALL = {"unicycle": 3, "lqr": 2, "cartpole": 4}
# (T, B): a lone solve, one block (32 solves at K = 4, 128 at K = 1) and a
# bank of 133 lanes ragged over 5 blocks (K = 4) or 2 (K = 1).
SMALL_CASES = ((20, 1), (20, 5), (20, 133))


def _entries(libs):
    return {dtype: getattr(lib, f"ratilqr_riccati_folded_{DTYPES[dtype]}")
            for dtype, lib in libs.items()}


def _build_all(tmp_path_factory, units):
    """``{name: {dtype: CDLL}}`` of kernel D built with each unit's macro
    definitions (``units``: name → defines), all at once."""
    dirs = [tmp_path_factory.mktemp(f"kernel_d_{name}") for name in units]
    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        libs = pool.map(lambda ud: emulated_libraries(
            "riccati_folded.cu", LAUNCHES, ud[1], ud[0]),
            zip(units.values(), dirs))
        return dict(zip(units, libs))


@pytest.fixture(scope="module")
def libraries(tmp_path_factory):
    libs = emulated_libraries("riccati_folded.cu", LAUNCHES,
                              tmp_path_factory.mktemp("kernel_d"))
    yield libs
    for lib in libs.values():
        lib.rq_emu_set_sm_count(132)


@pytest.fixture(scope="module")
def emulated(libraries):
    return _entries(libraries)


@pytest.fixture(scope="module")
def forced(tmp_path_factory):
    """``{K: {dtype: entry}}``: kernel D built with K lanes a solve."""
    libs = _build_all(tmp_path_factory, {k: (f"RQ_SMALL_LANES={k}",)
                                         for k in LANES})
    return {k: _entries(lib) for k, lib in libs.items()}


@pytest.fixture(scope="module")
def first_use(tmp_path_factory):
    """``{n: {dtype: CDLL}}``: kernel D built for n=1 and for n=16 alone,
    as an n is at its first use."""
    libs = _build_all(tmp_path_factory, {n: (f"RQ_SHAPE_N={n}",)
                                         for n in (1, 16)})
    return libs


@pytest.fixture
def sm_count(libraries):
    """Set the emulated card's SM count; put the H100's 132 back after."""
    def set_count(sms):
        for lib in libraries.values():
            lib.rq_emu_set_sm_count(sms)
    yield set_count
    set_count(132)


def _launch_shape(lib, dtype, n, B, w_shared=1):
    """``ratilqr_riccati_folded_smem``: (shared memory a block, solves a
    block, lanes a solve) of the launch at n and width B."""
    query = getattr(lib, f"ratilqr_riccati_folded_smem_{DTYPES[dtype]}")
    solves, lanes = ctypes.c_int(), ctypes.c_int()
    nbytes = query(n, B, w_shared, ctypes.byref(solves), ctypes.byref(lanes))
    return nbytes, solves.value, lanes.value


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
@pytest.mark.parametrize("model", ["unicycle", "cartpole", "lqr"])
def test_thread_kernel_emulated_matches_plain(emulated, model, dtype,
                                              shared_w):
    """The shipped build at n <= 4 (4 lanes a solve at B=5)."""
    _check(emulated, model, 20, 5, dtype, shared_w)


@pytest.mark.parametrize("shared_w", NOISE, ids=NOISE_IDS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("model", list(SMALL))
def test_small_kernel_emulated_matches_plain(forced, model, lanes, dtype,
                                             shared_w):
    """K lanes a solve, in each case of ``SMALL_CASES``."""
    for T, B in SMALL_CASES:
        _check(forced[lanes], model, T, B, dtype, shared_w)
    kc.clear_caches()


@pytest.mark.parametrize("shared_w", NOISE, ids=NOISE_IDS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("model", list(SMALL))
def test_small_kernel_emulated_latches_m_fail(forced, model, lanes, dtype,
                                              shared_w):
    """At K lanes a solve the θ = 1e6 lanes of a ragged bank latch m_fail,
    and every lane's m_fail equals the plain version's."""
    fa, theta = kc.folded_inputs(model, 20, 37, dtype, "cpu", shared_w)
    got = _kernel(forced[lanes][dtype])(fa, theta)
    assert bool(got.m_fail[theta == 1e6].all())
    assert int((theta == 1e6).sum()) > 0
    assert torch.equal(got.m_fail, riccati_bank_folded_plain(fa, theta).m_fail)


@pytest.mark.parametrize("model", list(SMALL))
def test_folded_margins_mark_the_failed_lanes(model):
    """``kernel_check.folded_margins``: M's smallest eigenvalue relative
    to W⁻¹'s scale is negative on exactly the lanes whose float64 plain
    pass latches m_fail (the θ = 1e6 lanes among them), and positive
    where θ = 0 (M = W⁻¹)."""
    fa, theta = kc.folded_inputs(model, 20, 37, torch.float64, "cpu")
    margins = torch.tensor(kc.folded_margins(fa, theta, list(range(37))),
                           dtype=torch.float64)
    m_fail = riccati_bank_folded_plain(fa, theta).m_fail
    assert torch.equal(margins < 0, m_fail)
    assert bool(m_fail[theta == 1e6].all()) and int((theta == 1e6).sum())
    assert bool((margins[theta == 0] > 0).all()) and int((theta == 0).sum())
    kc.clear_caches()


@pytest.mark.parametrize("lanes", LANES)
def test_small_kernel_emulated_flags_match_float64(forced, lanes):
    """``kernel_check.check_folded_flags`` at K lanes a solve: the float32
    m_fail equals the float64 plain version's on every lane of a ragged
    cartpole bank that float32 resolves, and no lane differs."""
    entry = forced[lanes][torch.float32]
    assert kc.check_folded_flags("cartpole", 20, 133, "cpu",
                                 kernel=_kernel(entry)) == []
    kc.clear_caches()


@pytest.mark.parametrize("shared_w", NOISE, ids=NOISE_IDS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
@pytest.mark.parametrize("B,lanes", [(64, 4), (65, 4), (128, 4), (129, 1)])
@pytest.mark.parametrize("model", list(SMALL))
def test_launch_picks_lanes_and_matches_plain(libraries, emulated, sm_count,
                                              model, B, lanes, dtype,
                                              shared_w):
    """On a card of one SM the shipped launch takes 4 lanes a solve up to
    B=128 (512 threads an SM), reading each step into registers, and one
    solve per thread from B=129, with no shared memory at any width."""
    sm_count(1)
    assert _launch_shape(libraries[dtype], dtype, SMALL[model], B,
                         int(shared_w)) == ((0, 32, 4) if lanes == 4
                                            else (0, 128, 1))
    _check(emulated, model, 20, B, dtype, shared_w)


@pytest.mark.parametrize("shared_w", NOISE, ids=NOISE_IDS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
@pytest.mark.parametrize("n,lanes", [(1, 4), (16, 1)])
def test_first_use_kernel_emulated_matches_plain(first_use, n, lanes, dtype,
                                                 shared_w):
    """n=1, not shipped: the few-lane design, 4 lanes a solve over a
    ragged bank of 5 blocks; n=16: one solve per thread, 128 a block."""
    lib = first_use[n][dtype]
    assert _launch_shape(lib, dtype, n, 133, int(shared_w)) == (
        (0, 32, 4) if lanes == 4 else (0, 128, 1))
    kc.check_riccati_folded(
        f"linear{n}x{min(n, 2)}", 20, 133, dtype, "cpu", shared_w,
        kernel=_kernel(getattr(lib, f"ratilqr_riccati_folded_"
                                    f"{DTYPES[dtype]}")))


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
def test_shared_memory_query_follows_the_shape(libraries, sm_count, dtype):
    """``ratilqr_riccati_folded_smem`` gives the launch
    ``csrc/riccati_folded.cu``'s note describes: at the small shipped n 4
    lanes a solve, 32 solves a block, while the bank stays within 512
    threads an SM (up to B=16,896 on 132 SMs, 128 on one), else one solve
    per thread, 128 a block, no shared memory; at
    n=12 teams of 16 lanes, 8 a block, in dynamic shared memory within the
    H100's limit, more for a per-lane noise model; -1 for an n the library
    does not hold."""
    lib = libraries[dtype]
    for sms, last in ((132, 16_896), (1, 128)):
        sm_count(sms)
        for n in SMALL.values():
            for B in (1, last // 2, last, last + 1, 262_144):
                for w in (1, 0):
                    assert _launch_shape(lib, dtype, n, B, w) == (
                        (0, 32, 4) if B <= last else (0, 128, 1))
    assert _launch_shape(lib, dtype, 6, 1)[0] == -1
    shared, teams, lanes = _launch_shape(lib, dtype, 12, 1)
    assert (teams, lanes) == (8, 16)
    per_lane = _launch_shape(lib, dtype, 12, 1, w_shared=0)[0]
    assert 0 < shared < per_lane <= 232_448
