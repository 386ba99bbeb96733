"""Kernel A's CUDA source, compiled for the CPU and run there, against its
plain PyTorch version.

``csrc/riccati.cu`` is built with the host C++ compiler against
``tests/cuda_emulation/cuda_runtime.h`` (threads and barriers in place of
the card's, the cp.async copies done at once; ``tests/cuda_emulation/
emulate.py`` builds it), and called through the same C entry point and
``ctypes`` signature as on the card.  Every variant of
``kernel_check.RICCATI_VARIANTS`` (optimizing or evaluating, slim or full,
shared or per-lane noise model, with or without a dl stream) runs on each
design:
  - the quadrotor (12, 4), one solve per team of 16 lanes: a lone team
    over one step, one block, and a ragged last block over the bank path's
    50 steps; the n=12 h_fail fixture (``kernel_check.H_FAIL``: μ = −1e6
    lanes latch h_fail, θ = 1e6 lanes m_fail) in the optimizing variants;
  - the unicycle, LQR and the cartpole (n, m ≤ 4), one solve per team of
    K = 4 or 1 lanes, each step's blocks read into registers or staged in
    shared memory: each K and form from a build that fixes them
    (``-DRQ_SMALL_LANES=K``, ``-DRQ_STEP_FORM``) over a lone solve and one
    step, one block, and a bank ragged over several blocks, and each
    model's h_fail fixture (``kernel_check.h_fail_fixture``) in the
    optimizing variants; the shipped build, whose launch picks K and the
    form from the width and the emulated card's SM count
    (``rq_emu_set_sm_count``), in each of its three bands;
  - (2, 6), built at its first use (``-DRQ_SHAPE_N/M``), one solve per
    thread (m > 4).
``kernel_check.check_riccati`` holds each output: float64 within 1e-10 and
float32 within the JAX tolerances plus the per-θ drift rule, m_fail and
h_fail equal on every lane, every θ = 1e6 lane latched.  The card's own checks are
``tests/test_torch_cuda_kernels.py``; this file needs only a C++20
compiler (``g++``), and skips without one.
"""
import concurrent.futures
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
OPTIMIZING_IDS = [i for i, v in zip(VARIANT_IDS, VARIANTS) if v["optimizing"]]
LAUNCHES = 4     # kernel launches in riccati.cu
LANES = (1, 4)   # the lanes a solve the launch picks from at n, m <= 4
FORMS = {"direct": 0, "staged": 1}   # -DRQ_STEP_FORM of each form
SMALL = {"unicycle": (3, 2), "lqr": (2, 2), "cartpole": (4, 1)}
# (T, B): a lone solve over one step, one block (32 solves at K = 4, 64 at
# K = 1) and a bank of 133 lanes ragged over 5 blocks (K = 4) or 3 (K = 1).
SMALL_CASES = ((1, 1), (20, 5), (20, 133))


def _entries(libs):
    return {dtype: getattr(lib, f"ratilqr_riccati_{DTYPES[dtype]}")
            for dtype, lib in libs.items()}


@pytest.fixture(scope="module")
def libraries(tmp_path_factory):
    libs = emulated_libraries("riccati.cu", LAUNCHES,
                              tmp_path_factory.mktemp("kernel_a"))
    yield libs
    for lib in libs.values():
        lib.rq_emu_set_sm_count(132)


@pytest.fixture(scope="module")
def emulated(libraries):
    return _entries(libraries)


@pytest.fixture(scope="module")
def forced(tmp_path_factory):
    """``{(K, form): {dtype: entry}}``: kernel A built with K lanes a solve
    and each step read into registers or staged (a step too large for
    registers, float64 (4, 1), is staged in both)."""
    units = [(k, f) for k in LANES for f in FORMS]
    dirs = [tmp_path_factory.mktemp(f"kernel_a_lanes{k}_{f}")
            for k, f in units]
    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        libs = pool.map(lambda ud: emulated_libraries(
            "riccati.cu", LAUNCHES, ud[1], (f"RQ_SMALL_LANES={ud[0][0]}",
                                            f"RQ_STEP_FORM={FORMS[ud[0][1]]}")),
            zip(units, dirs))
        return {u: _entries(lib) for u, lib in zip(units, libs)}


@pytest.fixture(scope="module")
def first_use(tmp_path_factory):
    """``{(n, m): {dtype: entry}}``: kernel A built for (2, 6) and for
    (4, 4) alone, as a shape is at its first use."""
    shapes = ((2, 6), (4, 4))
    dirs = [tmp_path_factory.mktemp(f"kernel_a_{n}x{m}") for n, m in shapes]
    with concurrent.futures.ThreadPoolExecutor(len(shapes)) as pool:
        libs = pool.map(lambda sd: emulated_libraries(
            "riccati.cu", LAUNCHES, sd[1],
            (f"RQ_SHAPE_N={sd[0][0]}", f"RQ_SHAPE_M={sd[0][1]}")),
            zip(shapes, dirs))
        return {s: _entries(lib) for s, lib in zip(shapes, libs)}


@pytest.fixture
def sm_count(libraries):
    """Set the emulated card's SM count; put the H100's 132 back after."""
    def set_count(sms):
        for lib in libraries.values():
            lib.rq_emu_set_sm_count(sms)
    yield set_count
    set_count(132)


def _launch_shape(lib, dtype, n, m, B, optimizing=1, w_shared=1):
    """``ratilqr_riccati_smem``: (shared memory a block, solves a block,
    lanes a solve) of the launch at (n, m) and width B."""
    query = getattr(lib, f"ratilqr_riccati_smem_{DTYPES[dtype]}")
    solves, lanes = ctypes.c_int(), ctypes.c_int()
    nbytes = query(n, m, B, optimizing, w_shared, ctypes.byref(solves),
                   ctypes.byref(lanes))
    return nbytes, solves.value, lanes.value


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
    """The shipped build at n, m <= 4 (4 lanes a solve at B=5)."""
    _check(emulated, model, T, 5, dtype, variant)


def _always_staged(model, dtype):
    """A step too large for registers (``riccati.cu:kStageAlways``)."""
    return model == "cartpole" and dtype == torch.float64


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("model", list(SMALL))
def test_small_kernel_emulated_matches_plain(forced, model, lanes, form,
                                             dtype, variant):
    """K lanes a solve and each form, in each case of ``SMALL_CASES``."""
    for T, B in SMALL_CASES:
        _check(forced[lanes, form], model, T, B, dtype, variant)
    kc.clear_caches()


@pytest.mark.parametrize("variant", OPTIMIZING, ids=OPTIMIZING_IDS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("model", list(SMALL))
def test_small_kernel_emulated_latches_h_fail(forced, model, lanes, form,
                                              dtype, variant):
    """Each small model's h_fail fixture at K lanes a solve and each form:
    the μ = −1e6 lanes latch h_fail and not m_fail, the θ = 1e6 lanes
    m_fail, in agreement with the plain version."""
    _check(forced[lanes, form], kc.h_fail_fixture(model), 20, 37, dtype,
           variant)


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
@pytest.mark.parametrize("B,lanes", [(64, 4), (127, 4), (129, 1)])
@pytest.mark.parametrize("model", list(SMALL))
def test_launch_picks_lanes_and_matches_plain(libraries, emulated, sm_count,
                                              model, B, lanes, dtype,
                                              variant):
    """On a card of one SM the shipped launch takes 4 lanes a solve,
    reading each step into registers, at B=64 (2 blocks), 4 lanes staged
    at B=127 (ragged over 4 blocks) and 1 lane at B=129 (over 3)."""
    sm_count(1)
    n, m = SMALL[model]
    nbytes, _, got = _launch_shape(libraries[dtype], dtype, n, m, B)
    assert got == lanes
    assert (nbytes > 0) == (B == 127 or _always_staged(model, dtype))
    _check(emulated, model, 20, B, dtype, variant)


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
def test_first_use_thread_kernel_emulated_matches_plain(first_use, dtype,
                                                        variant):
    """(2, 6), m > 4: one solve per thread, 128 a block, a ragged bank."""
    _check(first_use[2, 6], "linear2x6", 20, 133, dtype, variant)


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
def test_first_use_small_kernel_emulated_matches_plain(first_use, dtype,
                                                       variant):
    """(4, 4), n, m <= 4 and not shipped: the few-lane design, 4 lanes a
    solve over a ragged bank of 5 blocks (each step read into registers
    in float32, staged in float64, whose step is too large for
    registers)."""
    _check(first_use[4, 4], "linear4x4", 20, 133, dtype, variant)


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
def test_shared_memory_query_follows_the_shape(libraries, sm_count, dtype):
    """``ratilqr_riccati_smem`` gives the launch ``csrc/riccati.cu``'s note
    describes: at the small shipped shapes 4 lanes a solve, 32 solves a
    block, while the bank stays within 512 threads an SM (up to B=16,896
    on 132 SMs, 128 on one), else 1 lane and 64 solves a block; at 4
    lanes each step read into registers while the bank stays within 256
    threads an SM (up to 8,448 on 132 SMs, 64 on one), above staged in
    shared memory (more for a per-lane noise model and for the evaluating
    pass's policy), as at every width where a step is too large for
    registers (float64 (4, 1)); at (12, 4) teams of 16 lanes, 8 a block,
    in dynamic shared memory within the H100's limit in each variant; -1
    for a shape the library does not hold."""
    lib = libraries[dtype]
    for sms, direct, last in ((132, 8_448, 16_896), (1, 64, 128)):
        sm_count(sms)
        for model, (n, m) in SMALL.items():
            always = _always_staged(model, dtype)
            for B in (1, direct, direct + 1, last, last + 1, 262_144):
                nbytes, solves, lanes = _launch_shape(lib, dtype, n, m, B)
                assert (solves, lanes) == ((32, 4) if B <= last else (64, 1))
                assert (nbytes > 0) == (always or direct < B <= last)
                assert nbytes <= 232_448   # a block's limit on the H100
            B = direct + 1
            opt, per_lane = (_launch_shape(lib, dtype, n, m, B)[0],
                             _launch_shape(lib, dtype, n, m, B, w_shared=0)[0])
            evaluating = _launch_shape(lib, dtype, n, m, B, optimizing=0)[0]
            assert 0 < opt < evaluating and opt < per_lane
    assert _launch_shape(lib, dtype, 6, 3, 1)[0] == -1
    opt, teams, lanes = _launch_shape(lib, dtype, 12, 4, 1)
    assert (teams, lanes) == (8, 16)
    per_lane = _launch_shape(lib, dtype, 12, 4, 1, w_shared=0)[0]
    evaluating = _launch_shape(lib, dtype, 12, 4, 1, optimizing=0)[0]
    assert 0 < opt < evaluating and opt < per_lane <= 232_448
