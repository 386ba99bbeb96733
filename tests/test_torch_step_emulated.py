"""Kernel B's CUDA source, compiled for the CPU and run there, against its
plain PyTorch version.

``csrc/step.cu`` is built with the host C++ compiler against
``tests/cuda_emulation/cuda_runtime.h`` (threads and barriers in place of
the card's; ``tests/cuda_emulation/emulate.py`` builds it), and called
through the same C entry point and ``ctypes`` signature as on the card.
The quadrotor runs the one-solve-per-team kernel: a lone team, one step,
one block, a ragged last block, and the n=12 h_fail fixture
(``kernel_check.H_FAIL``: μ = −1e6 lanes latch h_fail, θ = 1e6 lanes
m_fail).  The small models (the unicycle, LQR, the cartpole, and the
negative-curvature fixture) run one solve per team of K lanes, K = 4 or
1: each K from a build that fixes it (``-DRQ_SMALL_LANES=K``) over a lone
solve, one block, a ragged bank of several blocks and each model's h_fail
fixture, and from the shipped build, whose launch picks K from the bank's
width and the card's SM count (the emulated card's, set through
``rq_emu_set_sm_count``).  ``kernel_check.check_step`` holds each output:
x, value, L and dl with float64 within 1e-10 and float32 within the JAX
tolerances plus the per-θ drift rule, m_fail and h_fail equal on every
lane, every θ = 1e6 lane latched.  The card's own checks are
``tests/test_torch_cuda_kernels.py``; this file needs only a C++20
compiler (``g++``), and skips without one.
"""
import concurrent.futures
import ctypes

import pytest

torch = pytest.importorskip("torch")

from cuda_emulation.emulate import DTYPES, emulated_libraries  # noqa: E402
from ratilqr_tpu_torch import kernel_check as kc  # noqa: E402
from ratilqr_tpu_torch.ops import _build, tile_model  # noqa: E402
from ratilqr_tpu_torch.ops.step_cuda import StepOut, step_layout  # noqa: E402

LANES = (1, 4)   # the lanes a solve the launch picks from at n <= 4
SMALL = ("unicycle", "lqr", "cartpole")
MODEL_IDS = {"unicycle": tile_model.UNICYCLE, "lqr": tile_model.LQR,
             "cartpole": tile_model.CARTPOLE,
             "quadrotor": tile_model.QUADROTOR}


def _entries(libs):
    return {dtype: getattr(lib, f"ratilqr_step_{DTYPES[dtype]}")
            for dtype, lib in libs.items()}


@pytest.fixture(scope="module")
def emulated_libs(tmp_path_factory):
    libs = emulated_libraries("step.cu", 2,
                              tmp_path_factory.mktemp("kernel_b"))
    yield libs
    for lib in libs.values():
        lib.rq_emu_set_sm_count(132)


@pytest.fixture(scope="module")
def emulated(emulated_libs):
    return _entries(emulated_libs)


@pytest.fixture(scope="module")
def forced(tmp_path_factory):
    """``{K: {dtype: entry}}``: kernel B built with K lanes a solve."""
    dirs = [tmp_path_factory.mktemp(f"kernel_b_lanes{k}") for k in LANES]
    with concurrent.futures.ThreadPoolExecutor(len(LANES)) as pool:
        libs = pool.map(lambda kd: emulated_libraries(
            "step.cu", 2, kd[1], (f"RQ_SMALL_LANES={kd[0]}",)),
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
    """``ratilqr_step_smem``: (shared memory a block, solves a block,
    lanes a solve) of the launch on ``model`` at width B."""
    query = getattr(lib, f"ratilqr_step_smem_{DTYPES[dtype]}")
    solves, lanes = ctypes.c_int(), ctypes.c_int()
    nbytes = query(MODEL_IDS.get(model, 99), B, ctypes.byref(solves),
                   ctypes.byref(lanes))
    return nbytes, solves.value, lanes.value


def _kernel(entry):
    """:func:`step_optimize_bank` on CPU tensors through ``entry``."""
    def run(*args) -> StepOut:
        tm, ins = step_layout(*args)
        (T, m, B), n, dtype = ins[0].shape, tm.n, ins[0].dtype
        x = torch.empty((T + 1, n, B), dtype=dtype)
        value = torch.empty(B, dtype=dtype)
        L = torch.empty((T, m, n, B), dtype=dtype)
        dl = torch.empty((T, m, B), dtype=dtype)
        m_fail = torch.empty(B, dtype=torch.bool)
        h_fail = torch.empty(B, dtype=torch.bool)
        rc = entry(tm.model_id, B, T, _build.params_array(tm.params),
                   *(t.data_ptr() for t in ins),
                   *(t.data_ptr() for t in (x, value, L, dl, m_fail, h_fail)),
                   None)
        assert rc == 0, rc
        return StepOut(x.movedim(-1, 0), value, L.movedim(-1, 0),
                       dl.movedim(-1, 0), m_fail, h_fail)
    return run


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
@pytest.mark.parametrize("model,T,B", [
    ("quadrotor", 1, 1), ("quadrotor", 1, 8), ("quadrotor", 50, 8),
    ("quadrotor", 50, 37), (kc.H_FAIL, 20, 37)],
    ids=["lone-team", "one-step", "one-block", "ragged", "h-fail"])
def test_team_kernel_emulated_matches_plain(emulated, model, T, B, dtype):
    kc.check_step(model, T, B, dtype, "cpu", _kernel(emulated[dtype]))


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
@pytest.mark.parametrize("model,T", [("unicycle", 20), ("lqr", 7),
                                     ("cartpole", 20),
                                     ("negative_curvature", 7)])
def test_thread_kernel_emulated_matches_plain(emulated, model, T, dtype):
    """The shipped build at n <= 4 (4 lanes a solve at B=5), the
    negative-curvature fixture's lanes latching h_fail."""
    kc.check_step(model, T, 5, dtype, "cpu", _kernel(emulated[dtype]))


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
    kc.check_step(model, T, B, dtype, "cpu", _kernel(forced[lanes][dtype]))


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("model", SMALL)
def test_small_kernel_emulated_latches_h_fail(forced, model, lanes, dtype):
    """Each small model's h_fail fixture (``kernel_check.h_fail_fixture``)
    at K lanes a solve: the μ = −1e6 lanes latch h_fail and not m_fail,
    the θ = 1e6 lanes m_fail, in agreement with the plain version."""
    kc.check_step(kc.h_fail_fixture(model), 20, 37, dtype, "cpu",
                  _kernel(forced[lanes][dtype]))


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
    kc.check_step(model, 20, B, dtype, "cpu", _kernel(emulated[dtype]))


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES.values()))
def test_launch_shape_follows_the_source_note(emulated_libs, sm_count,
                                              dtype):
    """``ratilqr_step_smem`` gives the launch ``csrc/step.cu``'s note
    describes: at n <= 4, 4 lanes a solve while the bank stays within 512
    threads an SM (up to B=16,896 on 132 SMs, 128 on one), 32 solves a
    block, else 1 lane and 64 solves a block, with no shared memory either
    way; the quadrotor teams of 16 lanes, 8 a block, in shared memory."""
    lib = emulated_libs[dtype]
    for sms, last in ((132, 16_896), (1, 128)):
        sm_count(sms)
        for model in SMALL:
            for B in (1, last, last + 1, 262_144):
                want = (0, 32, 4) if B <= last else (0, 64, 1)
                assert _launch_shape(lib, dtype, model, B) == want
        nbytes, teams, lanes = _launch_shape(lib, dtype, "quadrotor", 1)
        assert (teams, lanes) == (8, 16) and 0 < nbytes <= 232_448
    assert _launch_shape(lib, dtype, "none", 1)[0] == -1
