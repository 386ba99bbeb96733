"""Kernel B's CUDA source, compiled for the CPU and run there, against its
plain PyTorch version.

``csrc/step.cu`` is built with the host C++ compiler against
``tests/cuda_emulation/cuda_runtime.h`` (threads and barriers in place of
the card's; ``tests/cuda_emulation/emulate.py`` builds it), and called
through the same C entry point and ``ctypes`` signature as on the card.
The quadrotor runs the one-solve-per-team kernel: a lone team, one step,
one block, a ragged last block, and the n=12 h_fail fixture
(``kernel_check.H_FAIL``: μ = −1e6 lanes latch h_fail, θ = 1e6 lanes
m_fail); the unicycle, LQR, the cartpole and the negative-curvature
fixture run the one-solve-per-thread kernel.  ``kernel_check.check_step``
holds each output: x, value, L and dl with float64 within 1e-10 and
float32 within the JAX tolerances plus the per-θ drift rule, m_fail and
h_fail equal on every lane.  The card's own checks are
``tests/test_torch_cuda_kernels.py``; this file needs only a C++20
compiler (``g++``), and skips without one.
"""
import pytest

torch = pytest.importorskip("torch")

from cuda_emulation.emulate import DTYPES, emulated_libraries  # noqa: E402
from ratilqr_tpu_torch import kernel_check as kc  # noqa: E402
from ratilqr_tpu_torch.ops import _build  # noqa: E402
from ratilqr_tpu_torch.ops.step_cuda import StepOut, step_layout  # noqa: E402


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    libs = emulated_libraries("step.cu", 2,
                              tmp_path_factory.mktemp("kernel_b"))
    return {dtype: getattr(lib, f"ratilqr_step_{DTYPES[dtype]}")
            for dtype, lib in libs.items()}


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
    kc.check_step(model, T, 5, dtype, "cpu", _kernel(emulated[dtype]))
