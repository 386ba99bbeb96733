"""The three CUDA kernels against their plain PyTorch versions, on a CUDA
device (skipped without one).

This file imports no JAX, so it also runs on a machine that has none:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda_kernels.py``.  ``chip_smoke.py`` makes the same
checks at the main path's shapes.
"""
import pytest

torch = pytest.importorskip("torch")

from ratilqr_tpu_torch import kernel_check as kc  # noqa: E402
from ratilqr_tpu_torch.ops import _build  # noqa: E402

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", kc.RICCATI_VARIANTS,
                         ids=lambda v: "-".join(k for k, b in v.items() if b)
                         or "evaluating")
@pytest.mark.parametrize("model,T,B", [("unicycle", 20, 133),
                                       ("lqr", 7, 5)])
def test_riccati_kernel_matches_plain(device, model, T, B, variant, dtype):
    kc.check_riccati(model, T, B, dtype, device, **variant)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model,T,B", [("unicycle", 20, 133), ("lqr", 7, 5),
                                       ("negative_curvature", 7, 6)])
def test_step_kernel_matches_plain(device, model, T, B, dtype):
    kc.check_step(model, T, B, dtype, device)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model,T,B", [("unicycle", 20, 133), ("lqr", 7, 5)])
def test_candidate_kernel_matches_plain(device, model, T, B, dtype):
    kc.check_candidate(model, T, B, dtype, device)


def test_fixtures_fail_where_they_should(device):
    m_fail, _ = kc.expect_fail_pattern("unicycle", 20, 10, torch.float32,
                                       device)
    assert m_fail == 2, "the two θ = 1e6 lanes must fail M"
    _, h_fail = kc.expect_fail_pattern("negative_curvature", 7, 6,
                                       torch.float32, device)
    assert h_fail > 0, "negative curvature must fail H at μ = 0"


def test_wrappers_count_launches_and_reject_what_they_cannot_run(device):
    _build.reset_launch_counts()
    kc.check_candidate("lqr", 7, 5, torch.float32, device)
    assert _build.launch_counts["candidate"] == 1
    prob, x0, l, _, theta, mu, noise = kc.bank_inputs(
        "lqr", 7, 5, torch.float32, device)
    from ratilqr_tpu_torch.models import double_integrator
    from ratilqr_tpu_torch.ops.step_cuda import step_optimize_bank
    with pytest.raises(NotImplementedError):
        step_optimize_bank(double_integrator(N=7, dtype=torch.float32,
                                             device=device),
                           x0, l, theta, mu, noise)
    with pytest.raises(NotImplementedError):
        step_optimize_bank(prob, x0.half(), l.half(), theta.half(),
                           mu.half(), noise)
