"""The four CUDA kernels against their plain PyTorch versions (unicycle,
LQR, the cartpole, the n=12 quadrotor, and kernels A and D at a shape built
at its first use), kernels A's, B's, C's and D's one-solve-per-team designs
on the quadrotor at the edges of their blocks (A also at B=262,144), A and
B on the n=12 h_fail fixture, which shapes kernels A and D solve per team,
the folded-evaluation bank against the fused-candidate
bank, the fused flags on a problem with no tile model, a bank from numpy
inputs, and the host-sync and busy-time helpers, on a CUDA device (skipped
without one).

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
QUADROTOR = ("quadrotor", 12, 37)   # n=12, m=4
H_FAIL = (kc.H_FAIL, 12, 37)        # the quadrotor with μ = −1e6 lanes
CARTPOLE = ("cartpole", 30, 133)    # n=4, m=1
LINEAR = ("linear6x3", 20, 133)     # no tile model; A and D built for (6, 3)


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
                                       ("lqr", 7, 5), QUADROTOR, H_FAIL,
                                       CARTPOLE, LINEAR])
def test_riccati_kernel_matches_plain(device, model, T, B, variant, dtype):
    kc.check_riccati(model, T, B, dtype, device, **variant)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", kc.RICCATI_VARIANTS,
                         ids=lambda v: "-".join(k for k, b in v.items() if b)
                         or "evaluating")
@pytest.mark.parametrize("T,B", [(1, 1), (50, 8), (50, 4_099)],
                         ids=["lone-team", "one-block", "wide"])
def test_riccati_team_kernel_matches_plain(device, T, B, variant, dtype):
    """Kernel A's one-solve-per-team design on the quadrotor in every
    variant: a lone team over one step, a whole block of 8 and a wide bank
    over the bank path's 50 (a ragged block: ``QUADROTOR`` above)."""
    kc.check_riccati("quadrotor", T, B, dtype, device, **variant)
    kc.clear_caches()


def test_riccati_team_kernel_at_full_width(device):
    """The slim optimizing pass in float32 on a quadrotor bank of 262,144
    lanes (T=50), each against the plain version on its lane of the
    16,384 it repeats."""
    try:
        kc.check_riccati_wide("quadrotor", 50, 262_144, torch.float32,
                              device)
    finally:
        kc.clear_caches()
        torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype", DTYPES)
def test_riccati_design_follows_the_shape(device, dtype):
    """One solve per team, its working set in dynamic shared memory, at the
    quadrotor's (12, 4) in every variant and at (6, 3), built at its first
    use; one solve per thread at the small shapes and where m > 4."""
    from ratilqr_tpu_torch.ops.riccati_cuda import block_shared_memory
    for n, m in ((3, 2), (2, 2), (4, 1), (6, 6)):
        assert block_shared_memory(n, m, dtype)[0] == 0
    for opt in (True, False):
        for w_shared in (True, False):
            nbytes, teams, lanes = block_shared_memory(12, 4, dtype, opt,
                                                       w_shared)
            assert lanes in (16, 32) and teams * lanes % 32 == 0
            assert 0 < nbytes <= 232_448   # a block's limit on the H100
    assert block_shared_memory(6, 3, dtype)[0] > 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model,T,B", [("unicycle", 20, 133), ("lqr", 7, 5),
                                       ("negative_curvature", 7, 6),
                                       QUADROTOR, CARTPOLE])
def test_step_kernel_matches_plain(device, model, T, B, dtype):
    kc.check_step(model, T, B, dtype, device)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [1, 50])
@pytest.mark.parametrize("B", [1, 8, 37, 4_099],
                         ids=["lone-team", "one-block", "ragged", "wide"])
def test_step_team_kernel_matches_plain(device, B, T, dtype):
    """Kernel B's one-solve-per-team design on the quadrotor: a lone team,
    a whole block of 8, a ragged last block and a wide bank, over one step
    and the bank path's 50; x, value, L, dl, m_fail and h_fail.  θ from
    ``THETA_MIX``, so the θ = 1e6 lanes latch m_fail (``check_step``
    requires it)."""
    kc.check_step("quadrotor", T, B, dtype, device)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [10, 4_099])
def test_step_team_kernel_latches_h_fail(device, B, dtype):
    """The n=12 h_fail fixture (``kernel_check.H_FAIL``): the μ = −1e6
    lanes latch h_fail and not m_fail, the θ = 1e6 lanes m_fail, in
    agreement with the plain version (``check_step`` holds all three)."""
    kc.check_step(kc.H_FAIL, 50, B, dtype, device)


@pytest.mark.parametrize("dtype", DTYPES)
def test_step_design_follows_the_model(device, dtype):
    """One solve per team, with its working set in dynamic shared memory,
    on the quadrotor only; one solve per thread on the small models."""
    from ratilqr_tpu_torch.ops import tile_model
    from ratilqr_tpu_torch.ops.step_cuda import block_shared_memory
    for model_id in (tile_model.UNICYCLE, tile_model.LQR,
                     tile_model.CARTPOLE):
        assert block_shared_memory(model_id, dtype)[0] == 0
    nbytes, teams, lanes = block_shared_memory(tile_model.QUADROTOR, dtype)
    assert lanes in (16, 32) and teams * lanes % 32 == 0
    assert 0 < nbytes <= 232_448   # a block's limit on the H100
    with pytest.raises(NotImplementedError):
        block_shared_memory(99, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model,T,B", [("unicycle", 20, 133), ("lqr", 7, 5),
                                       QUADROTOR, CARTPOLE])
def test_candidate_kernel_matches_plain(device, model, T, B, dtype):
    kc.check_candidate(model, T, B, dtype, device)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [1, 50])
@pytest.mark.parametrize("B", [1, 8, 37, 4_099],
                         ids=["lone-team", "one-block", "ragged", "wide"])
def test_candidate_team_kernel_matches_plain(device, B, T, dtype):
    """Kernel C's one-solve-per-team design on the quadrotor: a lone team,
    a whole block of 8, a ragged last block and a wide bank, over one step
    and the bank path's 50; θ from ``THETA_MIX``, so the θ = 1e6 lanes
    latch m_fail (``check_candidate`` requires it)."""
    kc.check_candidate("quadrotor", T, B, dtype, device)


@pytest.mark.parametrize("dtype", DTYPES)
def test_candidate_design_follows_the_model(device, dtype):
    """One solve per team, with its working set in dynamic shared memory,
    on the quadrotor only; one solve per thread on the small models."""
    from ratilqr_tpu_torch.ops import tile_model
    from ratilqr_tpu_torch.ops.candidate_cuda import block_shared_memory
    for model_id in (tile_model.UNICYCLE, tile_model.LQR,
                     tile_model.CARTPOLE):
        assert block_shared_memory(model_id, dtype)[0] == 0
    nbytes, teams, lanes = block_shared_memory(tile_model.QUADROTOR, dtype)
    assert lanes in (16, 32) and teams * lanes % 32 == 0
    assert 0 < nbytes <= 232_448   # a block's limit on the H100
    with pytest.raises(NotImplementedError):
        block_shared_memory(99, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shared_w", [True, False])
@pytest.mark.parametrize("model,T,B", [("unicycle", 20, 133), ("lqr", 7, 5),
                                       QUADROTOR, ("quadrotor", 1, 1),
                                       ("quadrotor", 50, 4_099), CARTPOLE,
                                       LINEAR])
def test_riccati_folded_kernel_matches_plain(device, model, T, B, shared_w,
                                             dtype):
    """Kernel D on every model; on the quadrotor its one-solve-per-team
    design as a lone team over one step, and in ragged last blocks (B not
    a multiple of 8) over 12 and the bank path's 50 steps."""
    kc.check_riccati_folded(model, T, B, dtype, device, shared_w)


@pytest.mark.parametrize("dtype", DTYPES)
def test_riccati_folded_design_follows_the_shape(device, dtype):
    """One solve per team, its working set in dynamic shared memory (more
    with a per-lane noise model), at the quadrotor's n=12 and at n=6, built
    at its first use; one solve per thread at the small shapes."""
    from ratilqr_tpu_torch.ops.riccati_cuda import folded_block_shared_memory
    for n in (3, 2, 4):
        for w_shared in (True, False):
            assert folded_block_shared_memory(n, dtype, w_shared)[0] == 0
    shared, teams, lanes = folded_block_shared_memory(12, dtype)
    per_lane = folded_block_shared_memory(12, dtype, False)[0]
    assert lanes in (16, 32) and teams * lanes % 32 == 0
    assert 0 < shared < per_lane <= 232_448   # a block's limit on the H100
    assert folded_block_shared_memory(6, dtype)[0] > 0


def test_fold_path_bank_matches_fused_candidate_bank(device):
    """``fold_candidate_eval`` (kernel D, chunked ε ladder) and
    ``fused_candidate_eval`` (kernel C) evaluate the same candidates."""
    from ratilqr_tpu_torch import ILEQGConfig, make_batched_solver
    from ratilqr_tpu_torch.models import unicycle
    f64 = torch.float64
    prob = unicycle(N=20, dtype=f64, device=device, analytic_jacobians=True)
    thetas = torch.cat([torch.linspace(0.0, 0.02, 63, dtype=f64),
                        torch.tensor([1e6], dtype=f64)]).to(device)
    x0 = torch.zeros(3, dtype=f64, device=device)
    u0 = torch.zeros((20, 2), dtype=f64, device=device)
    base = dict(iter_max=20, adaptive_eps_init=True, eps_history_cap=0,
                fused_step_optimize=True)
    _build.reset_launch_counts()
    fold = make_batched_solver(prob, ILEQGConfig(
        **base, fold_candidate_eval=True, ls_chunk=4))(x0, u0, thetas)
    assert _build.launch_counts["riccati_folded"] > 0
    assert _build.launch_counts["candidate"] == 0
    fused = make_batched_solver(prob, ILEQGConfig(
        **base, fused_candidate_eval=True))(x0, u0, thetas)
    assert torch.equal(fold.failed, fused.failed)
    assert bool(fold.failed[-1]) and not bool(fold.failed[:-1].any())
    assert torch.equal(fold.iterations, fused.iterations)
    ok = ~fused.failed
    torch.testing.assert_close(fold.value[ok], fused.value[ok], rtol=1e-9,
                               atol=0)


@pytest.mark.parametrize("model", ["unicycle", "quadrotor", "cartpole"])
def test_fixtures_fail_where_they_should(device, model):
    m_fail, _ = kc.expect_fail_pattern(model, 20, 10, torch.float32, device)
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
    import dataclasses
    from ratilqr_tpu_torch.ops.step_cuda import step_optimize_bank
    no_device_model = dataclasses.replace(
        prob, tile_model=dataclasses.replace(prob.tile_model, model_id=99))
    with pytest.raises(NotImplementedError):
        step_optimize_bank(no_device_model, x0, l, theta, mu, noise)
    with pytest.raises(NotImplementedError):
        step_optimize_bank(prob, x0.half(), l.half(), theta.half(),
                           mu.half(), noise)
    from ratilqr_tpu_torch.ops.riccati_cuda import MAX_DIM, riccati_bank
    big = MAX_DIM + 1
    ap, _, _, theta, mu = kc._riccati_fixture(f"linear{big}x1", 2, 3,
                                              torch.float64, device, True)
    with pytest.raises(NotImplementedError, match=str(MAX_DIM)):
        riccati_bank(ap, theta, mu)
    kc.clear_caches()


def _linear_bank(device, config, x0=None, u0=None, thetas=None):
    import numpy as np
    from ratilqr_tpu_torch import make_batched_solver
    n, m = kc.linear_dims(LINEAR[0])
    prob = kc.make_problem(LINEAR[0], LINEAR[1], torch.float64, device)
    x0 = np.linspace(-1.0, 1.0, n) if x0 is None else x0
    u0 = np.zeros((LINEAR[1], m)) if u0 is None else u0
    thetas = np.linspace(0.0, 0.05, 33) if thetas is None else thetas
    return make_batched_solver(prob, config)(x0, u0, thetas)


@pytest.mark.parametrize("flags,path", [
    (dict(), ("riccati",)),
    (dict(fused_step_optimize=True, fused_candidate_eval=True),
     ("riccati", "riccati_folded")),
    (dict(fold_candidate_eval=True), ("riccati", "riccati_folded"))],
    ids=["default", "fused-flags", "fold"])
def test_problem_without_tile_model_runs_kernels_a_and_d(device, flags, path):
    """With no tile model the fused flags take their composition (kernels A
    and D), as JAX takes its XLA composition; results equal the CPU's."""
    from ratilqr_tpu_torch import ILEQGConfig
    _build.reset_launch_counts()
    res = _linear_bank(device, ILEQGConfig(**flags))
    launched = {k: v for k, v in _build.launch_counts.items() if v}
    assert set(launched) == set(path), launched
    cpu = _linear_bank(torch.device("cpu"), ILEQGConfig(**flags))
    assert not bool(cpu.failed.any())
    assert torch.equal(res.failed.cpu(), cpu.failed)
    assert torch.equal(res.iterations.cpu(), cpu.iterations)
    torch.testing.assert_close(res.value.cpu(), cpu.value, rtol=1e-9,
                               atol=0)


def test_bank_from_numpy_inputs_runs_on_the_problems_card(device):
    from ratilqr_tpu_torch import ILEQGConfig
    _build.reset_launch_counts()
    res = _linear_bank(device, ILEQGConfig(fused_candidate_eval=True))
    assert res.value.device.type == "cuda" and res.x.device.type == "cuda"
    assert _build.launch_counts["riccati"] > 0
    assert _build.launch_counts["riccati_folded"] > 0


def test_sync_count_and_device_busy(device):
    """The two measurements chip_smoke.py prints for the RAT iLQR path."""
    from ratilqr_tpu_torch.utils.profiling import count_host_syncs, device_busy
    x = torch.ones(1 << 20, device=device)

    def no_sync():
        x.mul_(2.0).add_(-1.0)

    def two_syncs():
        float(x.sum())
        float(x.max())

    no_sync()     # first launches outside the counted blocks
    two_syncs()
    with count_host_syncs() as none:
        no_sync()
    assert none.n == 0
    with count_host_syncs() as syncs:
        two_syncs()
    assert syncs.n == 2
    out, wall, busy = device_busy(lambda: x.cumsum(0))
    assert float(out[-1]) == float(1 << 20)
    assert 0 < busy <= wall
