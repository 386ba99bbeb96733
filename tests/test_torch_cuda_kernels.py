"""The four CUDA kernels against their plain PyTorch versions (unicycle,
LQR, the cartpole, the n=12 quadrotor, and kernels A and D at a shape built
at its first use), kernels A's, B's, C's and D's one-solve-per-team designs
on the quadrotor at the edges of their blocks (A also at B=262,144),
kernels A's, B's, C's and D's few-lane designs at n <= 4 at widths that
take each of their lanes a solve (4 and 1), kernel C's returned states
against the plain closed-loop rollout and a fused bank's against the
rollout of its controls, their fail flags on the
near-breakdown cartpole fixture (D's on the lanes float32 resolves), A and B on the n=12 h_fail fixture and on
each small model's, which shapes kernels A and D solve per team,
the folded-evaluation bank against the fused-candidate
bank, the fused flags on a problem with no tile model, a bank from numpy
inputs, the host-sync and busy-time helpers, and that every host sync of
a warm re-plan runs through one of the bank's counted sites, on a CUDA
device (skipped without one).

This file imports no JAX, so it also runs on a machine that has none:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda_kernels.py``.  ``chip_smoke.py`` makes the same
checks at the main path's shapes.
"""
from typing import NamedTuple

import pytest

torch = pytest.importorskip("torch")

from ratilqr_tpu_torch import kernel_check as kc  # noqa: E402
from ratilqr_tpu_torch.ops import _build, tile_model  # noqa: E402

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.float64]
QUADROTOR = ("quadrotor", 12, 37)   # n=12, m=4
H_FAIL = (kc.H_FAIL, 12, 37)        # the quadrotor with μ = −1e6 lanes
CARTPOLE = ("cartpole", 30, 133)    # n=4, m=1
LINEAR = ("linear6x3", 20, 133)     # no tile model; A and D built for (6, 3)
# Kernels B's and C's float32 fail flags disagreed with the plain
# version's on a near-breakdown lane of this fixture (θ = 0.05, lane
# 1062) before the contraction policy (csrc/smallmat.cuh).
FLAG_CASE = ("cartpole", 20, 33_793)


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
                                       CARTPOLE, LINEAR,
                                       ("linear4x4", 20, 133)])
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
    """At the small shipped shapes one solve per team of 4 lanes, 32 a
    block, up to SMs x 128 lanes (512 threads an SM, the rule kernels B and
    C share), and of 1 lane, 64 a block, above; at 4 lanes each step read
    into registers up to SMs x 64 lanes and staged in shared memory above
    (float64 (4, 1), whose step is too large for registers, stages at every
    width); one solve per team of 16 lanes, its working set in dynamic
    shared memory, at the quadrotor's (12, 4) in every variant and at
    (6, 3), built at its first use; one solve per thread where m > 4."""
    from ratilqr_tpu_torch.ops.riccati_cuda import (block_shared_memory,
                                                    first_widths,
                                                    launch_bands)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, m in ((3, 2), (2, 2), (4, 1)):
        always = (n, m) == (4, 1) and dtype == torch.float64
        for opt in (True, False):
            for w_shared in (True, False):
                assert first_widths(n, m, dtype, opt, w_shared) == {
                    4: 1, 1: sms * 128 + 1}
                bands = launch_bands(n, m, dtype, opt, w_shared)
                assert bands == ({(4, True): 1, (1, True): sms * 128 + 1}
                                 if always else
                                 {(4, False): 1, (4, True): sms * 64 + 1,
                                  (1, False): sms * 128 + 1})
                nbytes, solves, lanes = block_shared_memory(
                    n, m, dtype, sms * 64 + 1, opt, w_shared)
                assert (solves, lanes) == (32, 4)
                assert 0 < nbytes <= 232_448   # a block's limit on the H100
                nbytes, solves, lanes = block_shared_memory(
                    n, m, dtype, 262_144, opt, w_shared)
                assert (solves, lanes) == (64, 1)
                assert 0 <= nbytes <= 232_448
    assert block_shared_memory(6, 6, dtype) == (0, 128, 1)
    for opt in (True, False):
        for w_shared in (True, False):
            nbytes, teams, lanes = block_shared_memory(12, 4, dtype, 1, opt,
                                                       w_shared)
            assert lanes in (16, 32) and teams * lanes % 32 == 0
            assert 0 < nbytes <= 232_448   # a block's limit on the H100
    assert block_shared_memory(6, 3, dtype)[0] > 0


SMALL_A = {"unicycle": (3, 2), "lqr": (2, 2), "cartpole": (4, 1)}
VARIANT_IDS = ["-".join(k for k, b in v.items() if b) or "evaluating"
               for v in kc.RICCATI_VARIANTS]
OPTIMIZING = [v for v in kc.RICCATI_VARIANTS if v["optimizing"]]


def _one_lane_width(model, dtype):
    """The first width at which kernel A's launch at the model's (n, m)
    takes one lane a solve on this card, from the launch's own query."""
    from ratilqr_tpu_torch.ops.riccati_cuda import first_widths
    return first_widths(*SMALL_A[model], dtype)[1]


def _staged_width(model, dtype):
    """The first width at which kernel A's launch at the model's (n, m)
    stages its steps at 4 lanes a solve on this card (1 where every width
    stages), from the launch's own query."""
    from ratilqr_tpu_torch.ops.riccati_cuda import launch_bands
    return launch_bands(*SMALL_A[model], dtype)[4, True]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", kc.RICCATI_VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("model,T", [("unicycle", 20), ("lqr", 7),
                                     ("cartpole", 30)])
def test_riccati_small_kernel_at_staged_width(device, model, T, variant,
                                              dtype):
    """Kernel A at n, m <= 4 at the first width whose launch stages each
    step in shared memory at 4 lanes a solve, every variant."""
    try:
        kc.check_riccati(model, T, _staged_width(model, dtype), dtype,
                         device, **variant)
    finally:
        kc.clear_caches()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", kc.RICCATI_VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("model,T", [("unicycle", 20), ("lqr", 7),
                                     ("cartpole", 30)])
def test_riccati_small_kernel_at_one_lane_width(device, model, T, variant,
                                                dtype):
    """Kernel A at n, m <= 4 at the first width whose launch takes 1 lane a
    solve (4 lanes: ``test_riccati_kernel_matches_plain``), every variant;
    θ from ``THETA_MIX``, so the θ = 1e6 lanes latch m_fail."""
    try:
        kc.check_riccati(model, T, _one_lane_width(model, dtype), dtype,
                         device, **variant)
    finally:
        kc.clear_caches()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", OPTIMIZING,
                         ids=[i for i, v in zip(VARIANT_IDS,
                                                kc.RICCATI_VARIANTS)
                              if v["optimizing"]])
@pytest.mark.parametrize("band", ["direct", "staged", "one-lane"])
@pytest.mark.parametrize("model", list(SMALL_A))
def test_riccati_small_kernel_latches_h_fail(device, model, band, variant,
                                             dtype):
    """Each small model's h_fail fixture at a width taking 4 lanes a solve
    (37), at the first that stages its steps and at the first taking 1
    lane: the μ = −1e6 lanes latch h_fail and not m_fail, the θ = 1e6
    lanes m_fail, as in the plain version."""
    B = {"direct": lambda: 37, "staged": lambda: _staged_width(model, dtype),
         "one-lane": lambda: _one_lane_width(model, dtype)}[band]()
    try:
        kc.check_riccati(kc.h_fail_fixture(model), 20, B, dtype, device,
                         **variant)
    finally:
        kc.clear_caches()


@pytest.mark.parametrize("optimizing", [True, False],
                         ids=["optimizing", "evaluating"])
def test_riccati_near_breakdown_flag_cartpole(device, optimizing):
    """Kernel A's slim pass on the cartpole at T=20, B=33,793 in float32
    (one lane a solve): its m_fail and h_fail equal the plain version's
    and the float64 plain version's on every lane."""
    from ratilqr_tpu_torch.ops.riccati_cuda import riccati_bank
    variant = dict(optimizing=optimizing, slim=True, shared_w=True,
                   has_dl=False)
    try:
        kc.check_riccati(*FLAG_CASE, torch.float32, device, **variant)
        ap, _, _, theta, mu = kc._riccati_fixture(*FLAG_CASE, torch.float32,
                                                  device, True)
        L_in, dl_in, _, ref = kc._riccati_plain(
            *FLAG_CASE, torch.float32, device, True, optimizing, False)
        got = riccati_bank(ap, theta, mu, L_in, dl_in, slim=True)
        assert torch.equal(got.m_fail, ref.m_fail)
        assert torch.equal(got.h_fail, ref.h_fail)
    finally:
        kc.clear_caches()


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


SMALL_C = {"unicycle": tile_model.UNICYCLE, "lqr": tile_model.LQR,
           "cartpole": tile_model.CARTPOLE}


@pytest.mark.parametrize("dtype", DTYPES)
def test_step_design_follows_the_model(device, dtype):
    """One solve per team of 16 lanes, with its working set in dynamic
    shared memory, on the quadrotor; on the small models, with no shared
    memory, one solve per team of 4 lanes, 32 a block, up to SMs x 128
    lanes (512 threads an SM, the rule kernel C shares), and of 1 lane, 64
    a block, above."""
    from ratilqr_tpu_torch.ops import candidate_cuda
    from ratilqr_tpu_torch.ops.step_cuda import (block_shared_memory,
                                                 first_widths)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for model_id in SMALL_C.values():
        assert first_widths(model_id, dtype) == {4: 1, 1: sms * 128 + 1}
        assert first_widths(model_id, dtype) == candidate_cuda.first_widths(
            model_id, dtype)
        assert block_shared_memory(model_id, dtype, 1) == (0, 32, 4)
        assert block_shared_memory(model_id, dtype, 262_144) == (0, 64, 1)
    nbytes, teams, lanes = block_shared_memory(tile_model.QUADROTOR, dtype, 1)
    assert lanes in (16, 32) and teams * lanes % 32 == 0
    assert 0 < nbytes <= 232_448   # a block's limit on the H100
    with pytest.raises(NotImplementedError):
        block_shared_memory(99, dtype, 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lanes", [4, 1])
@pytest.mark.parametrize("model,T", [("unicycle", 20), ("lqr", 7),
                                     ("cartpole", 30)])
def test_step_small_kernel_at_each_lane_width(device, model, T, lanes,
                                              dtype):
    """Kernel B at n <= 4 at a width whose launch takes 4 lanes a solve (a
    ragged 133) or 1 (the first such width on this card, from the
    launch's own query); θ from ``THETA_MIX``, so the θ = 1e6 lanes latch
    m_fail."""
    from ratilqr_tpu_torch.ops.step_cuda import first_widths
    B = 133 if lanes == 4 else first_widths(SMALL_C[model], dtype)[1]
    kc.check_step(model, T, B, dtype, device)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lanes", [4, 1])
@pytest.mark.parametrize("model", list(SMALL_C))
def test_step_small_kernel_latches_h_fail(device, model, lanes, dtype):
    """Each small model's h_fail fixture at a width taking 4 lanes a solve
    and at the first taking 1: the μ = −1e6 lanes latch h_fail and not
    m_fail, the θ = 1e6 lanes m_fail, as in the plain version."""
    from ratilqr_tpu_torch.ops.step_cuda import first_widths
    B = 37 if lanes == 4 else first_widths(SMALL_C[model], dtype)[1]
    kc.check_step(kc.h_fail_fixture(model), 20, B, dtype, device)


def test_step_near_breakdown_flag_cartpole(device):
    """Kernel B on the cartpole at T=20, B=33,793 in float32 (one lane a
    solve): its m_fail and h_fail flags equal the plain version's."""
    kc.check_step(*FLAG_CASE, torch.float32, device)


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
@pytest.mark.parametrize("lanes", [4, 1])
@pytest.mark.parametrize("model,T", [("unicycle", 20), ("lqr", 7),
                                     ("cartpole", 30)])
def test_candidate_small_kernel_at_each_lane_width(device, model, T, lanes,
                                                   dtype):
    """Kernel C at n <= 4 at a width whose launch takes 4 lanes a solve (a
    ragged 133) or 1 (the first such width on this card, from the
    launch's own query); θ from ``THETA_MIX``, so the θ = 1e6 lanes latch
    m_fail."""
    from ratilqr_tpu_torch.ops.candidate_cuda import first_widths
    B = 133 if lanes == 4 else first_widths(SMALL_C[model], dtype)[1]
    kc.check_candidate(model, T, B, dtype, device)


class _States(NamedTuple):
    x: torch.Tensor        # (B, T+1, n)
    m_fail: torch.Tensor   # (B,): no lane failed


def _assert_states_close(x, want, ref, theta, dtype):
    """``x`` against the plain rollout ``want`` by ``kernel_check``'s
    trajectory tolerance, in float32 with the drift rule against its
    float64 run ``ref``."""
    none = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    kc._compare(_States(x, none), _States(want, none),
                None if ref is None else _States(ref, none), theta,
                [("x", "traj")], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model,T,lanes", [
    ("quadrotor", 50, 16), ("unicycle", 20, 4), ("unicycle", 20, 1),
    ("cartpole", 30, 4), ("cartpole", 30, 1)])
def test_candidate_kernel_states_are_its_closed_loop_rollout(
        device, model, T, lanes, dtype):
    """Kernel C returns the states it rolled out: ``rollout_feedback`` of
    the same ``l_cand``, ``L`` and ``x_ref``, on the quadrotor's team design
    and at n <= 4 at a width of 4 lanes a solve (a ragged 133) and of 1 (the
    first such width on this card)."""
    from ratilqr_tpu_torch.ops.candidate_cuda import (candidate_bank,
                                                      first_widths)
    from ratilqr_tpu_torch.ops.rollout import rollout_feedback
    B = (4_099 if model == "quadrotor" else 133 if lanes == 4
         else first_widths(SMALL_C[model], dtype)[1])
    prob, x_ref, l, L, mu, theta, noise = kc.candidate_inputs(
        model, T, B, dtype, device)
    got = candidate_bank(prob, x_ref, l, L, mu, theta, noise)
    assert got.x.shape == (B, T + 1, x_ref.shape[-1])
    want, _ = rollout_feedback(prob, x_ref, l, L)
    ref = None
    if dtype == torch.float32:
        prob64, _ = kc._problem64(model, T, device)
        ref, _ = rollout_feedback(prob64, *map(kc._f64, (x_ref, l, L)))
    _assert_states_close(got.x, want, ref, theta, dtype)
    kc.clear_caches()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model,n,m,T", [("unicycle", 3, 2, 30),
                                         ("quadrotor", 12, 4, 50)])
def test_fused_bank_returns_the_rollout_of_its_controls(device, model, n, m,
                                                        T, dtype):
    """A fused bank's ``x`` is the open-loop rollout of its ``l`` from
    ``x0``, taken from kernel C's states with no plain rollout."""
    from ratilqr_tpu_torch import ILEQGConfig, models
    from ratilqr_tpu_torch.ops.rollout import rollout_open_loop
    from ratilqr_tpu_torch.solvers.ileqg import make_batched_solver
    from ratilqr_tpu_torch.utils import profiling
    prob = getattr(models, model)(N=T, dtype=dtype, device=device)
    bank = make_batched_solver(prob, ILEQGConfig(
        fused_step_optimize=True, fused_candidate_eval=True,
        adaptive_eps_init=True, eps_history_cap=0))
    thetas = torch.linspace(0.0, 0.01, 1024, dtype=dtype, device=device)
    x0 = torch.full((n,), 0.1, dtype=dtype, device=device)
    profiling.reset_counters()
    res = bank(x0, torch.zeros(T, m, dtype=dtype, device=device), thetas)
    assert profiling.counters["rollouts_reused"] == (
        profiling.counters["iterations"] + 1)
    assert profiling.counters["rollouts_run"] == 0
    x0s = x0.expand(thetas.shape[0], n)
    want = rollout_open_loop(prob, x0s, res.l)
    ref = None
    if dtype == torch.float32:
        prob64 = getattr(models, model)(N=T, dtype=torch.float64,
                                        device=device)
        ref = rollout_open_loop(prob64, x0s.double(), res.l.double())
    _assert_states_close(res.x, want, ref, thetas, dtype)


def test_candidate_near_breakdown_flag_cartpole(device):
    """Kernel C on the cartpole at T=20, B=33,793 in float32 (one lane a
    solve): its fail flags equal the plain version's."""
    kc.check_candidate(*FLAG_CASE, torch.float32, device)


@pytest.mark.parametrize("dtype", DTYPES)
def test_candidate_design_follows_the_model(device, dtype):
    """One solve per team of 16 lanes, with its working set in dynamic
    shared memory, on the quadrotor; on the small models one solve per team
    of 4 lanes, 32 a block, with staged steps in shared memory, up to SMs x
    128 lanes (512 threads an SM), and of 1 lane, 64 a block, with none,
    above."""
    from ratilqr_tpu_torch.ops.candidate_cuda import (block_shared_memory,
                                                      first_widths)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for model_id in SMALL_C.values():
        assert first_widths(model_id, dtype) == {4: 1, 1: sms * 128 + 1}
        nbytes, solves, lanes = block_shared_memory(model_id, dtype, 1)
        assert (solves, lanes) == (32, 4) and 0 < nbytes <= 48 * 1024
        assert block_shared_memory(model_id, dtype, 262_144) == (0, 64, 1)
    nbytes, teams, lanes = block_shared_memory(tile_model.QUADROTOR, dtype, 1)
    assert lanes in (16, 32) and teams * lanes % 32 == 0
    assert 0 < nbytes <= 232_448   # a block's limit on the H100
    with pytest.raises(NotImplementedError):
        block_shared_memory(99, dtype, 1)


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
    """At the small shipped n one solve per team of 4 lanes, 32 a block,
    up to SMs x 128 lanes (512 threads an SM, the rule of kernels A, B and
    C), each step read into registers, no shared memory, and one solve per
    thread, 128 a block, above; one solve per team, its working set in
    dynamic shared memory (more with a per-lane noise model), at the
    quadrotor's n=12 and at n=6, built at its first use."""
    from ratilqr_tpu_torch.ops.riccati_cuda import (
        folded_block_shared_memory, folded_first_widths)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n in (3, 2, 4):
        for w_shared in (True, False):
            assert folded_first_widths(n, dtype, w_shared) == {
                4: 1, 1: sms * 128 + 1}
            for B in (1, sms * 128, sms * 128 + 1, 262_144):
                assert folded_block_shared_memory(n, dtype, w_shared, B) == (
                    (0, 32, 4) if B <= sms * 128 else (0, 128, 1))
    shared, teams, lanes = folded_block_shared_memory(12, dtype)
    per_lane = folded_block_shared_memory(12, dtype, False)[0]
    assert lanes in (16, 32) and teams * lanes % 32 == 0
    assert 0 < shared < per_lane <= 232_448   # a block's limit on the H100
    assert folded_block_shared_memory(6, dtype)[0] > 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shared_w", [True, False])
@pytest.mark.parametrize("model,T", [("unicycle", 20), ("lqr", 7),
                                     ("cartpole", 30)])
def test_riccati_folded_small_kernel_at_band_widths(device, model, T,
                                                    shared_w, dtype):
    """Kernel D at n <= 4 at the first width of its launch that takes 1
    lane a solve."""
    from ratilqr_tpu_torch.ops.riccati_cuda import folded_first_widths
    B = folded_first_widths(SMALL_A[model][0], dtype, shared_w)[1]
    try:
        kc.check_riccati_folded(model, T, B, dtype, device, shared_w)
    finally:
        kc.clear_caches()


def test_riccati_folded_near_breakdown_flag_cartpole(device):
    """Kernel D on the cartpole at T=20, B=33,793 in float32 (one lane a
    solve): its m_fail equals the float64 plain version's on every lane
    that float32 resolves (``kernel_check.check_folded_flags``); of the
    others, at most one in 10,000, none is compared."""
    try:
        kc.check_folded_flags(*FLAG_CASE, device)
    finally:
        kc.clear_caches()


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


@pytest.mark.parametrize("model,n,m,T", [("unicycle", 3, 2, 30),
                                         ("quadrotor", 12, 4, 50)])
def test_every_host_sync_of_a_replan_has_a_site(device, model, n, m, T):
    """Over one warm re-plan of a fused bank (the benchmark's solver
    settings), the bank's sync sites (``profiling.counters["sync.*"]``)
    and the two fetches of its value and flags are every host sync
    PyTorch's sync debug mode reports."""
    from ratilqr_tpu_torch import ILEQGConfig, models
    from ratilqr_tpu_torch.solvers.ileqg import make_batched_solver
    from ratilqr_tpu_torch.utils import profiling
    prob = getattr(models, model)(N=T, dtype=torch.float32, device=device)
    bank = make_batched_solver(prob, ILEQGConfig(
        fused_step_optimize=True, fused_candidate_eval=True,
        adaptive_eps_init=True, eps_history_cap=0))
    thetas = torch.linspace(0.0, 0.01, 1024, device=device)
    x0 = torch.zeros(n, device=device)
    u_warm = bank(x0, torch.zeros(T, m, device=device), thetas).l[0]
    bank(x0 + 1e-5, u_warm, thetas).value.cpu()   # first warm re-plan
    x1 = x0 - 1e-5
    profiling.reset_counters()
    with profiling.count_host_syncs() as syncs:
        res = bank(x1, u_warm, thetas)
        res.value.cpu(), res.failed.cpu()
    sites = {k: v for k, v in profiling.counters.items()
             if k.startswith("sync.")}
    assert profiling.counters["iterations"] >= 1
    assert sum(sites.values()) + 2 == syncs.n, sites
