"""Hold each CUDA kernel against its plain PyTorch version on one device.

Used by ``chip_smoke.py`` (at the main path's shapes) and by
``tests/test_torch_cuda_kernels.py`` (at small shapes).  Every check builds
its inputs from a seed on the target device, runs the kernel wrapper and
the plain function of the same signature on the same tensors, and raises
``AssertionError`` on any disagreement.  Fail flags must be equal; floats
are compared on the lanes that did not fail, with the tolerances below:

  - float32: those of the JAX kernel tests — value rtol 3e-5; gains,
    offsets and the other per-step outputs rtol 1e-4, atol 1e-5;
    trajectories rtol 1e-5, atol 1e-6 — with each lane's absolute
    tolerance raised to 16 times the plain version's own largest float32
    error, against its float64 run on the same inputs, among the lanes of
    the same θ (see :func:`_compare`);
  - float64: rtol 1e-10 (atol 1e-10 on near-zero entries).

Each check returns an :class:`Agreement`: the largest kernel-vs-plain
difference, the largest float32 error of the plain version against
float64, and the largest ratio of a difference to what the tolerance
allowed there.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ratilqr_tpu_torch.models import cartpole, lqr_problem, quadrotor, unicycle
from ratilqr_tpu_torch.ops import smallmat
from ratilqr_tpu_torch.ops.approx import (Approximation, FoldedApprox,
                                          NoiseModel, approximate_folded,
                                          approximate_model, noise_model)
from ratilqr_tpu_torch.ops.candidate_cuda import (candidate_bank,
                                                  candidate_bank_plain,
                                                  candidate_layout,
                                                  launch_candidate)
from ratilqr_tpu_torch.ops.riccati_cuda import (BankFolded, BankSlim,
                                                folded_layout,
                                                launch_folded, launch_riccati,
                                                riccati_bank,
                                                riccati_bank_folded,
                                                riccati_bank_folded_plain,
                                                riccati_bank_plain,
                                                riccati_layout)
from ratilqr_tpu_torch.ops.rollout import (rollout_open_loop,
                                           rollout_open_loop_with_jac)
from ratilqr_tpu_torch.ops.step_cuda import (launch_step, step_layout,
                                             step_optimize_bank,
                                             step_optimize_bank_plain)
from ratilqr_tpu_torch.ops.tile_model import lqr_tile_model
from ratilqr_tpu_torch.problems import RiskSensitiveProblem

THETA_MIX = (0.0, 0.01, 0.05, 1e6, 0.02)   # the 1e6 lanes must fail M
MU_MIX = (0.0, 0.0, 1e-3, 0.0, 1e-2)
# The h_fail fixtures: a model with THETA_MIX and this μ mix, so every
# other θ = 0 lane carries μ = −1e6.  There H = R + BᵀDSB + μI fails at the
# first backward step while M = W⁻¹ does not: those lanes must latch h_fail
# and not m_fail, and the θ = 1e6 lanes m_fail.  H_FAIL is the n=12 one
# (the quadrotor); h_fail_fixture(model) names any model's.
H_FAIL_SUFFIX = "_h_fail"
H_FAIL = "quadrotor" + H_FAIL_SUFFIX
H_FAIL_MU = -1e6
H_FAIL_MU_MIX = (H_FAIL_MU, 0.0, 1e-3, 0.0, 1e-2, 0.0, 0.0, 1e-3, 0.0, 1e-2)

TOL = {
    torch.float32: {"value": dict(rtol=3e-5, atol=0.0),
                    "gain": dict(rtol=1e-4, atol=1e-5),
                    "traj": dict(rtol=1e-5, atol=1e-6)},
    torch.float64: {"value": dict(rtol=1e-10, atol=1e-10),
                    "gain": dict(rtol=1e-10, atol=1e-10),
                    "traj": dict(rtol=1e-10, atol=1e-10)},
}


# Measured on an H100 80GB HBM3 (700 W) at B = 4,099: on the worst LQR
# candidate lane (θ = 0.05, near breakdown) the kernel's float32 value sat
# 10x farther from float64 than the plain version's (2.3e-2 against
# 2.3e-3 on a value of 192); across the θ = 0.05 lanes the kernel was the
# worse of the two by 4x on 110 lanes and the better by 4x on 91.
F32_DRIFT_FACTOR = 16.0
# A lane whose M, in the float64 plain pass, comes within this share of
# W⁻¹'s scale of singular (16 times float32's unit roundoff, 6e-8, with
# which M's entries are rounded) is near neurotic breakdown beyond what a
# float32 evaluation resolves: its float32 m_fail is its roundings' draw.
F32_UNRESOLVED = 1e-6


def random_linear_arrays(n: int, m: int, seed: int = 0):
    """The numpy arrays of :func:`random_linear`: ``A (n, n)`` near the
    identity with spectral radius about 1, ``B (n, m)``, and the diagonal
    stage, control and terminal weights ``q (n,)``, ``r (m,)``, ``qf
    (n,)``, all from ``seed``."""
    rng = np.random.default_rng(seed + 1000 * n + m)
    A = 0.95 * np.eye(n) + 0.1 * rng.standard_normal((n, n)) / np.sqrt(n)
    B = 0.3 * rng.standard_normal((n, m))
    q = rng.uniform(0.5, 1.5, n)
    r = rng.uniform(0.5, 1.5, m)
    qf = rng.uniform(5.0, 15.0, n)
    return dict(A=A, B=B, q=q, r=r, qf=qf)


def random_linear(n: int, m: int, T: int, dtype, device, noise: float = 1e-3,
                  seed: int = 0) -> RiskSensitiveProblem:
    """A seeded linear problem with no tile model: ``x' = A x + B u``,
    ``c = ½ Σ q x² + ½ Σ r u²``, ``h = ½ Σ qf x²``, ``W = noise·I``, from
    :func:`random_linear_arrays` (the tests build the same problem in JAX
    from the same arrays).  On CUDA it runs kernels A and D at ``(n, m)``
    and nothing else."""
    a = {k: torch.as_tensor(v, dtype=dtype, device=device)
         for k, v in random_linear_arrays(n, m, seed).items()}
    W = noise * torch.eye(n, dtype=dtype, device=device)
    return RiskSensitiveProblem(
        f=lambda x, u: a["A"] @ x + a["B"] @ u,
        c=lambda k, x, u: 0.5 * (x @ (a["q"] * x)) + 0.5 * (u @ (a["r"] * u)),
        h=lambda x: 0.5 * (x @ (a["qf"] * x)), W=lambda k: W, N=T)


def h_fail_fixture(model: str) -> str:
    """The name of ``model``'s h_fail fixture (:data:`H_FAIL` for the
    quadrotor)."""
    return model + H_FAIL_SUFFIX


def _is_h_fail(model: str) -> bool:
    return model.endswith(H_FAIL_SUFFIX)


def linear_dims(model: str):
    """``(n, m)`` of a ``linear<n>x<m>`` model name, else None."""
    if not model.startswith("linear"):
        return None
    n, m = model[len("linear"):].split("x")
    return int(n), int(m)


def model_dims(model: str, T: int = 1):
    """``(n, m)`` of a model of :func:`make_problem`."""
    dims = linear_dims(model)
    if dims is not None:
        return dims
    tm = make_problem(model, T, torch.float64, "cpu").tile_model
    return tm.n, tm.m


def make_problem(model: str, T: int, dtype, device) -> RiskSensitiveProblem:
    """``unicycle``, ``lqr``, ``cartpole``, ``quadrotor`` (each also as
    its h_fail fixture, :func:`h_fail_fixture`, whose lanes differ only
    in μ), or
    ``negative_curvature`` — the restart- and h_fail-forcing fixture of
    tests/test_step_fused.py (control cost −0.05·u·u, terminal cost
    0.005·x·x), all with device models; or ``linear<n>x<m>``, the
    :func:`random_linear` problem at (n, m), with no tile model (kernels A
    and D only)."""
    dims = linear_dims(model)
    if dims is not None:
        return random_linear(*dims, T, dtype, device)
    if _is_h_fail(model):
        model = model[:-len(H_FAIL_SUFFIX)]
    if model == "unicycle":
        return unicycle(N=T, dtype=dtype, device=device)
    if model == "cartpole":
        return cartpole(N=T, dtype=dtype, device=device)
    if model == "quadrotor":
        return quadrotor(N=T, dtype=dtype, device=device)
    if model == "lqr":
        return lqr_problem(N=T, noise=0.5, dtype=dtype, device=device)
    if model == "negative_curvature":
        W = 0.01 * torch.eye(2, dtype=dtype, device=device)
        return RiskSensitiveProblem(
            f=lambda x, u: x + u,
            c=lambda k, x, u: 0.5 * (x @ x) - 0.05 * (u @ u),
            h=lambda x: 0.005 * (x @ x), W=lambda k: W, N=T,
            tile_model=lqr_tile_model(u_weight=-0.05, term_weight=0.01))
    raise ValueError(model)


def lane_mix(values, B: int, dtype, device) -> torch.Tensor:
    return torch.tensor(np.resize(np.asarray(values), B), dtype=dtype,
                        device=device)


def bank_inputs(model: str, T: int, B: int, dtype, device, seed: int = 0):
    """Seeded ``(problem, x0 (B, n), l (B, T, m), L (B, T, m, n), theta,
    mu, noise)`` for a model."""
    prob = make_problem(model, T, dtype, device)
    n, m = model_dims(model)
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rand(*shape, scale):
        return (scale * torch.randn(shape, generator=g, dtype=torch.float64)
                ).to(dtype=dtype, device=device)

    x0 = rand(B, n, scale=0.1 if model != "negative_curvature" else 1.0)
    l = rand(B, T, m, scale=0.1)
    L = rand(B, T, m, n, scale=0.1)
    if model == "negative_curvature":
        theta = torch.zeros(B, dtype=dtype, device=device)
        mu = torch.zeros(B, dtype=dtype, device=device)
    else:
        theta = lane_mix(THETA_MIX, B, dtype, device)
        mu = lane_mix(H_FAIL_MU_MIX if _is_h_fail(model) else MU_MIX, B, dtype,
                      device)
    return prob, x0, l, L, theta, mu, noise_model(prob, T, dtype, device)


class Agreement(NamedTuple):
    """What one kernel-vs-plain check found."""
    err: float         # largest |kernel − plain|
    plain_err: float   # largest float32 error of the plain version vs f64
    ratio: float       # largest |kernel − plain| / allowed


def _close(name: str, got, want, lanes, rtol: float, atol
           ) -> Tuple[float, float]:
    """``|got − want| ≤ atol + rtol·|want|`` elementwise on ``lanes``, with
    ``atol`` per lane ``(B,)``; returns (max |got − want|, max |got −
    want| / allowed) there.  A NaN on either side is a mismatch."""
    got, want = got[lanes].double(), want[lanes].double()
    if not got.numel():
        return 0.0, 0.0
    atol = atol[lanes].reshape((-1,) + (1,) * (got.dim() - 1))
    diff = (got - want).abs()
    allowed = atol + rtol * want.abs()
    bad = ~(diff <= allowed)
    if bool(bad.any()):
        excess = torch.where(bad, diff - allowed, torch.zeros_like(diff))
        i = int(excess.nan_to_num(float("inf")).flatten().argmax())
        lane = int(lanes.nonzero().flatten()[i // max(1, diff[0].numel())])
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements differ; "
            f"worst |kernel − plain| {float(diff.flatten()[i]):.3e} against "
            f"{float(allowed.flatten()[i]):.3e} allowed, on lane {lane}")
    ratio = torch.where(diff > 0, diff / allowed, torch.zeros_like(diff))
    return float(diff.max()), float(ratio.max())


def _flags(name: str, got, want) -> None:
    if not torch.equal(got, want):
        bad = (got != want).nonzero().flatten()[:8].tolist()
        raise AssertionError(f"{name} differs on lanes {bad}")


def _failed(out):
    h_fail = getattr(out, "h_fail", None)
    return out.m_fail if h_fail is None else out.m_fail | h_fail


def _drift_atol(want, ref, lanes, theta, atol: float):
    """Per-lane absolute tolerance ``(B,)``: ``atol``, raised on each class
    of lanes that share one θ to ``F32_DRIFT_FACTOR`` times the largest
    error of the plain float32 output ``want`` against its float64 run
    ``ref`` in that class.  Returns (tolerance, largest plain error)."""
    err = (want.double() - ref).abs().reshape(want.shape[0], -1).amax(1)
    err = torch.where(lanes, err, torch.zeros_like(err))
    tol = torch.full_like(err, atol)
    for th in theta.unique():
        cls = theta == th
        tol[cls] = max(atol, F32_DRIFT_FACTOR * float(err[cls].max()))
    return tol, float(err.max())


def _compare(got, want, ref, theta, fields, dtype) -> Agreement:
    """Kernel output ``got`` against the plain output ``want``: fail flags
    equal on every lane, each ``(name, kind)`` field within ``TOL[dtype]
    [kind]`` on the lanes that did not fail.

    ``ref`` is the plain version run in float64 on the same (float32)
    inputs, or None.  In float32 a 100-step recursion, the risk term's
    −(logdet W + logdet M)/(2θ) at small θ (two nearly opposite logs over
    2θ), and a lane close to neurotic breakdown (M nearly singular) all
    amplify rounding: two float32 evaluations in different operation
    orders (the kernel's fused multiply-adds, the plain version's separate
    roundings) may then each sit as far from the exact result as the lane's
    conditioning allows.  So with ``ref`` each lane's absolute tolerance is
    at least ``F32_DRIFT_FACTOR`` times the plain version's own largest
    float32 error against float64 among the lanes of the same θ
    (:func:`_drift_atol`).  Returns the :class:`Agreement`."""
    for flag in ("m_fail", "h_fail"):
        if hasattr(want, flag):
            _flags(flag, getattr(got, flag), getattr(want, flag))
    ok = ~_failed(want)
    if ref is not None:
        ok = ok & ~_failed(ref)
    err = plain_err = ratio = 0.0
    for name, kind in fields:
        lanes = torch.ones_like(ok) if kind == "traj" else ok
        rtol, atol = TOL[dtype][kind]["rtol"], TOL[dtype][kind]["atol"]
        want_f = getattr(want, name)
        tol = torch.full(lanes.shape, atol, dtype=torch.float64,
                         device=lanes.device)
        if ref is not None:
            tol, drift = _drift_atol(want_f, getattr(ref, name), lanes,
                                     theta, atol)
            plain_err = max(plain_err, drift)
        e, r = _close(name, getattr(got, name), want_f, lanes, rtol, tol)
        err, ratio = max(err, e), max(ratio, r)
    return Agreement(err, plain_err, ratio)


def _f64(x):
    return None if x is None else x.double()


def per_lane_noise(noise: NoiseModel, B: int):
    """A different noise model on every lane: W scaled by 1, 1.5, 2, ..."""
    scale = 1.0 + 0.5 * (torch.arange(B, device=noise.W.device) % 3)
    W = noise.W[None] * scale.to(noise.W.dtype)[:, None, None, None]
    chol = smallmat.cholesky(W)
    return W, smallmat.cho_inverse(chol), smallmat.cho_logdet(chol)


@functools.lru_cache(maxsize=2)
def _riccati_fixture(model: str, T: int, B: int, dtype, device,
                     shared_w: bool):
    """Seeded approximation stack (shared or per-lane noise model) and the
    inputs of kernel A's checks."""
    prob, x0, l, L, theta, mu, noise = bank_inputs(model, T, B, dtype,
                                                   device)
    x, A, Bm = rollout_open_loop_with_jac(prob, x0, l)
    ap = approximate_model(prob, l, x, A, Bm, noise)
    if not shared_w:
        W, W_inv, logdet_W = per_lane_noise(noise, B)
        ap = ap._replace(W=W, W_inv=W_inv, logdet_W=logdet_W)
    return ap, l, L, theta, mu


@functools.lru_cache(maxsize=6)
def _riccati_plain(model: str, T: int, B: int, dtype, device,
                   shared_w: bool, optimizing: bool, has_dl: bool):
    """``(L_in, dl_in, plain full output, its float64 run or None)`` of one
    kernel A case; the slim and full variants share it."""
    ap, l, L, theta, mu = _riccati_fixture(model, T, B, dtype, device,
                                           shared_w)
    L_in = dl_in = None
    if not optimizing:
        opt = _riccati_plain(model, T, B, dtype, device, shared_w, True,
                             False)[2]
        L_in = opt.L.nan_to_num() + 0.05 * L
        dl_in = 0.05 * l if has_dl else None
    want = riccati_bank_plain(ap, theta, mu, L_in, dl_in)
    ref = None
    if dtype == torch.float32:
        ref = riccati_bank_plain(Approximation(*map(_f64, ap)), _f64(theta),
                                 _f64(mu), _f64(L_in), _f64(dl_in))
    return L_in, dl_in, want, ref


def clear_caches() -> None:
    """Free the fixtures and plain outputs kernels A's and D's checks
    keep."""
    _riccati_plain.cache_clear()
    _riccati_fixture.cache_clear()
    _folded_fixture.cache_clear()


def _slim(full, optimizing: bool):
    """The slim output :func:`riccati_bank_plain` gives for ``full``."""
    L, dl = (full.L, full.dl) if optimizing else (None, None)
    return BankSlim(full.value, L, dl, full.m_fail, full.h_fail)


def _check_latching(model: str, want, theta, mu, h_fail: bool) -> None:
    """Every θ = 1e6 lane latched m_fail; with ``h_fail``, on
    an h_fail fixture every μ = −1e6 lane latched h_fail and not m_fail."""
    if not bool(want.m_fail[theta == 1e6].all()):
        raise AssertionError("a θ = 1e6 lane did not latch m_fail")
    forced = mu == H_FAIL_MU
    if h_fail and _is_h_fail(model) and not (
            bool(want.h_fail[forced].all())
            and not bool(want.m_fail[forced].any())):
        raise AssertionError("a μ = −1e6 lane did not latch h_fail alone")


def _riccati_fields(optimizing: bool, slim: bool):
    names = (("L", "dl") if (optimizing and slim) else () if slim else
             ("s_vec", "S", "g", "G", "H", "L", "dl"))
    return [("value", "value")] + [(name, "gain") for name in names]


def check_riccati(model: str, T: int, B: int, dtype, device,
                  optimizing: bool, slim: bool, shared_w: bool,
                  has_dl: bool, kernel: Callable = riccati_bank
                  ) -> Agreement:
    """Kernel A (``kernel``, of :func:`riccati_bank`'s signature) against
    :func:`riccati_bank_plain` in one variant; every θ = 1e6 lane must
    latch m_fail, and on an h_fail fixture the optimizing pass every
    μ = −1e6 lane h_fail and not m_fail."""
    ap, _, _, theta, mu = _riccati_fixture(model, T, B, dtype, device,
                                           shared_w)
    L_in, dl_in, want, ref = _riccati_plain(model, T, B, dtype, device,
                                            shared_w, optimizing, has_dl)
    if slim:
        want = _slim(want, optimizing)
        ref = None if ref is None else _slim(ref, optimizing)
    got = kernel(ap, theta, mu, L_in, dl_in, slim=slim)
    out = _compare(got, want, ref, theta, _riccati_fields(optimizing, slim),
                   dtype)
    _check_latching(model, want, theta, mu, optimizing)
    return out


def check_riccati_wide(model: str, T: int, B: int, dtype, device
                       ) -> Agreement:
    """Kernel A's slim optimizing pass on a bank of ``B`` lanes that
    repeats the fixture's first ``TILE_BASE`` (as the timings do), against
    the plain version on those lanes: lane i of the wide bank against
    lane i mod ``TILE_BASE``.  The plain version and its float64 run
    never hold the wide bank, which at the quadrotor's B=262,144 would not
    fit the card beside the kernel's."""
    base = min(B, TILE_BASE)
    ap, _, _, theta, mu = _riccati_fixture(model, T, base, dtype, device,
                                           True)
    _, _, want, ref = _riccati_plain(model, T, base, dtype, device, True,
                                     True, False)
    got = riccati_bank(_widen(ap, B), _wide(theta, B), _wide(mu, B),
                       slim=True)
    lanes = torch.arange(B, device=got.value.device) % base

    def wide(full):
        return None if full is None else BankSlim(
            *(x[lanes] for x in _slim(full, True)))

    want = wide(want)
    theta, mu = theta[lanes], mu[lanes]
    out = _compare(got, want, wide(ref), theta, _riccati_fields(True, True),
                   dtype)
    _check_latching(model, want, theta, mu, True)
    return out


RICCATI_VARIANTS = [
    dict(optimizing=o, slim=s, shared_w=w, has_dl=d)
    for o in (True, False) for s in (True, False) for w in (True, False)
    for d in ((False,) if o else (False, True))]


def _problem64(model, T, device):
    prob = make_problem(model, T, torch.float64, device)
    return prob, noise_model(prob, T, torch.float64, device)


def step_inputs(model: str, T: int, B: int, dtype, device):
    """Seeded ``(problem, x0, l, theta, mu, noise)`` of kernel B's checks:
    :func:`step_optimize_bank`'s arguments."""
    prob, x0, l, _, theta, mu, noise = bank_inputs(model, T, B, dtype,
                                                   device, seed=1)
    return prob, x0, l, theta, mu, noise


def check_step(model: str, T: int, B: int, dtype, device,
               kernel: Callable = step_optimize_bank) -> Agreement:
    """Kernel B (``kernel``, of :func:`step_optimize_bank`'s signature)
    against :func:`step_optimize_bank_plain`; every θ = 1e6 lane must latch
    m_fail, and on an h_fail fixture (:func:`h_fail_fixture`) every
    μ = −1e6 lane h_fail and not m_fail."""
    prob, x0, l, theta, mu, noise = step_inputs(model, T, B, dtype, device)
    got = kernel(prob, x0, l, theta, mu, noise)
    want = step_optimize_bank_plain(prob, x0, l, theta, mu, noise)
    ref = None
    if dtype == torch.float32:
        prob64, noise64 = _problem64(model, T, device)
        ref = step_optimize_bank_plain(prob64, *map(_f64, (x0, l, theta, mu)),
                                       noise64)
    fields = [("x", "traj"), ("value", "value"), ("L", "gain"),
              ("dl", "gain")]
    out = _compare(got, want, ref, theta, fields, dtype)
    _check_latching(model, want, theta, mu, True)
    return out


def candidate_inputs(model: str, T: int, B: int, dtype, device, seed=2):
    prob, x0, l, L, theta, mu, noise = bank_inputs(model, T, B, dtype,
                                                   device, seed)
    # Nominal trajectories from a different schedule, so the feedback term
    # L (x − x̄) is exercised.
    x_ref = rollout_open_loop(prob, x0, 0.5 * l)
    return prob, x_ref, l, L, mu, theta, noise


CANDIDATE_FIELDS = [("value", "value"), ("x", "traj")]


def check_candidate(model: str, T: int, B: int, dtype, device
                    ) -> Agreement:
    """Kernel C against :func:`candidate_bank_plain`, its value and the
    states of its closed-loop rollout; every θ = 1e6 lane must latch
    m_fail."""
    args = candidate_inputs(model, T, B, dtype, device)
    got = candidate_bank(*args)
    want = candidate_bank_plain(*args)
    ref = None
    if dtype == torch.float32:
        prob64, noise64 = _problem64(model, T, device)
        ref = candidate_bank_plain(prob64, *map(_f64, args[1:-1]), noise64)
    out = _compare(got, want, ref, args[5], CANDIDATE_FIELDS, dtype)
    if not bool(want.m_fail[args[5] == 1e6].all()):
        raise AssertionError("a θ = 1e6 lane did not latch m_fail")
    return out


@functools.lru_cache(maxsize=1)
def _folded_fixture(model: str, T: int, B: int, dtype, device):
    """The folded stack with its shared noise model, θ and the noise model,
    kept for the check with the other noise model."""
    prob, x_ref, l, L, mu, theta, noise = candidate_inputs(model, T, B,
                                                           dtype, device)
    return approximate_folded(prob, x_ref, l, L, mu, noise), theta, noise


def folded_inputs(model: str, T: int, B: int, dtype, device,
                  shared_w: bool = True):
    """``(folded stack, theta)``: :func:`approximate_folded` of the
    candidate fixture (θ from ``THETA_MIX``), with a per-lane noise model
    unless ``shared_w``."""
    fa, theta, noise = _folded_fixture(model, T, B, dtype, device)
    if not shared_w:
        W, W_inv, logdet_W = per_lane_noise(noise, B)
        fa = fa._replace(W=W, W_inv=W_inv, logdet_W=logdet_W)
    return fa, theta


def folded_margins(fa: FoldedApprox, theta, lanes) -> list:
    """For each of ``lanes`` of a folded stack (float64): the smallest
    eigenvalue of M = sym(W⁻¹ − θS) over the plain evaluating pass (until
    M fails), relative to the largest |W⁻¹| entry of that step; negative
    where M fails."""
    B = theta.shape[0]
    f = FoldedApprox(*(x[lanes] if x.dim() and x.shape[0] == B else x
                       for x in fa))
    th = theta[lanes][:, None, None]
    eye = torch.eye(f.A.shape[-1], dtype=f.A.dtype, device=f.A.device)
    S = f.Q_term
    worst = torch.full(th.shape[:1], float("inf"), dtype=f.A.dtype,
                       device=f.A.device)
    for t in reversed(range(f.A.shape[1])):
        Wi = f.W_inv[t] if f.W_inv.dim() == 3 else f.W_inv[:, t]
        M = smallmat.sym(Wi - th * S)
        ok = torch.isfinite(M).flatten(1).all(1)
        lam = torch.linalg.eigvalsh(torch.where(ok[:, None, None], M, eye))
        rel = lam[:, 0] / Wi.abs().amax((-2, -1))
        worst = torch.where(ok, torch.minimum(worst, rel), worst)
        D = eye + th * smallmat.cho_solve_mat(smallmat.cholesky(M),
                                              S).transpose(-1, -2)
        S = smallmat.sym(f.Q[:, t]
                         + f.A[:, t].transpose(-1, -2) @ D @ S @ f.A[:, t])
    return worst.tolist()


def check_folded_flags(model: str, T: int, B: int, device,
                       kernel: Callable = riccati_bank_folded) -> list:
    """Kernel D's float32 m_fail (``kernel``, a shared noise model) against
    the float64 plain version's on every lane that float32 resolves
    (:data:`F32_UNRESOLVED`); returns the lanes it does not, at most one in
    10,000, whose flags are not compared."""
    fa, theta = folded_inputs(model, T, B, torch.float32, device)
    fa64, theta64 = FoldedApprox(*map(_f64, fa)), _f64(theta)
    got = kernel(fa, theta).m_fail
    want = riccati_bank_folded_plain(fa64, theta64).m_fail
    lanes = torch.nonzero(got != want).flatten().tolist()
    margins = folded_margins(fa64, theta64, lanes) if lanes else []
    resolved = [(b, m) for b, m in zip(lanes, margins)
                if abs(m) >= F32_UNRESOLVED]
    if resolved:
        raise AssertionError(
            f"m_fail: {len(resolved)} lanes differ from float64's where "
            "float32 resolves M, e.g. " + ", ".join(
                f"lane {b} (θ {float(theta[b]):g}, margin {m:.3e})"
                for b, m in resolved[:4]))
    if len(lanes) * 10_000 > B:
        raise AssertionError(f"m_fail: {len(lanes)} of {B} lanes differ "
                             "from float64's, all unresolved in float32")
    return lanes


def check_riccati_folded(model: str, T: int, B: int, dtype, device,
                         shared_w: bool,
                         kernel: Callable = riccati_bank_folded
                         ) -> Agreement:
    """Kernel D (``kernel``, of :func:`riccati_bank_folded`'s signature)
    against :func:`riccati_bank_folded_plain`; every θ = 1e6 lane must
    latch m_fail."""
    fa, theta = folded_inputs(model, T, B, dtype, device, shared_w)
    got = kernel(fa, theta)
    want = riccati_bank_folded_plain(fa, theta)
    ref = None
    if dtype == torch.float32:
        ref = riccati_bank_folded_plain(FoldedApprox(*map(_f64, fa)),
                                        _f64(theta))
    out = _compare(got, want, ref, theta, [("value", "value")], dtype)
    if not bool(want.m_fail[theta == 1e6].all()):
        raise AssertionError("a θ = 1e6 lane did not latch m_fail")
    return out


def check_riccati_folded_wide(model: str, T: int, B: int, dtype, device,
                              shared_w: bool) -> Agreement:
    """Kernel D on a bank of ``B`` lanes that repeats the fixture's first
    ``TILE_BASE`` (as the timings do), against the plain version on those
    lanes: lane i of the wide bank against lane i mod ``TILE_BASE``.  The
    bank is widened in the kernel's lane-minor layout and launched as it
    is, so no ``(B, T, ...)`` copy of it is made: on the quadrotor at
    B=262,144 a per-lane noise model alone is 15 GB in float32."""
    base = min(B, TILE_BASE)
    fa, theta = folded_inputs(model, T, base, dtype, device, shared_w)
    want = riccati_bank_folded_plain(fa, theta)
    ref = None
    if dtype == torch.float32:
        ref = riccati_bank_folded_plain(FoldedApprox(*map(_f64, fa)),
                                        _f64(theta))
    ins, w_shared = folded_layout(fa, theta)
    reps = -(-B // base)
    shared = range(4, 7) if w_shared else ()   # ins[4:7]: W, W⁻¹, logdet W
    got = launch_folded(tuple(
        x if i in shared else   # lane-minor: the lane axis is the last
        x.repeat((1,) * (x.dim() - 1) + (reps,))[..., :B].contiguous()
        for i, x in enumerate(ins)), w_shared)
    del ins
    lanes = torch.arange(B, device=got.value.device) % base

    def wide(out):
        return None if out is None else BankFolded(*(x[lanes] for x in out))

    want, theta = wide(want), theta[lanes]
    out = _compare(got, want, wide(ref), theta, [("value", "value")], dtype)
    if not bool(want.m_fail[theta == 1e6].all()):
        raise AssertionError("a θ = 1e6 lane did not latch m_fail")
    return out


def expect_fail_pattern(model: str, T: int, B: int, dtype, device,
                        kernel: str = "step") -> Tuple[int, int]:
    """Counts of (m_fail, h_fail) lanes kernel B (``"step"``) or kernel A's
    slim optimizing pass (``"riccati"``) reports, so a caller can check
    that its fixture really fails where it should."""
    if kernel == "riccati":
        ap, _, _, theta, mu = _riccati_fixture(model, T, B, dtype, device,
                                               True)
        out = riccati_bank(ap, theta, mu, slim=True)
    else:
        prob, x0, l, _, theta, mu, noise = bank_inputs(model, T, B, dtype,
                                                       device, seed=1)
        out = step_optimize_bank(prob, x0, l, theta, mu, noise)
    return int(out.m_fail.sum()), int(out.h_fail.sum())


def time_ms(fn: Callable[[], object], reps: int = 5) -> float:
    """Median time of ``fn`` in ms over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


TILE_BASE = 16_384   # lanes a timing seeds; wider banks repeat them


def _wide(x: torch.Tensor, B: int) -> torch.Tensor:
    """Repeat the lane axis of ``x`` up to ``B`` lanes (the kernels' work
    does not depend on the data)."""
    reps = -(-B // x.shape[0])
    return x.repeat((reps,) + (1,) * (x.dim() - 1))[:B]


def _widen(stack, B: int):
    """:func:`_wide` on every field of a stack but its shared noise
    model."""
    return type(stack)(*(x if k in ("W", "W_inv", "logdet_W") else
                         _wide(x, B) for k, x in zip(stack._fields, stack)))


def timing_cases(model: str, T: int, B: int, dtype, device):
    """``{kernel: (wrapper, layout, launch, plain)}`` callables at (T, B) on
    ``model``'s fixture: ``wrapper()`` and ``plain()`` run the kernel's
    wrapper and its plain version, ``launch(layout())`` the kernel alone
    on inputs already in its layout.  Kernel A is its slim optimizing pass
    (``riccati``) or its slim evaluating pass with no dl stream
    (``riccati_evaluating``, as the bank's line search runs it); kernel D
    takes a shared noise model (``riccati_folded``) or a per-lane one
    (``riccati_folded_lane_w``).  Inputs are seeded at up to
    ``TILE_BASE`` lanes and repeated beyond that; each case builds its own
    when it is reached, so one case's inputs are freed before the next."""
    base = min(B, TILE_BASE)

    def riccati():
        prob, x0, l, _, theta, mu, noise = bank_inputs(model, T, base,
                                                       dtype, device)
        x, A, Bm = rollout_open_loop_with_jac(prob, x0, l)
        ap = _widen(approximate_model(prob, l, x, A, Bm, noise), B)
        th, mu = _wide(theta, B), _wide(mu, B)
        return (lambda: riccati_bank(ap, th, mu, slim=True),
                lambda: riccati_layout(ap, th, mu),
                lambda a: launch_riccati(*a, slim=True),
                lambda: riccati_bank_plain(ap, th, mu, slim=True))

    def riccati_evaluating():
        prob, x0, l, L, theta, mu, noise = bank_inputs(model, T, base,
                                                       dtype, device)
        x, A, Bm = rollout_open_loop_with_jac(prob, x0, l)
        ap = _widen(approximate_model(prob, l, x, A, Bm, noise), B)
        th, mu, L = _wide(theta, B), _wide(mu, B), _wide(L, B)
        return (lambda: riccati_bank(ap, th, mu, L, slim=True),
                lambda: riccati_layout(ap, th, mu, L),
                lambda a: launch_riccati(*a, slim=True),
                lambda: riccati_bank_plain(ap, th, mu, L, slim=True))

    def step():
        prob, *lanes, noise = step_inputs(model, T, base, dtype, device)
        args = (prob, *(_wide(x, B) for x in lanes), noise)
        return (lambda: step_optimize_bank(*args), lambda: step_layout(*args),
                lambda a: launch_step(*a),
                lambda: step_optimize_bank_plain(*args))

    def candidate():
        prob, *lanes, noise = candidate_inputs(model, T, base, dtype, device)
        args = (prob, *(_wide(x, B) for x in lanes), noise)
        return (lambda: candidate_bank(*args),
                lambda: candidate_layout(*args),
                lambda a: launch_candidate(*a),
                lambda: candidate_bank_plain(*args))

    def riccati_folded(shared_w=True):
        fa, theta = folded_inputs(model, T, base, dtype, device, shared_w)
        fa = _widen(fa, B) if shared_w else type(fa)(*(_wide(x, B)
                                                       for x in fa))
        th = _wide(theta, B)
        return (lambda: riccati_bank_folded(fa, th),
                lambda: folded_layout(fa, th),
                lambda a: launch_folded(*a),
                lambda: riccati_bank_folded_plain(fa, th))

    return {"riccati": riccati, "riccati_evaluating": riccati_evaluating,
            "step": step, "candidate": candidate,
            "riccati_folded": riccati_folded,
            "riccati_folded_lane_w": lambda: riccati_folded(False)}


def kernel_timings(model: str, T: int, B: int, dtype, device,
                   kernels=("riccati", "step", "candidate", "riccati_folded"),
                   plain: bool = True
                   ) -> Dict[str, Tuple[float, float, Optional[float]]]:
    """``{kernel: (wrapper ms, launch ms, plain ms)}`` on ``model`` at
    (T, B), by CUDA events: the wrapper with its layout copies and the
    launch alone on inputs already in the kernel's layout, median of 5,
    and with ``plain`` the plain version, one run (None without it, or
    where it runs out of device memory), each after a warm-up run.  The plain version is host-bound
    and varies ±2x between runs, so more runs would buy no precision.
    Kernel A is timed as the slim optimizing pass."""
    out = {}
    cases = timing_cases(model, T, B, dtype, device)
    for kernel in kernels:
        wrapper, layout, launch, plain_fn = cases[kernel]()
        args = layout()
        launch_ms = time_ms(lambda: launch(args))
        del args
        wrapper_ms = time_ms(wrapper)
        plain_ms = None
        if plain:
            try:
                plain_ms = time_ms(plain_fn, reps=1)
            except torch.cuda.OutOfMemoryError:
                pass
        out[kernel] = (wrapper_ms, launch_ms, plain_ms)
        del wrapper, layout, launch, plain_fn
        torch.cuda.empty_cache()
    return out


# Peak rates of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth, and the
# FP32 / FP64 rates outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}


def _mm(p: int, q: int, r: int) -> int:
    """Operations of a (p×q)(q×r) product."""
    return p * r * (2 * q - 1)


def _chol(n: int) -> int:
    return n * (n + 1) * (2 * n + 1) // 6


def _m_factor_ops(n: int) -> int:
    # W⁻¹ − θS, sym, factor, M⁻¹S (n solves), D
    return 2 * n * n + n * (n - 1) + _chol(n) + 2 * n ** 3 + 2 * n * n


def _risk_ops(n: int) -> int:
    # tr(WS), M⁻¹s⃗, s⃗ᵀM⁻¹s⃗, log det M and the scalar tail
    return 2 * n * n + 2 * n * n + (2 * n - 1) + (2 * n + 1) + 6


def dp_step_ops(n: int, m: int, optimizing: bool = True) -> int:
    """Arithmetic operations of one optimizing or evaluating ``dp_step``
    (dp_step.cuh), a multiply-add counted as 2."""
    ops = _m_factor_ops(n)
    ops += _mm(n, n, n) + _mm(n, n, 1) + _mm(m, n, 1) + m        # DS, Ds⃗, g
    ops += 2 * _mm(m, n, n) + m * n                              # BᵀDS, G
    ops += _mm(m, n, m) + 2 * m * m + m * (m - 1)                # H
    if optimizing:
        ops += _chol(m) + 2 * m * m * (n + 1) + m * n + m        # L, dl
    ops += _mm(m, m, 1) + 2 * (2 * m - 1) + 5 + _risk_ops(n)     # s
    ops += _mm(n, n, 1) + 3 * _mm(n, m, 1) + 4 * n               # s⃗
    ops += (2 * _mm(n, n, n) + _mm(m, m, n) + 2 * _mm(n, m, n)   # S
            + 4 * n * n + n * (n - 1))
    return ops


def folded_step_ops(n: int) -> int:
    """Arithmetic operations of one ``folded_step`` (dp_step.cuh)."""
    return (_m_factor_ops(n) + _mm(n, n, n) + 2 * _mm(n, n, 1)
            + _risk_ops(n) + 2 + n + 2 * _mm(n, n, n) + n * n + n * (n - 1))


def fold_ops(n: int, m: int) -> int:
    """Operations of kernel C's fold and its two policy evaluations per
    step (candidate.cu)."""
    return (_mm(n, m, 1) + 4 * _mm(n, m, n) + _mm(m, m, n) + n + 6 * n * n
            + n * (n - 1) + 2 * (n + 2 * m * n))


def kernel_work(kernel: str, n: int, m: int, T: int, B: int, dtype
                ) -> Tuple[float, float]:
    """(bytes, operations) a kernel's function needs at (n, m, T, B): each
    input read once and each output written once (a shared noise model
    once for the bank), and the DP algebra's arithmetic (the model's own
    dynamics and cost are not counted, so the bound stays a lower one).
    Kernel A is its slim optimizing pass (``riccati``: L and dl out) or its
    slim evaluating pass with no dl stream (``riccati_evaluating``: L
    in)."""
    w = torch.empty((), dtype=dtype).element_size()
    noise = T * (2 * n * n + 1)
    if kernel in ("riccati", "riccati_evaluating"):
        optimizing = kernel == "riccati"
        lane = (T * (1 + n + 2 * n * n + m + m * m + 2 * m * n)   # in
                + 1 + n + n * n + 2                             # term, θ, μ
                + T * (m * n + (m if optimizing else 0)) + 1)   # L, dl, value
        ops = dp_step_ops(n, m, optimizing)
    elif kernel == "step":
        lane = (n + T * m + 2                                   # x0, l, θ, μ
                + (T + 1) * n + T * (m * n + m) + 1)            # x, L, dl, v
        ops = dp_step_ops(n, m)
    elif kernel == "candidate":
        lane = (T + 1) * n + T * (m + m * n) + 2 + 1
        ops = fold_ops(n, m) + folded_step_ops(n)
    elif kernel == "riccati_folded":
        lane = T * (1 + n + 2 * n * n) + 1 + n + n * n + 1 + 1
        ops = folded_step_ops(n)
    else:
        raise ValueError(kernel)
    flags = 1 if kernel in ("candidate", "riccati_folded") else 2   # flags
    return float(B * (lane * w + flags) + noise * w), float(B * T * ops)


def bound_ms(kernel: str, n: int, m: int, T: int, B: int, dtype
             ) -> Tuple[float, str]:
    """The least time one H100 could take for the kernel's work: the larger
    of its bytes over the memory rate and its operations over the peak rate
    of ``dtype``; returns (ms, "bytes" or "operations")."""
    nbytes, ops = kernel_work(kernel, n, m, T, B, dtype)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
