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

Each check returns (largest kernel-vs-plain difference, largest float32
error of the plain version against float64).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ratilqr_tpu_torch.models import lqr_problem, unicycle
from ratilqr_tpu_torch.ops import smallmat
from ratilqr_tpu_torch.ops.approx import (Approximation, NoiseModel,
                                          approximate_model, noise_model)
from ratilqr_tpu_torch.ops.candidate_cuda import (candidate_bank,
                                                  candidate_bank_plain)
from ratilqr_tpu_torch.ops.riccati_cuda import (riccati_bank,
                                                riccati_bank_plain)
from ratilqr_tpu_torch.ops.rollout import (rollout_open_loop,
                                           rollout_open_loop_with_jac)
from ratilqr_tpu_torch.ops.step_cuda import (step_optimize_bank,
                                             step_optimize_bank_plain)
from ratilqr_tpu_torch.ops.tile_model import lqr_tile_model
from ratilqr_tpu_torch.problems import RiskSensitiveProblem

THETA_MIX = (0.0, 0.01, 0.05, 1e6, 0.02)   # the 1e6 lanes must fail M
MU_MIX = (0.0, 0.0, 1e-3, 0.0, 1e-2)

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


def make_problem(model: str, T: int, dtype, device) -> RiskSensitiveProblem:
    """``unicycle``, ``lqr``, or ``negative_curvature`` — the restart- and
    h_fail-forcing fixture of tests/test_step_fused.py (control cost
    −0.05·u·u, terminal cost 0.005·x·x), all with device models."""
    if model == "unicycle":
        return unicycle(N=T, dtype=dtype, device=device)
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
    n, m = prob.tile_model.n, prob.tile_model.m
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
        mu = lane_mix(MU_MIX, B, dtype, device)
    return prob, x0, l, L, theta, mu, noise_model(prob, T, dtype, device)


def _close(name: str, got, want, lanes, rtol: float, atol) -> float:
    """``|got − want| ≤ atol + rtol·|want|`` elementwise on ``lanes``, with
    ``atol`` per lane ``(B,)``; returns max |got − want| there.  A NaN on
    either side is a mismatch."""
    got, want = got[lanes].double(), want[lanes].double()
    if not got.numel():
        return 0.0
    atol = atol[lanes].reshape((-1,) + (1,) * (got.dim() - 1))
    diff = (got - want).abs()
    allowed = atol + rtol * want.abs()
    bad = ~(diff <= allowed)
    if bool(bad.any()):
        excess = torch.where(bad, diff - allowed, torch.zeros_like(diff))
        i = int(excess.nan_to_num(float("inf")).flatten().argmax())
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements differ; "
            f"worst |kernel − plain| {float(diff.flatten()[i]):.3e} against "
            f"{float(allowed.flatten()[i]):.3e} allowed")
    return float(diff.max())


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


def _compare(got, want, ref, theta, fields, dtype) -> Tuple[float, float]:
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
    (:func:`_drift_atol`).  Returns (largest kernel-vs-plain difference,
    largest plain float32 error)."""
    for flag in ("m_fail", "h_fail"):
        if hasattr(want, flag):
            _flags(flag, getattr(got, flag), getattr(want, flag))
    ok = ~_failed(want)
    if ref is not None:
        ok = ok & ~_failed(ref)
    err = plain_err = 0.0
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
        err = max(err, _close(name, getattr(got, name), want_f, lanes, rtol,
                              tol))
    return err, plain_err


def _f64(x):
    return None if x is None else x.double()


def per_lane_noise(noise: NoiseModel, B: int):
    """A different noise model on every lane: W scaled by 1, 1.5, 2, ..."""
    scale = 1.0 + 0.5 * (torch.arange(B, device=noise.W.device) % 3)
    W = noise.W[None] * scale.to(noise.W.dtype)[:, None, None, None]
    chol = smallmat.cholesky(W)
    return W, smallmat.cho_inverse(chol), smallmat.cho_logdet(chol)


def check_riccati(model: str, T: int, B: int, dtype, device,
                  optimizing: bool, slim: bool, shared_w: bool,
                  has_dl: bool) -> Tuple[float, float]:
    """Kernel A against :func:`riccati_bank_plain` in one variant."""
    prob, x0, l, L, theta, mu, noise = bank_inputs(model, T, B, dtype,
                                                   device)
    x, A, Bm = rollout_open_loop_with_jac(prob, x0, l)
    ap = approximate_model(prob, l, x, A, Bm, noise)
    if not shared_w:
        W, W_inv, logdet_W = per_lane_noise(noise, B)
        ap = ap._replace(W=W, W_inv=W_inv, logdet_W=logdet_W)
    L_in = dl_in = None
    if not optimizing:
        L_in = riccati_bank_plain(ap, theta, mu).L.nan_to_num() + 0.05 * L
        dl_in = 0.05 * l if has_dl else None
    got = riccati_bank(ap, theta, mu, L_in, dl_in, slim=slim)
    want = riccati_bank_plain(ap, theta, mu, L_in, dl_in, slim=slim)
    ref = None
    if dtype == torch.float32:
        ref = riccati_bank_plain(Approximation(*map(_f64, ap)), _f64(theta),
                                 _f64(mu), _f64(L_in), _f64(dl_in),
                                 slim=slim)
    names = (("L", "dl") if (optimizing and slim) else () if slim else
             ("s_vec", "S", "g", "G", "H", "L", "dl"))
    return _compare(got, want, ref, theta, [("value", "value")]
                    + [(name, "gain") for name in names], dtype)


RICCATI_VARIANTS = [
    dict(optimizing=o, slim=s, shared_w=w, has_dl=d)
    for o in (True, False) for s in (True, False) for w in (True, False)
    for d in ((False,) if o else (False, True))]


def _problem64(model, T, device):
    prob = make_problem(model, T, torch.float64, device)
    return prob, noise_model(prob, T, torch.float64, device)


def check_step(model: str, T: int, B: int, dtype, device
               ) -> Tuple[float, float]:
    """Kernel B against :func:`step_optimize_bank_plain`."""
    prob, x0, l, _, theta, mu, noise = bank_inputs(model, T, B, dtype,
                                                   device, seed=1)
    got = step_optimize_bank(prob, x0, l, theta, mu, noise)
    want = step_optimize_bank_plain(prob, x0, l, theta, mu, noise)
    ref = None
    if dtype == torch.float32:
        prob64, noise64 = _problem64(model, T, device)
        ref = step_optimize_bank_plain(prob64, *map(_f64, (x0, l, theta, mu)),
                                       noise64)
    fields = [("x", "traj"), ("value", "value"), ("L", "gain"),
              ("dl", "gain")]
    return _compare(got, want, ref, theta, fields, dtype)


def candidate_inputs(model: str, T: int, B: int, dtype, device, seed=2):
    prob, x0, l, L, theta, mu, noise = bank_inputs(model, T, B, dtype,
                                                   device, seed)
    # Nominal trajectories from a different schedule, so the feedback term
    # L (x − x̄) is exercised.
    x_ref = rollout_open_loop(prob, x0, 0.5 * l)
    return prob, x_ref, l, L, mu, theta, noise


def check_candidate(model: str, T: int, B: int, dtype, device
                    ) -> Tuple[float, float]:
    """Kernel C against :func:`candidate_bank_plain`."""
    args = candidate_inputs(model, T, B, dtype, device)
    got = candidate_bank(*args)
    want = candidate_bank_plain(*args)
    ref = None
    if dtype == torch.float32:
        prob64, noise64 = _problem64(model, T, device)
        ref = candidate_bank_plain(prob64, *map(_f64, args[1:-1]), noise64)
    return _compare(got, want, ref, args[5], [("value", "value")], dtype)


def expect_fail_pattern(model: str, T: int, B: int, dtype, device
                        ) -> Tuple[int, int]:
    """Counts of (m_fail, h_fail) lanes the step kernel reports, so a
    caller can check that its fixture really fails where it should."""
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


def kernel_timings(T: int, B: int, dtype, device) -> Dict[str, Tuple]:
    """``{kernel: (kernel ms, plain ms)}`` on the unicycle at (T, B)."""
    prob, x0, l, L, theta, mu, noise = bank_inputs("unicycle", T, B, dtype,
                                                   device)
    x, A, Bm = rollout_open_loop_with_jac(prob, x0, l)
    ap = approximate_model(prob, l, x, A, Bm, noise)
    cand = candidate_inputs("unicycle", T, B, dtype, device)
    pairs = {
        "riccati": (lambda: riccati_bank(ap, theta, mu, slim=True),
                    lambda: riccati_bank_plain(ap, theta, mu, slim=True)),
        "step": (lambda: step_optimize_bank(prob, x0, l, theta, mu, noise),
                 lambda: step_optimize_bank_plain(prob, x0, l, theta, mu,
                                                  noise)),
        "candidate": (lambda: candidate_bank(*cand),
                      lambda: candidate_bank_plain(*cand)),
    }
    return {k: (time_ms(a), time_ms(b)) for k, (a, b) in pairs.items()}
