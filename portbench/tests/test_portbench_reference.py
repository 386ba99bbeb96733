"""The frozen plain reference against the program's plain path, in float64
on the CPU at a small size, on both models: cold and warm banks, with the
fused flags (the plain compositions of kernels B and C) and without."""
import subprocess
import sys

import pytest
import torch

from portbench.harness import registry
from portbench.reference import ileqg as reference
from portbench.tests.support import CHECKOUT
from ratilqr_tpu_torch import models
from ratilqr_tpu_torch.config import ILEQGConfig
from ratilqr_tpu_torch.solvers.ileqg import make_batched_solver

F64 = torch.float64
CASES = {
    "unicycle": (dict(N=12, dt=0.1, noise=1e-3, goal=[5.0, 5.0]),
                 (0.05, -0.03, 0.01), 0.02),
    "quadrotor": (dict(N=8, dt=0.02, noise=1e-5, goal=[1.0, 1.0, 1.0]),
                  (0.0,) * 12, 0.01),
}
SOLVERS = {
    "fused": dict(adaptive_eps_init=True, eps_history_cap=0,
                  fused_step_optimize=True, fused_candidate_eval=True),
    "plain": dict(adaptive_eps_init=True, eps_history_cap=0),
}


def _agree(a, b, rtol):
    for name in ("l", "L", "value"):
        x, y = getattr(a, name), getattr(b, name)
        torch.testing.assert_close(x, y, rtol=rtol, atol=rtol * float(
            y.abs().max()), msg=name)
    assert torch.equal(a.iterations.int(), b.iterations.int())
    assert torch.equal(a.failed, b.failed)


@pytest.mark.parametrize("solver", sorted(SOLVERS))
@pytest.mark.parametrize("model", sorted(CASES))
def test_reference_matches_plain_path(model, solver):
    params, x_mpc, theta_max = CASES[model]
    problem = getattr(models, model)(**params, dtype=F64, device="cpu")
    cfg = ILEQGConfig(**SOLVERS[solver])
    bank = make_batched_solver(problem, cfg, device="cpu")
    ref_model = registry.reference_model(model)
    fields = reference.Settings.__dataclass_fields__
    solve = reference.Solver(
        ref_model.build(params, F64, "cpu"),
        reference.Settings(**{k: v for k, v in SOLVERS[solver].items()
                              if k in fields}),
        torch.finfo(F64).eps ** 0.5)
    B, T = 5, params["N"]
    n = len(x_mpc)
    m = problem.tile_model.m
    thetas = torch.linspace(0.0, theta_max, B, dtype=F64)
    x0 = torch.zeros(n, dtype=F64)
    cold = bank(x0, torch.zeros((T, m), dtype=F64), thetas)
    rcold = solve(x0.expand(B, n), torch.zeros((B, T, m), dtype=F64), thetas)
    _agree(rcold, cold, 1e-9)
    x = torch.tensor(x_mpc, dtype=F64) + 1e-5
    warm = bank(x, cold.l[0], thetas)
    rwarm = solve(x.expand(B, n), rcold.l[0].expand(B, T, m), thetas)
    _agree(rwarm, warm, 1e-9)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import portbench.reference.ileqg, portbench.harness.registry as r;"
            "[r.reference_model(m) for m in ('unicycle', 'quadrotor')];"
            "print(sorted({k.split('.')[0] for k in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(CHECKOUT)],
                         capture_output=True, text=True, check=True).stdout
    top = eval(out)
    for name in ("ratilqr_tpu_torch", "ratilqr_tpu", "jax", "jaxlib"):
        assert name not in top


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      1.0 + 2.0 ** -12, -3.0 - 2.0 ** -10])
    y = reference.round_tf32(x)
    # ties go to the even 10-bit mantissa
    assert y.tolist() == [1.0, 1.0, 1.0 + 4 * 2.0 ** -11, 1.0, -3.0]


@pytest.mark.parametrize("model", sorted(CASES))
def test_model_jacobians_match_forward_mode_ad(model):
    params, _, _ = CASES[model]
    p = registry.reference_model(model).build(params, F64, "cpu")
    n, m = (3, 2) if model == "unicycle" else (12, 4)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((6, n), generator=g, dtype=F64) * 0.3
    u = torch.randn((6, m), generator=g, dtype=F64)
    x_next, A, B = p.f_jac(x, u)
    for b in range(6):
        jA, jB = torch.func.jacfwd(
            lambda xx, uu: p.f(xx[None], uu[None])[0], argnums=(0, 1))(
                x[b], u[b])
        torch.testing.assert_close(A[b], jA, rtol=1e-13, atol=1e-13)
        torch.testing.assert_close(B[b], jB, rtol=1e-13, atol=1e-13)
    torch.testing.assert_close(x_next, p.f(x, u), rtol=0, atol=0)
