"""Risk-sensitive Riccati dynamic programming over a bank.

Counterpart of :mod:`ratilqr_tpu.ops.riccati`.  The reverse ``lax.scan``
becomes a Python loop over ``T`` on ``(B, ·)`` tensors; the first failed
PSD check in backward order latches a per-lane flag (a non-PSD
``M = W⁻¹ − θS`` is a neurotic breakdown, a non-PSD ``H`` requests a
μ-restart).  The μ-restart ``lax.while_loop`` becomes a host loop over
explicit per-lane masks: each lane escalates its own μ/Δ and restart
count, as the JAX loop does under ``vmap``.

Dispatch: :func:`dp_optimize` and :func:`dp_evaluate` call
:func:`ratilqr_tpu_torch.ops.riccati_cuda.riccati_bank`, which launches
kernel A for a bank on a CUDA device and runs :func:`_riccati_core` for a
bank on the CPU; :func:`dp_evaluate_folded` likewise calls
``riccati_bank_folded`` (kernel D, or :func:`_riccati_folded_core`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ratilqr_tpu_torch.ops import smallmat
from ratilqr_tpu_torch.ops.smallmat import sym
from ratilqr_tpu_torch.utils.profiling import counters, host_sync, span

Tensor = torch.Tensor

# Bound on μ-restart attempts per lane (``ileqg.jl:359`` is unbounded; μ
# grows super-geometrically, so solvable lanes succeed long before this).
MAX_MU_RESTARTS = 40


class DPResult(NamedTuple):
    """Counterpart of ``DynamicProgrammingResult`` (``ileqg.jl:328-335``)
    over a bank: ``s``/``s_vec``/``S`` have time length ``T+1`` (index 0 is
    the initial time), ``g``/``G``/``H`` length ``T``."""
    s: Tensor       # (B, T+1)
    s_vec: Tensor   # (B, T+1, n)
    S: Tensor       # (B, T+1, n, n)
    g: Tensor       # (B, T, m)
    G: Tensor       # (B, T, m, n)
    H: Tensor       # (B, T, m, m)

    @property
    def value(self) -> Tensor:
        return self.s[:, 0]


def increase_mu_delta(mu, delta, mu_min: float, delta_0: float):
    """``increase_μ_and_Δ!`` (``ileqg.jl:471-474``)."""
    delta = torch.clamp(delta * delta_0, min=delta_0)
    mu = torch.clamp(mu * delta, min=mu_min)
    return mu, delta


def decrease_mu_delta(mu, delta, mu_min: float, delta_0: float):
    """``decrease_μ_and_Δ!`` (``ileqg.jl:480-488``)."""
    delta = torch.clamp(delta / delta_0, max=1.0 / delta_0)
    new_mu = mu * delta
    mu = torch.where(new_mu >= mu_min, new_mu, torch.zeros_like(new_mu))
    return mu, delta


def _mv(A: Tensor, v: Tensor) -> Tensor:
    return (A @ v.unsqueeze(-1)).squeeze(-1)


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(-1)


def _at(x: Tensor, t: int, shared_ndim: int) -> Tensor:
    """Time slice ``t`` of a noise-model field, shared or per-lane."""
    return x[t] if x.dim() == shared_ndim else x[:, t]


def _risk_terms(theta, theta_safe, W, S, s_vec, M_chol, logdet_W):
    """θ=0: ½tr(W S') (``ileqg.jl:385``); θ>0: θ/2·s⃗ᵀM⁻¹s⃗ −
    (logdet W + logdet M)/(2θ) (``ileqg.jl:387``)."""
    risk_neutral = 0.5 * (W @ S).diagonal(dim1=-2, dim2=-1).sum(-1)
    Minv_svec = smallmat.cho_solve_vec(M_chol, s_vec)
    risk_sensitive = (0.5 * theta * _dot(s_vec, Minv_svec)
                      - (logdet_W + smallmat.cho_logdet(M_chol))
                      / (2.0 * theta_safe))
    return torch.where(theta == 0.0, risk_neutral, risk_sensitive)


def _riccati_core(approx, theta: Tensor, mu: Tensor,
                  L_traj: Optional[Tensor], dl_traj: Optional[Tensor]
                  ) -> Tuple[DPResult, Tensor, Tensor, Tensor, Tensor]:
    """One backward pass over a bank (``ileqg.jl:341-465``).

    ``L_traj is None`` optimizes the policy (gains ``L = −H⁻¹G``, offsets
    ``dl = −H⁻¹g``, H-PSD check); otherwise the fixed policy is evaluated,
    with ``dl_traj = None`` meaning zero offsets.  ``theta``/``mu`` are
    ``(B,)``.  Returns ``(dp, L, dl, m_fail, h_fail)``.
    """
    optimizing = L_traj is None
    Bn, T, n = approx.A.shape[0], approx.A.shape[1], approx.A.shape[-1]
    m = approx.B.shape[-1]
    dtype, device = approx.A.dtype, approx.A.device
    eye_n = torch.eye(n, dtype=dtype, device=device)
    eye_m = torch.eye(m, dtype=dtype, device=device)
    theta_safe = torch.where(theta == 0.0, torch.ones_like(theta), theta)
    th3 = theta[:, None, None]

    s, s_vec, S = approx.q_term, approx.q_vec_term, approx.Q_term
    m_fail = torch.zeros(Bn, dtype=torch.bool, device=device)
    h_fail = torch.zeros_like(m_fail)
    out = {k: [None] * T for k in ("s", "s_vec", "S", "g", "G", "H", "L",
                                   "dl")}
    for t in reversed(range(T)):
        failed = m_fail | h_fail
        A, B = approx.A[:, t], approx.B[:, t]
        W = _at(approx.W, t, 3)
        W_inv = _at(approx.W_inv, t, 3)
        logdet_W = _at(approx.logdet_W, t, 1)

        M = sym(W_inv - th3 * S)                              # ileqg.jl:365
        M_chol = smallmat.cholesky(M)
        m_fail = m_fail | (~failed & ~smallmat.chol_ok(M_chol))
        D = eye_n + th3 * smallmat.cho_solve_mat(M_chol, S).transpose(-1, -2)
        DS = D @ S
        Bt = B.transpose(-1, -2)
        g = approx.r[:, t] + _mv(Bt, _mv(D, s_vec))           # ileqg.jl:368
        G = approx.P[:, t] + Bt @ DS @ A                      # ileqg.jl:369
        H = sym(approx.R[:, t] + Bt @ DS @ B
                + mu[:, None, None] * eye_m)                  # ileqg.jl:370
        if optimizing:
            H_chol = smallmat.cholesky(H)
            h_fail = h_fail | (~failed & ~m_fail
                               & ~smallmat.chol_ok(H_chol))
            L = -smallmat.cho_solve_mat(H_chol, G)            # ileqg.jl:379
            dl = -smallmat.cho_solve_vec(H_chol, g)           # ileqg.jl:381
        else:
            L = L_traj[:, t]
            dl = (torch.zeros_like(g) if dl_traj is None
                  else dl_traj[:, t])

        Hdl = _mv(H, dl)
        s_new = (approx.q[:, t] + s + 0.5 * _dot(dl, Hdl) + _dot(dl, g)
                 + _risk_terms(theta, theta_safe, W, S, s_vec, M_chol,
                               logdet_W))                     # ileqg.jl:383
        Lt = L.transpose(-1, -2)
        Gt = G.transpose(-1, -2)
        s_vec = (approx.q_vec[:, t] + _mv(A.transpose(-1, -2), _mv(D, s_vec))
                 + _mv(Lt, Hdl) + _mv(Lt, g) + _mv(Gt, dl))  # ileqg.jl:389
        S = sym(approx.Q[:, t] + A.transpose(-1, -2) @ DS @ A + Lt @ H @ L
                + Lt @ G + Gt @ L)                            # ileqg.jl:390
        s = s_new
        for k, v in (("s", s), ("s_vec", s_vec), ("S", S), ("g", g),
                     ("G", G), ("H", H), ("L", L), ("dl", dl)):
            out[k][t] = v

    stk = {k: torch.stack(v, 1) for k, v in out.items()}
    dp = DPResult(
        s=torch.cat([stk["s"], approx.q_term[:, None]], 1),
        s_vec=torch.cat([stk["s_vec"], approx.q_vec_term[:, None]], 1),
        S=torch.cat([stk["S"], approx.Q_term[:, None]], 1),
        g=stk["g"], G=stk["G"], H=stk["H"])
    return dp, stk["L"], stk["dl"], m_fail, h_fail


def _riccati_folded_core(fa, theta: Tensor) -> Tuple[Tensor, Tensor]:
    """Evaluating pass over a closed-loop-folded stack (``dl = 0``;
    :class:`ratilqr_tpu_torch.ops.approx.FoldedApprox`).  Returns
    ``(value, m_fail)``."""
    Bn, T, n = fa.A.shape[0], fa.A.shape[1], fa.A.shape[-1]
    eye_n = torch.eye(n, dtype=fa.A.dtype, device=fa.A.device)
    theta_safe = torch.where(theta == 0.0, torch.ones_like(theta), theta)
    th3 = theta[:, None, None]
    s, s_vec, S = fa.q_term, fa.q_vec_term, fa.Q_term
    m_fail = torch.zeros(Bn, dtype=torch.bool, device=fa.A.device)
    for t in reversed(range(T)):
        A = fa.A[:, t]
        M_chol = smallmat.cholesky(sym(_at(fa.W_inv, t, 3) - th3 * S))
        m_fail = m_fail | ~smallmat.chol_ok(M_chol)
        D = eye_n + th3 * smallmat.cho_solve_mat(M_chol, S).transpose(-1, -2)
        DS = D @ S
        s_new = fa.q[:, t] + s + _risk_terms(
            theta, theta_safe, _at(fa.W, t, 3), S, s_vec, M_chol,
            _at(fa.logdet_W, t, 1))
        s_vec = fa.q_vec[:, t] + _mv(A.transpose(-1, -2), _mv(D, s_vec))
        S = sym(fa.Q[:, t] + A.transpose(-1, -2) @ DS @ A)
        s = s_new
    return s, m_fail


def select(mask: Tensor, new, old):
    """``where(mask, new, old)`` per lane over tensors and (named) tuples;
    ``mask`` is ``(B,)`` and broadcasts over trailing dims; a field that is
    None in both stays None."""
    if new is None and old is None:
        return None
    if isinstance(new, tuple):
        vals = [select(mask, a, b) for a, b in zip(new, old)]
        return type(new)(*vals) if hasattr(new, "_fields") else tuple(vals)
    mk = mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim()))
    return torch.where(mk, new, old)


def mu_restart_loop(run, mu: Tensor, delta: Tensor, mu_min: float,
                    delta_0: float, max_restarts: int,
                    active: Optional[Tensor] = None):
    """μ-restart retry harness (``ileqg.jl:358-401``) with per-lane masks.

    ``run(mu) -> (*payload, m_fail, h_fail)`` over the whole bank.  A lane
    restarts while its H check failed, its M check did not, and it has
    restarted fewer than ``max_restarts`` times; only restarting lanes
    escalate μ/Δ and take the new payload.  Lanes outside ``active`` never
    restart.  Returns ``(*payload, mu, delta, failed)``.  Each re-run is a
    span ``mu_restart`` and counts ``mu_restarts``; the check is host sync
    ``mu.need`` (:mod:`ratilqr_tpu_torch.utils.profiling`).
    """
    out = run(mu)
    payload, m_fail, h_fail = out[:-2], out[-2], out[-1]
    k = torch.zeros_like(mu, dtype=torch.int32)
    while True:
        need = h_fail & ~m_fail & (k < max_restarts)
        if active is not None:
            need = need & active
        if not host_sync("mu.need", bool, need.any()):
            break
        counters["mu_restarts"] += 1
        mu_n, delta_n = increase_mu_delta(mu, delta, mu_min, delta_0)
        mu = torch.where(need, mu_n, mu)
        delta = torch.where(need, delta_n, delta)
        with span("mu_restart"):
            out = run(mu)
        payload = select(need, tuple(out[:-2]), tuple(payload))
        m_fail = torch.where(need, out[-2], m_fail)
        h_fail = torch.where(need, out[-1], h_fail)
        k = k + need.to(k.dtype)
    return (*payload, mu, delta, m_fail | h_fail)


def _lanes(x, like: Tensor) -> Tensor:
    """A per-lane ``(B,)`` parameter in the bank's dtype and device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device
                           ).expand(like.shape[0]).contiguous()


def _dp_from_bank(bank, approx) -> DPResult:
    return DPResult(
        s=torch.cat([bank.s, approx.q_term[:, None]], 1),
        s_vec=torch.cat([bank.s_vec, approx.q_vec_term[:, None]], 1),
        S=torch.cat([bank.S, approx.Q_term[:, None]], 1),
        g=bank.g, G=bank.G, H=bank.H)


def dp_optimize(approx, *, theta, mu, delta, mu_min: float, delta_0: float,
                max_restarts: int = MAX_MU_RESTARTS, slim: bool = False,
                active: Optional[Tensor] = None):
    """Policy-optimizing backward pass with the per-lane μ-restart loop
    (``ileqg.jl:341-406``).  Returns ``(dp, L, dl, mu, delta, failed)``;
    with ``slim=True`` the first element is the value ``(B,)``."""
    from ratilqr_tpu_torch.ops.riccati_cuda import riccati_bank
    theta, mu, delta = (_lanes(v, approx.q) for v in (theta, mu, delta))

    def run(mu_v):
        bank = riccati_bank(approx, theta, mu_v, slim=slim)
        head = bank.value if slim else _dp_from_bank(bank, approx)
        return head, bank.L, bank.dl, bank.m_fail, bank.h_fail

    return mu_restart_loop(run, mu, delta, mu_min, delta_0, max_restarts,
                           active)


def dp_evaluate(approx, L_traj: Tensor, dl_traj: Optional[Tensor] = None,
                *, theta, mu, slim: bool = False):
    """Policy-evaluating backward pass under fixed gains
    (``ileqg.jl:412-465``); ``dl_traj=None`` means zero offsets.  Returns
    ``(dp, m_fail)``, or ``(value, m_fail)`` with ``slim=True``."""
    from ratilqr_tpu_torch.ops.riccati_cuda import riccati_bank
    theta, mu = _lanes(theta, approx.q), _lanes(mu, approx.q)
    bank = riccati_bank(approx, theta, mu, L_traj, dl_traj, slim=slim)
    if slim:
        return bank.value, bank.m_fail
    return _dp_from_bank(bank, approx), bank.m_fail


def dp_evaluate_folded(folded, *, theta) -> Tuple[Tensor, Tensor]:
    """Value-only evaluation over a closed-loop-folded stack
    (:class:`~ratilqr_tpu_torch.ops.approx.FoldedApprox`); equal to
    ``dp_evaluate(approx, L, None, slim=True)`` on the unfolded stack.
    Runs :func:`ratilqr_tpu_torch.ops.riccati_cuda.riccati_bank_folded`:
    kernel D on a CUDA device, :func:`_riccati_folded_core` on the CPU.
    Returns ``(value, m_fail)``."""
    from ratilqr_tpu_torch.ops.riccati_cuda import riccati_bank_folded
    bank = riccati_bank_folded(folded, _lanes(theta, folded.q))
    return bank.value, bank.m_fail
