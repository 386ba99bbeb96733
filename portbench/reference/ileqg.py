"""Plain iLEQG θ-bank: the benchmark's reference.

A frozen copy of the port's plain path (``ops/smallmat.py``,
``ops/rollout.py``, ``ops/approx.py``, ``ops/riccati.py`` and
``solvers/ileqg.py`` with the fused flags' plain compositions), with its
imports rewritten so that it imports nothing of the program: plain PyTorch
over a bank of independent lanes, every tensor with a leading lane axis.
Each lane's result is that of ``solve!`` for its own ``(x0, u_init, θ)``:
per-lane μ-restarts, backtracking line search with the forced accept below
ε_min, adaptive ε_init, and latched PSD failures.

Three things depart from a copy:

- the dynamics' Jacobians are written out in each model's file, where the
  port differentiates its dynamics by forward-mode AD (the costs'
  derivatives still come from ``torch.func``);
- ``accept_rtol``: the line search's ``isapprox`` tolerance, √eps of the
  type the configuration states, so a float64 reference of a float32
  configuration accepts what the configuration's rule accepts;
- ``Products(tf32=True)``: every matrix product with its operands rounded
  to TF32 (10-bit mantissa, round to nearest even) and accumulated in
  float32, as a tensor core computes it.  It is the control of the
  comparison, not the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import grad, hessian, jacfwd, vmap

Tensor = torch.Tensor

MAX_MU_RESTARTS = 40


@dataclasses.dataclass(frozen=True)
class Settings:
    """The solver settings the reference reads (``ILEQGConfig``'s fields of
    the same names and defaults)."""
    mu_min: float = 1e-6
    delta_0: float = 2.0
    lam: float = 0.5
    d_tol: float = 1e-2
    iter_max: int = 100
    eps_init: float = 1.0
    adaptive_eps_init: bool = False
    eps_min: float = 1e-6
    ls_max_trials: int = 64


@dataclasses.dataclass(frozen=True)
class Problem:
    """The dynamics ``f(x, u)`` and their Jacobians ``f_jac(x, u) -> (x',
    A, B)`` over a bank ``x (B, n)``, ``u (B, m)``; the costs ``c(k, x,
    u)``, ``h(x)`` on one lane (their derivatives come from ``torch.func``);
    the constant noise covariance ``W (n, n)``; horizon ``N``."""
    f: Callable
    f_jac: Callable
    c: Callable
    h: Callable
    W: Tensor
    N: int


def round_tf32(x: Tensor) -> Tensor:
    """Round float32 ``x`` to TF32's 10-bit mantissa, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32)


class Products:
    """The reference's matrix products; ``tf32=True`` rounds each operand to
    TF32 first (float32 only)."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def _r(self, x: Tensor) -> Tensor:
        return round_tf32(x) if self.tf32 else x

    def matmul(self, a: Tensor, b: Tensor) -> Tensor:
        return self._r(a) @ self._r(b)

    def mm(self, A: Tensor, B: Tensor) -> Tensor:
        """``A @ B`` as elementwise multiply-adds in summation-index
        order."""
        A, B = self._r(A), self._r(B)
        acc = A[..., :, 0, None] * B[..., None, 0, :]
        for k in range(1, A.shape[-1]):
            acc = acc + A[..., :, k, None] * B[..., None, k, :]
        return acc

    def mv(self, A: Tensor, v: Tensor) -> Tensor:
        A, v = self._r(A), self._r(v)
        acc = A[..., :, 0] * v[..., 0, None]
        for k in range(1, A.shape[-1]):
            acc = acc + A[..., :, k] * v[..., k, None]
        return acc


# --- small-matrix algebra (ops/smallmat.py) --------------------------------

def cholesky(M: Tensor) -> Tensor:
    """Lower Cholesky factor, column by column; NaN on failure."""
    n = M.shape[-1]
    cols = []
    for j in range(n):
        acc = M[..., j:, j]
        for k in range(j):
            acc = acc - cols[k][..., j - k:] * cols[k][..., j - k, None]
        pivot = torch.sqrt(acc[..., :1])
        cols.append(torch.cat([pivot, acc[..., 1:] / pivot], -1))
    z = torch.zeros_like(M[..., 0, :1])
    return torch.stack([torch.cat([z.expand(M.shape[:-2] + (j,)), c], -1)
                        for j, c in enumerate(cols)], -1)


def _lower(L: Tensor, B: Tensor) -> Tensor:
    y = []
    for i in range(L.shape[-1]):
        acc = B[..., i, :]
        for k in range(i):
            acc = acc - L[..., i, k, None] * y[k]
        y.append(acc / L[..., i, i, None])
    return torch.stack(y, -2)


def _upper_T(L: Tensor, Y: Tensor) -> Tensor:
    n = L.shape[-1]
    x = [None] * n
    for i in reversed(range(n)):
        acc = Y[..., i, :]
        for k in range(i + 1, n):
            acc = acc - L[..., k, i, None] * x[k]
        x[i] = acc / L[..., i, i, None]
    return torch.stack(x, -2)


def cho_solve_vec(L: Tensor, b: Tensor) -> Tensor:
    return _upper_T(L, _lower(L, b[..., None]))[..., 0]


def cho_solve_mat(L: Tensor, B: Tensor) -> Tensor:
    return _upper_T(L, _lower(L, B))


def cho_inverse(L: Tensor) -> Tensor:
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return cho_solve_mat(L, eye.expand(L.shape))


def _diag(L: Tensor) -> Tensor:
    return torch.stack([L[..., i, i] for i in range(L.shape[-1])], -1)


def cho_logdet(L: Tensor) -> Tensor:
    return 2.0 * torch.log(_diag(L)).sum(-1)


def chol_ok(L: Tensor) -> Tensor:
    """Every pivot finite and strictly positive (``isposdef``)."""
    d = _diag(L)
    return (torch.isfinite(d) & (d > 0)).all(-1)


def sym(M: Tensor) -> Tensor:
    return 0.5 * (M + M.transpose(-1, -2))


def mt(A: Tensor) -> Tensor:
    return A.transpose(-1, -2)


# --- rollouts and approximation (ops/rollout.py, ops/approx.py) ------------

def _feedback(l_t, L_t, x, x_ref_t):
    return l_t + (L_t * (x - x_ref_t).unsqueeze(-2)).sum(-1)


def rollout_open_loop(problem: Problem, x0: Tensor, u: Tensor) -> Tensor:
    f = problem.f
    xs = [x0]
    for t in range(u.shape[1]):
        xs.append(f(xs[-1], u[:, t]))
    return torch.stack(xs, 1)


def rollout_open_loop_with_jac(problem: Problem, x0: Tensor, u: Tensor):
    fj = problem.f_jac
    xs, As, Bs = [x0], [], []
    for t in range(u.shape[1]):
        x_next, A, B = fj(xs[-1], u[:, t])
        xs.append(x_next)
        As.append(A)
        Bs.append(B)
    return torch.stack(xs, 1), torch.stack(As, 1), torch.stack(Bs, 1)


def rollout_feedback(problem: Problem, x_ref, l, L):
    f = problem.f
    x = x_ref[:, 0]
    xs, us = [x], []
    for t in range(l.shape[1]):
        u = _feedback(l[:, t], L[:, t], x, x_ref[:, t])
        x = f(x, u)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, 1), torch.stack(us, 1)


def rollout_feedback_with_jac(problem: Problem, x_ref, l, L):
    fj = problem.f_jac
    x = x_ref[:, 0]
    xs, us, As, Bs = [x], [], [], []
    for t in range(l.shape[1]):
        u = _feedback(l[:, t], L[:, t], x, x_ref[:, t])
        x, A, B = fj(x, u)
        xs.append(x)
        us.append(u)
        As.append(A)
        Bs.append(B)
    return (torch.stack(xs, 1), torch.stack(us, 1), torch.stack(As, 1),
            torch.stack(Bs, 1))


class NoiseModel(NamedTuple):
    W: Tensor         # (T, n, n)
    W_inv: Tensor     # (T, n, n)
    logdet_W: Tensor  # (T,)


def noise_model(problem: Problem, T: int, dtype, device) -> NoiseModel:
    W = problem.W.to(dtype=dtype, device=device).expand(
        (T,) + tuple(problem.W.shape)).contiguous()
    chol = cholesky(W)
    return NoiseModel(W, cho_inverse(chol), cho_logdet(chol))


def _stage_derivatives(problem: Problem, x, u, with_control: bool):
    c = problem.c
    Bn, T = u.shape[0], u.shape[1]
    ks = torch.arange(T, device=u.device).repeat(Bn)

    def stage(k, xk, uk):
        out = (c(k, xk, uk), grad(c, argnums=1)(k, xk, uk),
               sym(hessian(c, argnums=1)(k, xk, uk)))
        if with_control:
            out += (grad(c, argnums=2)(k, xk, uk),
                    sym(hessian(c, argnums=2)(k, xk, uk)),
                    jacfwd(grad(c, argnums=2), argnums=1)(k, xk, uk))
        return out

    flat = vmap(stage)(ks, x.reshape(Bn * T, -1), u.reshape(Bn * T, -1))
    return tuple(a.to(x.dtype).reshape((Bn, T) + a.shape[1:]) for a in flat)


def _terminal(problem: Problem, x_T):
    h = problem.h

    def term(x):
        return h(x), grad(h)(x), sym(hessian(h)(x))

    return tuple(a.to(x_T.dtype) for a in vmap(term)(x_T))


class Approximation(NamedTuple):
    q: Tensor
    q_vec: Tensor
    Q: Tensor
    r: Tensor
    R: Tensor
    P: Tensor
    A: Tensor
    B: Tensor
    q_term: Tensor
    q_vec_term: Tensor
    Q_term: Tensor


class Folded(NamedTuple):
    q: Tensor
    q_vec: Tensor
    Q: Tensor
    A: Tensor
    q_term: Tensor
    q_vec_term: Tensor
    Q_term: Tensor


def approximate_model(problem: Problem, u, x, A, B) -> Approximation:
    q, q_vec, Q, r, R, P = _stage_derivatives(problem, x[:, :-1], u, True)
    q_term, q_vec_term, Q_term = _terminal(problem, x[:, -1])
    return Approximation(q, q_vec, Q, r, R, P, A, B, q_term, q_vec_term,
                         Q_term)


def approximate_folded(problem: Problem, pr: Products, x_ref, l, L,
                       mu) -> Folded:
    """Closed-loop rollout of ``l + L(x − x̄)`` around ``x_ref``,
    quadratization and fold: ``q̄⃗ = q⃗ + Lᵀr``, ``Q̄ = sym(Q + LᵀP + PᵀL +
    LᵀRL + μLᵀL)``, ``Ā = A + BL``."""
    x, u, A, B = rollout_feedback_with_jac(problem, x_ref, l, L)
    q, q_vec, Q, r, R, P = _stage_derivatives(problem, x[:, :-1], u, True)
    Lt = mt(L)
    q_vec = q_vec + pr.mv(Lt, r)
    LtP = pr.mm(Lt, P)
    Q = sym(Q + LtP + mt(LtP) + pr.mm(Lt, pr.mm(R, L))
            + mu[:, None, None, None] * pr.mm(Lt, L))
    A = A + pr.mm(B, L)
    q_term, q_vec_term, Q_term = _terminal(problem, x[:, -1])
    return Folded(q, q_vec, Q, A, q_term, q_vec_term, Q_term)


# --- Riccati DP (ops/riccati.py) -------------------------------------------

def _dot(a, b):
    return (a * b).sum(-1)


def _risk_terms(pr: Products, theta, theta_safe, W, S, s_vec, M_chol,
                logdet_W):
    """θ=0: ½tr(W S'); θ>0: θ/2·s⃗ᵀM⁻¹s⃗ − (logdet W + logdet M)/(2θ)."""
    risk_neutral = 0.5 * pr.matmul(W, S).diagonal(dim1=-2, dim2=-1).sum(-1)
    Minv_svec = cho_solve_vec(M_chol, s_vec)
    risk_sensitive = (0.5 * theta * _dot(s_vec, Minv_svec)
                      - (logdet_W + cho_logdet(M_chol)) / (2.0 * theta_safe))
    return torch.where(theta == 0.0, risk_neutral, risk_sensitive)


def dp_optimize_pass(pr: Products, ap: Approximation, noise: NoiseModel,
                     theta, mu):
    """One policy-optimizing backward pass; returns ``(value, L, dl,
    m_fail, h_fail)``."""
    def mv(A, v):
        return pr.matmul(A, v.unsqueeze(-1)).squeeze(-1)

    Bn, T, n = ap.A.shape[0], ap.A.shape[1], ap.A.shape[-1]
    m = ap.B.shape[-1]
    dtype, device = ap.A.dtype, ap.A.device
    eye_n = torch.eye(n, dtype=dtype, device=device)
    eye_m = torch.eye(m, dtype=dtype, device=device)
    theta_safe = torch.where(theta == 0.0, torch.ones_like(theta), theta)
    th3 = theta[:, None, None]
    s, s_vec, S = ap.q_term, ap.q_vec_term, ap.Q_term
    m_fail = torch.zeros(Bn, dtype=torch.bool, device=device)
    h_fail = torch.zeros_like(m_fail)
    Ls, dls = [None] * T, [None] * T
    for t in reversed(range(T)):
        failed = m_fail | h_fail
        A, B = ap.A[:, t], ap.B[:, t]
        M_chol = cholesky(sym(noise.W_inv[t] - th3 * S))
        m_fail = m_fail | (~failed & ~chol_ok(M_chol))
        D = eye_n + th3 * cho_solve_mat(M_chol, S).transpose(-1, -2)
        DS = pr.matmul(D, S)
        Bt = B.transpose(-1, -2)
        g = ap.r[:, t] + mv(Bt, mv(D, s_vec))
        G = ap.P[:, t] + pr.matmul(pr.matmul(Bt, DS), A)
        H = sym(ap.R[:, t] + pr.matmul(pr.matmul(Bt, DS), B)
                + mu[:, None, None] * eye_m)
        H_chol = cholesky(H)
        h_fail = h_fail | (~failed & ~m_fail & ~chol_ok(H_chol))
        L = -cho_solve_mat(H_chol, G)
        dl = -cho_solve_vec(H_chol, g)
        Hdl = mv(H, dl)
        s_new = (ap.q[:, t] + s + 0.5 * _dot(dl, Hdl) + _dot(dl, g)
                 + _risk_terms(pr, theta, theta_safe, noise.W[t], S, s_vec,
                               M_chol, noise.logdet_W[t]))
        Lt, Gt, At = L.transpose(-1, -2), G.transpose(-1, -2), \
            A.transpose(-1, -2)
        s_vec = (ap.q_vec[:, t] + mv(At, mv(D, s_vec)) + mv(Lt, Hdl)
                 + mv(Lt, g) + mv(Gt, dl))
        S = sym(ap.Q[:, t] + pr.matmul(pr.matmul(At, DS), A)
                + pr.matmul(pr.matmul(Lt, H), L) + pr.matmul(Lt, G)
                + pr.matmul(Gt, L))
        s = s_new
        Ls[t], dls[t] = L, dl
    return s, torch.stack(Ls, 1), torch.stack(dls, 1), m_fail, h_fail


def dp_evaluate_folded(pr: Products, fa: Folded, noise: NoiseModel, theta):
    """Evaluating pass over a folded stack (``dl = 0``); returns ``(value,
    m_fail)``."""
    def mv(A, v):
        return pr.matmul(A, v.unsqueeze(-1)).squeeze(-1)

    Bn, T, n = fa.A.shape[0], fa.A.shape[1], fa.A.shape[-1]
    eye_n = torch.eye(n, dtype=fa.A.dtype, device=fa.A.device)
    theta_safe = torch.where(theta == 0.0, torch.ones_like(theta), theta)
    th3 = theta[:, None, None]
    s, s_vec, S = fa.q_term, fa.q_vec_term, fa.Q_term
    m_fail = torch.zeros(Bn, dtype=torch.bool, device=fa.A.device)
    for t in reversed(range(T)):
        A = fa.A[:, t]
        M_chol = cholesky(sym(noise.W_inv[t] - th3 * S))
        m_fail = m_fail | ~chol_ok(M_chol)
        D = eye_n + th3 * cho_solve_mat(M_chol, S).transpose(-1, -2)
        DS = pr.matmul(D, S)
        s_new = fa.q[:, t] + s + _risk_terms(pr, theta, theta_safe,
                                             noise.W[t], S, s_vec, M_chol,
                                             noise.logdet_W[t])
        At = A.transpose(-1, -2)
        s_vec = fa.q_vec[:, t] + mv(At, mv(D, s_vec))
        S = sym(fa.Q[:, t] + pr.matmul(pr.matmul(At, DS), A))
        s = s_new
    return s, m_fail


def select(mask: Tensor, new, old):
    """``where(mask, new, old)`` per lane over tensors and (named) tuples."""
    if isinstance(new, tuple):
        vals = [select(mask, a, b) for a, b in zip(new, old)]
        return type(new)(*vals) if hasattr(new, "_fields") else tuple(vals)
    mk = mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim()))
    return torch.where(mk, new, old)


def _increase_mu_delta(mu, delta, mu_min, delta_0):
    delta = torch.clamp(delta * delta_0, min=delta_0)
    return torch.clamp(mu * delta, min=mu_min), delta


def _mu_restart_loop(run, mu, delta, mu_min, delta_0, active):
    out = run(mu)
    payload, m_fail, h_fail = out[:-2], out[-2], out[-1]
    k = torch.zeros_like(mu, dtype=torch.int32)
    while True:
        need = h_fail & ~m_fail & (k < MAX_MU_RESTARTS) & active
        if not bool(need.any()):
            break
        mu_n, delta_n = _increase_mu_delta(mu, delta, mu_min, delta_0)
        mu = torch.where(need, mu_n, mu)
        delta = torch.where(need, delta_n, delta)
        out = run(mu)
        payload = select(need, tuple(out[:-2]), tuple(payload))
        m_fail = torch.where(need, out[-2], m_fail)
        h_fail = torch.where(need, out[-1], h_fail)
        k = k + need.to(k.dtype)
    return (*payload, mu, delta, m_fail | h_fail)


# --- the solver (solvers/ileqg.py) -----------------------------------------

class Result(NamedTuple):
    l: Tensor           # (B, T, m)
    L: Tensor           # (B, T, m, n)
    value: Tensor       # (B,) +Inf where failed
    iterations: Tensor  # (B,)
    failed: Tensor      # (B,) bool
    d_final: Tensor     # (B,) the last accepted step's max control change
    mu_final: Tensor    # (B,)


class _State(NamedTuple):
    l: Tensor
    L: Tensor
    value: Tensor
    mu: Tensor
    delta: Tensor
    d_current: Tensor
    eps_init_cur: Tensor
    iterations: Tensor
    done: Tensor
    failed: Tensor


def _isapprox(a, b, rtol):
    return (a - b).abs() <= rtol * torch.maximum(a.abs(), b.abs())


class Solver:
    """The plain bank: ``Solver(problem, settings, accept_rtol, products)
    (x0 (B, n), u_init (B, T, m), theta (B,)) -> Result``."""

    def __init__(self, problem: Problem, settings: Settings,
                 accept_rtol: float, products: Optional[Products] = None):
        self.p, self.cfg, self.rtol = problem, settings, accept_rtol
        self.pr = products or Products()

    def _candidate(self, x_ref, l, L, mu, theta, noise):
        fa = approximate_folded(self.p, self.pr, x_ref, l, L, mu)
        return dp_evaluate_folded(self.pr, fa, noise, theta)

    def _line_search(self, st: _State, x_ref, dl, theta, noise, active):
        cfg = self.cfg
        lam = cfg.lam
        eps = st.eps_init_cur.clone()
        count = torch.zeros_like(st.iterations)
        accepted = torch.zeros_like(st.done)
        eps_acc = torch.zeros_like(eps)
        value_c = st.value.clone()
        while True:
            running = ~accepted & (count < cfg.ls_max_trials) & active
            r = running.nonzero().squeeze(1)
            if r.numel() == 0:
                break
            e = eps[r]
            values, fail = self._candidate(
                x_ref[r], st.l[r] + e[:, None, None] * dl[r], st.L[r],
                st.mu[r], theta[r], noise)
            evaluated = ~fail
            value0 = st.value[r]
            accept = evaluated & (_isapprox(values, value0, self.rtol)
                                  | (values < value0))
            forced = evaluated & ~accept & (e * lam < cfg.eps_min)
            take = accept | forced
            eps_acc[r] = torch.where(take, e, eps_acc[r])
            value_c[r] = torch.where(take, values, value_c[r])
            accepted[r] = accepted[r] | take
            eps[r] = torch.where(take & accept, e, e * lam)
            count[r] = count[r] + 1

        l_acc = st.l + eps_acc[:, None, None] * dl
        _, u_n = rollout_feedback(self.p, x_ref, l_acc, st.L)
        d_n = torch.linalg.vector_norm(st.l - u_n, dim=-1).amax(dim=-1)
        if cfg.adaptive_eps_init:
            grown = torch.clamp(eps / lam, max=cfg.eps_init)
            restored = eps
            while True:
                low = (restored < cfg.eps_min) & (restored > 0)
                if not bool(low.any()):
                    break
                restored = torch.where(low, restored / lam, restored)
            restored = torch.clamp(restored, min=cfg.eps_min)
            eps_init_next = torch.where(count == 1, grown, restored)
        else:
            eps_init_next = st.eps_init_cur
        return st._replace(
            l=select(accepted, u_n, st.l), value=value_c,
            d_current=torch.where(accepted, d_n, st.d_current),
            eps_init_cur=eps_init_next, failed=st.failed | ~accepted)

    def _step(self, st: _State, theta, x0, noise, active):
        cfg = self.cfg

        def run(mu_v):
            x, A, B = rollout_open_loop_with_jac(self.p, x0, st.l)
            ap = approximate_model(self.p, st.l, x, A, B)
            value, L, dl, m_fail, h_fail = dp_optimize_pass(
                self.pr, ap, noise, theta, mu_v)
            return x, L, dl, m_fail, h_fail

        x, L_new, dl, mu, delta, fail_opt = _mu_restart_loop(
            run, st.mu, st.delta, cfg.mu_min, cfg.delta_0, active)
        st = st._replace(L=L_new, mu=mu, delta=delta,
                         iterations=st.iterations + 1,
                         failed=st.failed | fail_opt)
        ls = self._line_search(st, x, dl, theta, noise, active & ~st.failed)
        return select(st.failed, st, ls)._replace(
            failed=st.failed | ls.failed)

    def __call__(self, x0: Tensor, u_init: Tensor, theta: Tensor) -> Result:
        cfg = self.cfg
        x0, u_init, theta = (v.contiguous() for v in (x0, u_init, theta))
        Bn, T, m = u_init.shape
        n = x0.shape[-1]
        dtype, device = x0.dtype, x0.device
        noise = noise_model(self.p, T, dtype, device)
        L = torch.zeros((Bn, T, m, n), dtype=dtype, device=device)
        zeros = torch.zeros(Bn, dtype=dtype, device=device)
        x_ref0 = x0[:, None, :].expand(Bn, T + 1, n).contiguous()
        value0, fail = self._candidate(x_ref0, u_init, L, zeros, theta,
                                       noise)
        st = _State(l=u_init, L=L, value=value0, mu=zeros,
                    delta=torch.full_like(zeros, cfg.delta_0),
                    d_current=torch.full_like(zeros, float("inf")),
                    eps_init_cur=torch.full_like(zeros, cfg.eps_init),
                    iterations=torch.zeros(Bn, dtype=torch.int32,
                                           device=device),
                    done=fail, failed=fail)
        while True:
            active = ~st.done
            if not bool(active.any()):
                break
            new = self._step(st, theta, x0, noise, active)
            converged = (new.d_current < cfg.d_tol) & (new.mu <= cfg.mu_min)
            done = converged | (new.iterations >= cfg.iter_max) | new.failed
            st = select(active, new._replace(done=done), st)
        value = torch.where(st.failed, torch.full_like(st.value,
                                                       float("inf")),
                            st.value)
        return Result(l=st.l, L=st.L, value=value,
                      iterations=st.iterations, failed=st.failed,
                      d_final=st.d_current, mu_final=st.mu)
