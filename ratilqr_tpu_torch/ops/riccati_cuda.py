"""Kernel A wrapper: the batched Riccati backward pass on CUDA.

Counterpart of :func:`ratilqr_tpu.ops.riccati_pallas.riccati_bank`.
:func:`riccati_bank` keeps the JAX layout ``(B, T, ...)``: for a bank on a
CUDA device it launches ``csrc/riccati.cu`` (and raises for what the
kernel does not take); for a bank on the CPU it runs
:func:`riccati_bank_plain`, the plain PyTorch version of the same
signature (the ported ``_riccati_core``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ratilqr_tpu_torch.ops import _build
from ratilqr_tpu_torch.ops.riccati import _riccati_core

Tensor = torch.Tensor
KERNEL = "riccati"
SHAPES = ((3, 2), (2, 2))   # (n, m) the kernel is instantiated for


class BankDP(NamedTuple):
    """Full bank output; time axis ``T`` (no terminal entry)."""
    s: Tensor       # (B, T)
    s_vec: Tensor   # (B, T, n)
    S: Tensor       # (B, T, n, n)
    g: Tensor       # (B, T, m)
    G: Tensor       # (B, T, m, n)
    H: Tensor       # (B, T, m, m)
    L: Tensor       # (B, T, m, n)
    dl: Tensor      # (B, T, m)
    m_fail: Tensor  # (B,) bool
    h_fail: Tensor  # (B,) bool

    @property
    def value(self) -> Tensor:
        return self.s[:, 0]


class BankSlim(NamedTuple):
    """Slim bank output: what the solver reads."""
    value: Tensor            # (B,)
    L: Optional[Tensor]      # (B, T, m, n); None when evaluating
    dl: Optional[Tensor]     # (B, T, m);    None when evaluating
    m_fail: Tensor
    h_fail: Tensor


def riccati_bank_plain(approx, theta: Tensor, mu: Tensor,
                       L_in: Optional[Tensor] = None,
                       dl_in: Optional[Tensor] = None, *,
                       slim: bool = False):
    """Plain PyTorch version: :func:`~ratilqr_tpu_torch.ops.riccati.
    _riccati_core` over the bank."""
    dp, L, dl, m_fail, h_fail = _riccati_core(approx, theta, mu, L_in, dl_in)
    if slim:
        if L_in is None:
            return BankSlim(dp.s[:, 0], L, dl, m_fail, h_fail)
        return BankSlim(dp.s[:, 0], None, None, m_fail, h_fail)
    return BankDP(dp.s[:, :-1], dp.s_vec[:, :-1], dp.S[:, :-1], dp.g, dp.G,
                  dp.H, L, dl, m_fail, h_fail)


def riccati_bank(approx, theta: Tensor, mu: Tensor,
                 L_in: Optional[Tensor] = None,
                 dl_in: Optional[Tensor] = None, *, slim: bool = False):
    """Backward pass for a bank: optimizing when ``L_in is None``, else
    evaluating the fixed policy (``dl_in=None``: zero offsets).  ``approx``
    is an :class:`~ratilqr_tpu_torch.ops.approx.Approximation` whose noise
    model is shared ``(T, n, n)`` or per-lane ``(B, T, n, n)``.  Returns a
    :class:`BankSlim` with ``slim=True``, else a :class:`BankDP`."""
    if approx.q.device.type == "cpu":
        return riccati_bank_plain(approx, theta, mu, L_in, dl_in, slim=slim)
    if approx.q.device.type != "cuda":
        raise NotImplementedError(f"no Riccati kernel for device "
                                  f"{approx.q.device}")
    return _riccati_bank_cuda(approx, theta, mu, L_in, dl_in, slim)


def _riccati_bank_cuda(approx, theta, mu, L_in, dl_in, slim):
    Bn, T, n = approx.A.shape[0], approx.A.shape[1], approx.A.shape[-1]
    m = approx.B.shape[-1]
    dtype, device = approx.A.dtype, approx.A.device
    if (n, m) not in SHAPES:
        raise NotImplementedError(f"riccati kernel: (n, m) = {(n, m)} is not "
                                  f"instantiated (have {SHAPES})")
    code = _build.dtype_code(dtype)
    optimizing = L_in is None
    w_shared = approx.W.dim() == 3
    expect = {"q": (Bn, T), "q_vec": (Bn, T, n), "Q": (Bn, T, n, n),
              "r": (Bn, T, m), "R": (Bn, T, m, m), "P": (Bn, T, m, n),
              "A": (Bn, T, n, n), "B": (Bn, T, n, m),
              "W": (T, n, n) if w_shared else (Bn, T, n, n),
              "W_inv": (T, n, n) if w_shared else (Bn, T, n, n),
              "logdet_W": (T,) if w_shared else (Bn, T),
              "q_term": (Bn,), "q_vec_term": (Bn, n), "Q_term": (Bn, n, n)}
    for name, shape in expect.items():
        x = getattr(approx, name)
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != device:
            raise ValueError(f"riccati kernel: approx.{name} is "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}, "
                             f"expected {shape} {dtype} on {device}")
    for name, x, shape in (("theta", theta, (Bn,)), ("mu", mu, (Bn,)),
                           ("L_in", L_in, (Bn, T, m, n)),
                           ("dl_in", dl_in, (Bn, T, m))):
        if x is not None and (tuple(x.shape) != shape or x.dtype != dtype
                              or x.device != device):
            raise ValueError(f"riccati kernel: {name} is {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}, expected {shape} "
                             f"{dtype} on {device}")

    lm = _build.lane_minor
    noise = ((approx.W.contiguous(), approx.W_inv.contiguous(),
              approx.logdet_W.contiguous()) if w_shared else
             (lm(approx.W), lm(approx.W_inv), lm(approx.logdet_W)))
    ins = [lm(approx.q), lm(approx.q_vec), lm(approx.Q), lm(approx.r),
           lm(approx.R), lm(approx.P), lm(approx.A), lm(approx.B), *noise,
           approx.q_term.contiguous(), lm(approx.q_vec_term),
           lm(approx.Q_term), theta.contiguous(), mu.contiguous(),
           None if L_in is None else lm(L_in),
           None if dl_in is None else lm(dl_in)]

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)

    full = not slim
    value = empty(Bn)
    L = empty(T, m, n, Bn) if (optimizing or full) else None
    dl = empty(T, m, Bn) if (optimizing or full) else None
    s = empty(T, Bn) if full else None
    s_vec = empty(T, n, Bn) if full else None
    S = empty(T, n, n, Bn) if full else None
    g = empty(T, m, Bn) if full else None
    G = empty(T, m, n, Bn) if full else None
    H = empty(T, m, m, Bn) if full else None
    m_fail = empty(Bn, dt=torch.bool)
    h_fail = empty(Bn, dt=torch.bool)
    outs = [value, s, s_vec, S, g, G, H, L, dl, m_fail, h_fail]

    lib = _build.library()
    with torch.cuda.device(device):
        rc = lib.ratilqr_riccati(
            code, n, m, Bn, T, int(optimizing), int(slim), int(w_shared),
            int(dl_in is not None), *map(_build.ptr, ins),
            *map(_build.ptr, outs), _build.stream_of(value))
    _build.check(rc, KERNEL)
    _build.launch_counts[KERNEL] += 1

    def back(x):
        return None if x is None else x.movedim(-1, 0)

    if slim:
        return BankSlim(value, back(L), back(dl), m_fail, h_fail)
    return BankDP(back(s), back(s_vec), back(S), back(g), back(G), back(H),
                  back(L), back(dl), m_fail, h_fail)
