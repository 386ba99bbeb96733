"""Wrappers of the two Riccati kernels on CUDA — counterpart of
:mod:`ratilqr_tpu.ops.riccati_pallas`.

  - Kernel A, :func:`riccati_bank` (``csrc/riccati.cu``): the batched
    backward pass, optimizing or evaluating, slim or full; its plain
    version :func:`riccati_bank_plain` is the ported ``_riccati_core``.
  - Kernel D, :func:`riccati_bank_folded` (``csrc/riccati_folded.cu``): the
    value-only evaluating pass over a closed-loop-folded stack; its plain
    version :func:`riccati_bank_folded_plain` is the ported
    ``_riccati_folded_core``.

Both keep the JAX layout ``(B, T, ...)``: for a bank on a CUDA device they
launch the kernel (and raise for what it does not take); for a bank on the
CPU they run the plain version of the same signature.

Like JAX's ``riccati_bank`` and ``riccati_bank_folded``, both take any
shape: the shipped library holds the shipped models' shapes (``SHAPES``,
``FOLDED_SHAPES``), and any other shape up to ``MAX_DIM`` is built at its
first use (``_build.shape_library``).  Beyond ``MAX_DIM`` they raise
before any build.

Kernel A runs one solve per team of 16 lanes, its working set in shared
memory, at the shapes a team takes (4 < n, m ≤ 4, n + m ≤ 16: the
quadrotor, and e.g. (6, 3)), and one solve per thread at the others
(:func:`block_shared_memory` says which).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ratilqr_tpu_torch.ops import _build
from ratilqr_tpu_torch.ops.riccati import _riccati_core, _riccati_folded_core

Tensor = torch.Tensor
KERNEL = "riccati"
KERNEL_FOLDED = "riccati_folded"
# (n, m) of kernel A and n of kernel D in the shipped library: the unicycle,
# the LQR, the cartpole and the quadrotor.
SHAPES = ((3, 2), (2, 2), (4, 1), (12, 4))
FOLDED_SHAPES = (3, 2, 4, 12)
# The largest n and m the kernels take, measured on one H100 by
# ``python -m ratilqr_tpu_torch.dim_limit`` (PERF.md §6): the largest n
# probed at which kernel A at (n, n) and kernel D at n build, in float32
# and float64, and a B=4,099 launch agrees with the plain version.
MAX_DIM = 32


def _check_dims(kernel: str, *dims: int) -> None:
    if max(dims) > MAX_DIM:
        raise NotImplementedError(
            f"{kernel} kernel: dimensions {dims} exceed {MAX_DIM}, the "
            f"largest the CUDA kernels were measured to take (MAX_DIM)")


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
    return launch_riccati(*riccati_layout(approx, theta, mu, L_in, dl_in),
                          slim=slim)


def riccati_layout(approx, theta: Tensor, mu: Tensor,
                   L_in: Optional[Tensor] = None,
                   dl_in: Optional[Tensor] = None):
    """Check a bank against what kernel A takes and copy it to the kernel's
    lane-minor layout; returns the arguments of :func:`launch_riccati`."""
    Bn, T, n = approx.A.shape[0], approx.A.shape[1], approx.A.shape[-1]
    m = approx.B.shape[-1]
    dtype, device = approx.A.dtype, approx.A.device
    _check_dims(KERNEL, n, m)
    _build.dtype_suffix(dtype)   # raises for a type the kernel does not take
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
    return ins, (n, m, w_shared)


def _entry(name: str, dtype, n: int, m: int):
    """Kernel A's C entry point ``name`` at (n, m): from the shipped
    library, or from the one built for (n, m) at its first use."""
    return _build.entry(KERNEL, dtype, () if (n, m) in SHAPES else (n, m),
                        name)


def block_shared_memory(n: int, m: int, dtype, optimizing: bool = True,
                        w_shared: bool = True) -> Tuple[int, int, int]:
    """``(bytes, teams, lanes)`` of kernel A at (n, m) in one variant: the
    dynamic shared memory a block takes (0 where the kernel runs one solve
    per thread), its teams per block and lanes per team.  Builds the
    library that holds (n, m) if needed."""
    _check_dims(KERNEL, n, m)
    teams, lanes = ctypes.c_int(), ctypes.c_int()
    nbytes = _entry(f"{KERNEL}_smem", dtype, n, m)(
        n, m, int(optimizing), int(w_shared), ctypes.byref(teams),
        ctypes.byref(lanes))
    _build.check(nbytes if nbytes < 0 else 0, KERNEL)
    return nbytes, teams.value, lanes.value


def launch_riccati(ins, shape, slim: bool, entry=None):
    """Launch kernel A on arguments prepared by :func:`riccati_layout`;
    ``entry`` is another build's C entry point of the same type (by
    default the shipped library's, or the one built for the shape).  A
    launch the card refuses raises, with the block's shared memory."""
    n, m, w_shared = shape
    (T, Bn), dtype, device = ins[0].shape, ins[0].dtype, ins[0].device
    optimizing, has_dl = ins[-2] is None, ins[-1] is not None

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

    launch = entry or _entry(KERNEL, dtype, n, m)
    with torch.cuda.device(device):
        rc = launch(n, m, Bn, T, int(optimizing), int(slim), int(w_shared),
                    int(has_dl), *map(_build.ptr, ins),
                    *map(_build.ptr, outs), _build.stream_of(value))
    _build.check(rc, KERNEL, "" if rc <= 0 else (
        f"{block_shared_memory(n, m, dtype, optimizing, w_shared)[0]} B of "
        "shared memory a block"))
    _build.launch_counts[KERNEL] += 1

    def back(x):
        return None if x is None else x.movedim(-1, 0)

    if slim:
        return BankSlim(value, back(L), back(dl), m_fail, h_fail)
    return BankDP(back(s), back(s_vec), back(S), back(g), back(G), back(H),
                  back(L), back(dl), m_fail, h_fail)


class BankFolded(NamedTuple):
    """Folded evaluation of a bank."""
    value: Tensor   # (B,)
    m_fail: Tensor  # (B,) bool: neurotic breakdown


def riccati_bank_folded_plain(fa, theta: Tensor) -> BankFolded:
    """Plain PyTorch version: :func:`~ratilqr_tpu_torch.ops.riccati.
    _riccati_folded_core` over the bank."""
    return BankFolded(*_riccati_folded_core(fa, theta))


def riccati_bank_folded(fa, theta: Tensor) -> BankFolded:
    """Value-only evaluating pass over a closed-loop-folded bank ``fa``
    (:class:`~ratilqr_tpu_torch.ops.approx.FoldedApprox`, noise model shared
    ``(T, n, n)`` or per-lane ``(B, T, n, n)``) with ``theta (B,)``."""
    if fa.q.device.type == "cpu":
        return riccati_bank_folded_plain(fa, theta)
    if fa.q.device.type != "cuda":
        raise NotImplementedError(f"no folded Riccati kernel for device "
                                  f"{fa.q.device}")
    return launch_folded(*folded_layout(fa, theta))


def folded_layout(fa, theta: Tensor):
    """Check a folded bank against what kernel D takes and copy it to the
    kernel's lane-minor layout; returns the arguments of
    :func:`launch_folded`."""
    Bn, T, n = fa.A.shape[0], fa.A.shape[1], fa.A.shape[-1]
    dtype, device = fa.A.dtype, fa.A.device
    _check_dims(KERNEL_FOLDED, n)
    w_shared = fa.W.dim() == 3
    expect = {"q": (Bn, T), "q_vec": (Bn, T, n), "Q": (Bn, T, n, n),
              "A": (Bn, T, n, n),
              "W": (T, n, n) if w_shared else (Bn, T, n, n),
              "W_inv": (T, n, n) if w_shared else (Bn, T, n, n),
              "logdet_W": (T,) if w_shared else (Bn, T),
              "q_term": (Bn,), "q_vec_term": (Bn, n), "Q_term": (Bn, n, n)}
    fields = dict(zip(fa._fields, fa), theta=theta)
    expect["theta"] = (Bn,)
    for name, shape in expect.items():
        x = fields[name]
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != device:
            raise ValueError(f"riccati_folded kernel: {name} is "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}, "
                             f"expected {shape} {dtype} on {device}")
    lm = _build.lane_minor
    noise = ((fa.W.contiguous(), fa.W_inv.contiguous(),
              fa.logdet_W.contiguous()) if w_shared else
             (lm(fa.W), lm(fa.W_inv), lm(fa.logdet_W)))
    ins = (lm(fa.q), lm(fa.q_vec), lm(fa.Q), lm(fa.A), *noise,
           fa.q_term.contiguous(), lm(fa.q_vec_term), lm(fa.Q_term),
           theta.contiguous())
    return ins, w_shared


def launch_folded(ins, w_shared: bool) -> BankFolded:
    """Launch kernel D on arguments prepared by :func:`folded_layout`."""
    n, T, Bn = ins[3].shape[-3], ins[0].shape[0], ins[0].shape[-1]
    value = torch.empty(Bn, dtype=ins[0].dtype, device=ins[0].device)
    m_fail = torch.empty(Bn, dtype=torch.bool, device=value.device)
    launch = _build.entry(KERNEL_FOLDED, value.dtype,
                          () if n in FOLDED_SHAPES else (n,))
    with torch.cuda.device(value.device):
        rc = launch(n, Bn, T, int(w_shared), *map(_build.ptr, ins),
                    _build.ptr(value), _build.ptr(m_fail),
                    _build.stream_of(value))
    _build.check(rc, KERNEL_FOLDED)
    _build.launch_counts[KERNEL_FOLDED] += 1
    return BankFolded(value, m_fail)
