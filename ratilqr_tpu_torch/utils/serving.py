"""Serving: banks over request streams, counterpart of
:mod:`ratilqr_tpu.utils.serving`.

:class:`ILEQGBankServer` answers any number of iLEQG requests ``(x0,
u_init, θ)`` with banks, and :func:`pipelined_map` keeps up to ``depth``
requests in flight over a stream.

The JAX package pads every bank to one fixed width so that one compiled
program serves every request count.  PyTorch compiles nothing, so a bank
of any width costs no recompilation: by default (``bank_size=None``) the
server solves all requests as one bank with no padding, and a fixed
``bank_size`` is kept for parity with the JAX server (it splits and pads,
and runs slower on CUDA: more banks, more host rounds).

In PyTorch a bank is not one asynchronous device program: its host loop
waits for the device once per outer round (``solvers/ileqg.py``), so
banks run one after another whatever ``depth``.  ``depth`` > 1 overlaps
only the tail of each bank, its last launches and the copy of its result
to the host, with the start of the next: on CUDA it buys nothing
measurable.  Do not use it inside one closed-loop MPC chain, where each
re-plan needs the previous result.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Iterator, Optional

import torch

from ratilqr_tpu_torch.problems import problem_device
from ratilqr_tpu_torch.solvers.ileqg import ILEQGResult, make_batched_solver
from ratilqr_tpu_torch.utils.tree import tree_map


def _to_host(out: Any) -> Any:
    return tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor)
                    else t, out)


class ILEQGBankServer:
    """Request batching for iLEQG solves on the problem's device.

    ``bank_size=None`` (the default) solves all requests of a batch as one
    bank (:func:`~ratilqr_tpu_torch.solvers.ileqg.make_batched_solver`).
    With a ``bank_size``, each chunk of ``bank_size`` requests is padded to
    ``bank_size`` lanes with the trivial request ``(x0 = 0, u = 0, θ =
    0)``, solved as one bank, and the padding is sliced off, as the JAX
    server does; lanes are independent, so padding cannot change a real
    lane.  The chunks stream through :func:`pipelined_map`.

    Example::

        server = ILEQGBankServer(problem, ILEQGConfig())
        results = server.solve_batch(x0s, u_inits, thetas)   # any count
    """

    def __init__(self, problem, config, bank_size: Optional[int] = None,
                 depth: int = 1):
        self.bank_size = None if bank_size is None else int(bank_size)
        self.depth = int(depth)
        self.device = problem_device(problem)
        self._bank = make_batched_solver(problem, config)

    def _pad(self, a: torch.Tensor) -> torch.Tensor:
        k = (self.bank_size or a.shape[0]) - a.shape[0]
        if k == 0:
            return a
        return torch.cat([a, a.new_zeros((k,) + a.shape[1:])], 0)

    def solve_batch(self, x0s, u_inits, thetas) -> ILEQGResult:
        """Solve ``len(thetas)`` requests (any count): ``x0s (R, n)``,
        ``u_inits (R, T, m)``, ``thetas (R,)`` in the dtype of ``x0s``.
        Returns one :class:`ILEQGResult` with one leading entry per
        request, in order, on the host."""
        x0s = torch.as_tensor(x0s, device=self.device)
        u_inits = torch.as_tensor(u_inits, dtype=x0s.dtype,
                                  device=self.device)
        thetas = torch.as_tensor(thetas, dtype=x0s.dtype,
                                 device=self.device)
        n = thetas.shape[0]
        if not (x0s.shape[0] == u_inits.shape[0] == n):
            raise ValueError(
                f"request fields disagree: {x0s.shape[0]} x0s, "
                f"{u_inits.shape[0]} u_inits, {n} thetas")
        B = self.bank_size or max(n, 1)
        chunks = [(x0s[i:i + B], u_inits[i:i + B], thetas[i:i + B])
                  for i in range(0, n, B)]

        def run(chunk):
            cx, cu, cth = chunk
            k = cth.shape[0]
            out = self._bank(self._pad(cx), self._pad(cu), self._pad(cth))
            return ILEQGResult(*(f[:k] for f in out))

        outs = list(pipelined_map(run, chunks, depth=self.depth))
        return ILEQGResult(*(torch.cat(fs, 0) for fs in zip(*outs)))


def pipelined_map(fn: Callable[[Any], Any], items: Iterable[Any],
                  depth: int = 8,
                  fetch: Optional[Callable[[Any], Any]] = None
                  ) -> Iterator[Any]:
    """Map ``fn`` over ``items`` with up to ``depth`` results not yet
    fetched; yields fetched results in input order.

    Args:
      fn: request handler ``fn(item) -> nested tensors``.
      items: iterable of requests (each a single argument; pack tuples
        yourself).
      depth: most results in flight.  1 is a plain fetch-each-result
        loop.
      fetch: host materializer applied to each result (default: every
        tensor copied to the host).  Pass a narrower one (e.g. ``lambda
        r: float(r.value[0])``) to copy less.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    fetch = fetch or _to_host
    inflight: deque = deque()
    for item in items:
        inflight.append(fn(item))
        if len(inflight) >= depth:
            yield fetch(inflight.popleft())
    while inflight:
        yield fetch(inflight.popleft())
