"""The comparison that decides ``correct``.

The program's outputs on the judged lanes (the set-up's cold solve's lanes
and every re-plan's lanes, as the traffic draws them from the seed) are
held against the plain reference's for the same ``(x0, u_init, θ)``.  Per
lane:

- ``l_gap``: ``max |l − l_ref| / max |l_ref|`` over the horizon;
- ``L_gap``: the same for the gains ``L``;

and a lane whose ``failed`` flag or iteration count differs from the
reference's reads ``inf`` in both.  The numbers compared are the largest
over the judged lanes, each against its limit from the cell's file.  The
value's gap, the flag and iteration mismatches and the count of lanes are
printed beside them and not compared.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

Tensor = torch.Tensor
COMPARED = ("l_gap", "L_gap")


class Lanes(NamedTuple):
    """Outputs of some lanes, on the host."""
    l: Tensor           # (J, T, m)
    L: Tensor           # (J, T, m, n)
    value: Tensor       # (J,)
    iterations: Tensor  # (J,)
    failed: Tensor      # (J,) bool


def cat(parts: List[Lanes]) -> Lanes:
    return Lanes(*(torch.cat([getattr(p, f) for p in parts])
                   for f in Lanes._fields))


def _rel(x: Tensor, ref: Tensor) -> Tensor:
    x, ref = x.double().flatten(1), ref.double().flatten(1)
    scale = ref.abs().amax(1).clamp_min(torch.finfo(torch.float64).tiny)
    return (x - ref).abs().amax(1) / scale


def numbers(out: Lanes, ref: Lanes) -> Dict[str, float]:
    flags = out.failed != ref.failed
    iters = out.iterations.long() != ref.iterations.long()
    inf = torch.full(flags.shape, float("inf"), dtype=torch.float64)

    def gap(x, x_ref):
        return torch.where(flags | iters, inf, _rel(x, x_ref))

    v, v_ref = out.value.double(), ref.value.double()
    both = torch.isinf(v) & torch.isinf(v_ref)
    value_gap = torch.where(both, torch.zeros_like(v),
                            (v - v_ref).abs() / v_ref.abs())
    gl, gL = gap(out.l, ref.l), gap(out.L, ref.L)
    return {
        "l_gap": float(gl.max()),
        "L_gap": float(gL.max()),
        "value_gap": float(value_gap.max()),
        "flag_mismatches": int(flags.sum()),
        "iteration_mismatches": int(iters.sum()),
        "lanes": int(flags.numel()),
        "worst_position": int(torch.maximum(gl, gL).argmax()),
    }


def decide(nums: Dict[str, float], limits: Dict[str, float]
           ) -> Tuple[bool, List[str]]:
    """``correct`` and one line per number: the reported ones first, then
    each compared one with its limit."""
    lines = [f"{k} {v!r} (reported, not compared)" for k, v in nums.items()
             if k not in COMPARED]
    ok = True
    for k in COMPARED:
        passed = nums[k] <= limits[k]
        ok = ok and passed
        lines.append(f"{k} {nums[k]!r} limit {limits[k]!r} "
                     f"{'ok' if passed else 'FAILED'}")
    return ok, lines
