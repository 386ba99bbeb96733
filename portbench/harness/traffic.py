"""The one traffic generator: a closed-loop warm re-plan stream.

A traffic file gives its parameters (``traffic/<name>.json``):

- ``delta_scale``: re-plan ``i`` starts from ``x_i = x_mpc + δ_i``, ``δ_i``
  uniform on ``[−scale, scale]^n``;
- ``judged_lanes_per_replan``: how many lanes the comparison samples from
  each re-plan; lane 0 (θ = 0), lane 1 (the least θ > 0) and lane ``B − 1``
  (the largest θ) are always among those of re-plan 0;
- ``cold_lanes``: how many distinct lanes of the bank the set-up's cold
  solve runs, and the comparison judges: lane 0 first (its plan is every
  re-plan's warm start), lanes 1 and ``B − 1``, the rest drawn;
- ``warmup_replans``: warm re-plans run in set-up;
- ``trace_replans``: re-plans in a traced run's profiled sub-window.

Every draw comes from one ``torch.Generator`` seeded with ``--seed``, in a
fixed order, so a seed gives the same plan on any machine; the plan holds
the draws of ``max_replans`` re-plans whatever the window uses.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor
SEED_MODULUS = 1 << 63


@dataclasses.dataclass
class Plan:
    deltas: Tensor        # (R, n) float64
    lanes: Tensor         # (R, k) int64: the lanes judged in re-plan i
    cold_lanes: Tensor    # (c,) int64: the cold solve's lanes, lane 0 first


def plan(seed: int, traffic: dict, n: int, B: int,
         max_replans: int) -> Plan:
    g = torch.Generator().manual_seed(seed % SEED_MODULUS)
    scale = traffic["delta_scale"]
    deltas = (torch.rand((max_replans, n), generator=g,
                         dtype=torch.float64) * 2.0 - 1.0) * scale
    k = traffic["judged_lanes_per_replan"]
    lanes = torch.randint(0, B, (max_replans, k), generator=g)
    extremes = torch.tensor(sorted({0, min(1, B - 1), B - 1}))
    lanes[0, :extremes.numel()] = extremes
    drawn = torch.randperm(B, generator=g)
    drawn = drawn[~torch.isin(drawn, extremes)]
    cold = torch.cat([extremes, drawn])[:traffic["cold_lanes"]]
    return Plan(deltas, lanes, cold)
