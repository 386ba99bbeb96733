"""Carry configurations and solver results between the JAX package and the
port.

Configurations cross by ``dataclasses`` field name, results as dictionaries
of numpy arrays keyed by :class:`ILEQGResult` field name — so a warm start
computed by one package (``l``, ``L``, ``x``) can seed the other.  Problems
cross by their constructor arguments: ``unicycle(N, dt, noise, goal)``
builds the same problem in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from ratilqr_tpu_torch.config import ILEQGConfig
from ratilqr_tpu_torch.solvers.ileqg import ILEQGResult


def config_to_dict(cfg) -> dict:
    """Field-name dictionary of an ``ILEQGConfig`` of either package."""
    return dataclasses.asdict(cfg)


def config_from_dict(d: Mapping) -> ILEQGConfig:
    """The port's ``ILEQGConfig`` from a field-name dictionary; unknown
    fields raise."""
    return ILEQGConfig(**dict(d))


def result_to_numpy(res) -> dict:
    """``ILEQGResult`` (either package) → dictionary of numpy arrays."""
    out = {}
    for name, value in zip(ILEQGResult._fields, res):
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        out[name] = np.asarray(value)
    return out


def result_from_numpy(arrays: Mapping, device="cpu",
                      dtype=torch.float64) -> ILEQGResult:
    """Dictionary of numpy arrays → the port's ``ILEQGResult``: floating
    fields in ``dtype``, counters as int32, ``failed`` as bool."""
    fields = {}
    for name in ILEQGResult._fields:
        a = np.asarray(arrays[name])
        if name == "failed":
            t = torch.as_tensor(a.astype(bool), device=device)
        elif name in ("eps_count", "iterations"):
            t = torch.as_tensor(a.astype(np.int32), device=device)
        else:
            t = torch.as_tensor(np.array(a), dtype=dtype, device=device)
        fields[name] = t
    return ILEQGResult(**fields)
