"""Carry configurations and solver results between the JAX package and the
port.

Configurations cross by ``dataclasses`` field name (a
``CrossEntropyConfig`` or ``NelderMeadConfig`` with its nested ``ileqg``,
a ``PETSConfig``), results and the outer solvers' warm-start states
(``CEState``, ``NMState``, ``PETSState``) as dictionaries of numpy arrays
keyed by field name — so a warm start computed by one package can seed the
other.  Problems cross by their constructor arguments:
``unicycle(N, dt, noise, goal)`` builds the same problem in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from ratilqr_tpu_torch.config import (CrossEntropyConfig, ILEQGConfig,
                                      NelderMeadConfig, PETSConfig)
from ratilqr_tpu_torch.solvers.ileqg import ILEQGResult
from ratilqr_tpu_torch.solvers.nelder_mead import NMState
from ratilqr_tpu_torch.solvers.pets import PETSState
from ratilqr_tpu_torch.solvers.ratilqr import CEState, RATiLQRResult


def config_to_dict(cfg) -> dict:
    """Field-name dictionary of an ``ILEQGConfig`` or a
    ``CrossEntropyConfig`` of either package (nested configs nest)."""
    return dataclasses.asdict(cfg)


def config_from_dict(d: Mapping) -> ILEQGConfig:
    """The port's ``ILEQGConfig`` from a field-name dictionary; unknown
    fields raise."""
    return ILEQGConfig(**dict(d))


def ce_config_from_dict(d: Mapping) -> CrossEntropyConfig:
    """The port's ``CrossEntropyConfig`` from a field-name dictionary whose
    ``ileqg`` entry is a field-name dictionary too; unknown fields raise."""
    d = dict(d)
    ileqg = config_from_dict(d.pop("ileqg"))
    return CrossEntropyConfig(**d, ileqg=ileqg)


def nm_config_from_dict(d: Mapping) -> NelderMeadConfig:
    """The port's ``NelderMeadConfig`` from a field-name dictionary whose
    ``ileqg`` entry is a field-name dictionary too; unknown fields raise."""
    d = dict(d)
    ileqg = config_from_dict(d.pop("ileqg"))
    return NelderMeadConfig(**d, ileqg=ileqg)


def pets_config_from_dict(d: Mapping) -> PETSConfig:
    """The port's ``PETSConfig`` from a field-name dictionary; unknown
    fields raise."""
    return PETSConfig(**dict(d))


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value)


def result_to_numpy(res) -> dict:
    """``ILEQGResult`` (either package) → dictionary of numpy arrays."""
    return {name: _numpy(v) for name, v in zip(ILEQGResult._fields, res)}


def ce_state_to_numpy(state) -> dict:
    """``CEState`` (either package) → dictionary of numpy arrays."""
    return {name: _numpy(v) for name, v in zip(CEState._fields, state)}


def ce_state_from_numpy(arrays: Mapping, dtype=torch.float64) -> CEState:
    """Dictionary of numpy arrays → the port's ``CEState``: 0-d CPU
    tensors in ``dtype``, ``iter_current`` an int."""
    return CEState(**{
        name: (int(arrays[name]) if name == "iter_current" else
               torch.tensor(float(arrays[name]), dtype=dtype))
        for name in CEState._fields})


def nm_state_to_numpy(state) -> dict:
    """``NMState`` (either package) → dictionary of numpy arrays;
    ``c_high``/``c_low`` stay ``None`` before the first bootstrap."""
    return {name: (None if v is None else _numpy(v))
            for name, v in zip(NMState._fields, state)}


def nm_state_from_numpy(arrays: Mapping) -> NMState:
    """Dictionary of numpy arrays → the port's ``NMState``: Python floats
    (``None`` kept), ``iter_current`` an int."""
    return NMState(**{
        name: (None if arrays[name] is None else
               int(arrays[name]) if name == "iter_current" else
               float(arrays[name]))
        for name in NMState._fields})


def pets_state_to_numpy(state) -> dict:
    """``PETSState`` (either package) → dictionary of numpy arrays."""
    return {name: _numpy(v) for name, v in zip(PETSState._fields, state)}


def pets_state_from_numpy(arrays: Mapping, device="cuda",
                          dtype=torch.float64) -> PETSState:
    """Dictionary of numpy arrays → the port's ``PETSState``: ``mu`` and
    ``sigma`` on ``device`` (the card unless the caller asks for
    ``"cpu"``) in ``dtype``, ``iter_current`` an int."""
    return PETSState(
        mu=torch.as_tensor(np.array(arrays["mu"]), dtype=dtype,
                           device=device),
        sigma=torch.as_tensor(np.array(arrays["sigma"]), dtype=dtype,
                              device=device),
        iter_current=int(arrays["iter_current"]))


def ratilqr_result_to_numpy(res) -> dict:
    """``RATiLQRResult`` (either package) → dictionary of numpy arrays,
    the state as a nested dictionary."""
    return {name: (ce_state_to_numpy(v) if name == "state" else _numpy(v))
            for name, v in zip(RATiLQRResult._fields, res)}


def result_from_numpy(arrays: Mapping, device="cuda",
                      dtype=torch.float64) -> ILEQGResult:
    """Dictionary of numpy arrays → the port's ``ILEQGResult`` on
    ``device`` (the card unless the caller asks for ``"cpu"``): floating
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
