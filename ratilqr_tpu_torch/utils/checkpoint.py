"""Solver-state checkpointing, counterpart of
:mod:`ratilqr_tpu.utils.checkpoint`.

A state (``CEState``, ``NMState``, ``PETSState``, an episode's
``plan_state``) is a nested container of tensors and Python scalars; it is
saved as an ``.npz`` of its leaves plus a descriptor holding each leaf's
kind (``none``/``float``/``int``/``bool``/``array``) and its key path
(:mod:`ratilqr_tpu_torch.utils.tree`, JAX's ``keystr`` strings).  The
format is the JAX package's, byte for byte in the descriptor, so a state
saved by either package loads in the other.

A leaf is restored by the kind recorded at save time: a checkpoint
written after ``NMState``'s bootstrap (``c_high``/``c_low`` concrete
floats) loads to floats against a fresh ``init_state()`` template whose
leaves are still ``None``.  Structure is validated by the key paths.
"""
from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from ratilqr_tpu_torch.utils.tree import flatten_with_paths, unflatten


def _leaf_kind(leaf: Any) -> str:
    if leaf is None:
        return "none"
    if isinstance(leaf, bool):       # before int: bool is an int subclass
        return "bool"
    if isinstance(leaf, float):
        return "float"
    if isinstance(leaf, int):
        return "int"
    return "array"


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_state(path: str, state: Any) -> None:
    """Serialize a solver state to ``<path>`` (npz format; numpy appends
    ``.npz`` when the name lacks it)."""
    paths, leaves = flatten_with_paths(state)
    arrays = {}
    kinds = []
    for i, leaf in enumerate(leaves):
        kinds.append(_leaf_kind(leaf))
        arrays[f"leaf_{i}"] = (np.zeros(0) if leaf is None
                               else _to_numpy(leaf))
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"kinds": kinds, "paths": paths}).encode(),
        dtype=np.uint8)
    np.savez(path, **arrays)


def load_state(path: str, like: Any) -> Any:
    """Load a state saved by :func:`save_state` (of either package).

    ``like`` is a template of the same structure (e.g. a fresh
    ``init_state()``) that gives the container types and, for tensor
    leaves, the dtype and device.  A leaf saved as an array loads as a
    tensor: in the template leaf's dtype and on its device where that is
    a tensor, else as saved on the CPU.
    """
    path = str(path)
    with np.load(path if path.endswith(".npz") else path + ".npz",
                 allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        arrays = {k: data[k] for k in data.files}
    like_paths, like_leaves = flatten_with_paths(like)
    if len(like_leaves) != len(meta["kinds"]):
        raise ValueError(
            f"template has {len(like_leaves)} leaves, checkpoint has "
            f"{len(meta['kinds'])}")
    saved_paths = meta.get("paths")
    if saved_paths is not None and saved_paths != like_paths:
        mismatched = [f"{s!r} vs {t!r}" for s, t
                      in zip(saved_paths, like_paths) if s != t]
        raise ValueError(
            "checkpoint structure does not match the template; "
            f"mismatched leaf paths: {', '.join(mismatched)}")
    leaves = []
    for i, (kind, tmpl) in enumerate(zip(meta["kinds"], like_leaves)):
        arr = arrays[f"leaf_{i}"]
        if kind == "none":
            leaves.append(None)
        elif kind == "float":
            leaves.append(float(arr))
        elif kind == "int":
            leaves.append(int(arr))
        elif kind == "bool":
            leaves.append(bool(arr))
        elif isinstance(tmpl, torch.Tensor):
            leaves.append(torch.as_tensor(arr).to(dtype=tmpl.dtype,
                                                  device=tmpl.device))
        else:
            leaves.append(torch.as_tensor(arr))
    return unflatten(like, leaves)
