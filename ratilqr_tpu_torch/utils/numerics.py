"""Small numeric helpers shared across solvers."""
from __future__ import annotations

import torch


def isapprox(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Julia-style ``a ≈ b``: ``|a−b| ≤ √eps(dtype)·max(|a|,|b|)``
    (the line-search acceptance rule, ``ileqg.jl:538``); the rtol follows
    the working dtype of ``a``."""
    rtol = torch.finfo(a.dtype).eps ** 0.5
    return (a - b).abs() <= rtol * torch.maximum(a.abs(), b.abs())


def max_control_deviation(l_traj: torch.Tensor,
                          u_traj: torch.Tensor) -> torch.Tensor:
    """``max_t ‖l_t − u_t‖₂`` over the time axis (``ileqg.jl:539``);
    ``(..., T, m)`` inputs give a ``(...)`` result."""
    return torch.linalg.vector_norm(l_traj - u_traj, dim=-1).amax(dim=-1)
