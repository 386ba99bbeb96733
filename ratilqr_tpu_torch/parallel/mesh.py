"""Process-group mesh utilities, counterpart of
:mod:`ratilqr_tpu.parallel.mesh`: the port's replacement for the
reference's Julia ``Distributed`` backend.

JAX runs one process over a 1-D ``Mesh`` of devices.  PyTorch's idiom is
one rank per device on a process group, so the sample axis (θ samples, CEM
control sequences, episode seeds) is split over the ranks of a 1-D
``DeviceMesh`` named ``"samples"``, and the collectives ride NCCL between
cards or gloo between CPU processes.  Each rank's device is explicit:
``cuda:<local rank>`` unless the caller names another (``"cpu"`` in the
tests).  Nothing here starts a process group at import time.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

SAMPLE_AXIS = "samples"


class NamedSharding(NamedTuple):
    """A mesh and the DTensor placements of one tensor over it, e.g.
    ``torch.distributed.tensor.distribute_tensor(x, *sharding)``."""
    mesh: DeviceMesh
    placements: Tuple


def _rank_device(device=None, rank: Optional[int] = None) -> torch.device:
    """This rank's device: ``device`` when given, else ``cuda:<local
    rank>``, the local rank read from ``LOCAL_RANK``, else ``rank``, else
    the rank of the initialized group, else 0."""
    if device is not None:
        return torch.device(device)
    if "LOCAL_RANK" in os.environ:
        rank = int(os.environ["LOCAL_RANK"])
    elif rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank)


def distributed_initialize(device=None, **kwargs) -> torch.device:
    """Start this rank's process group (``torch.distributed.
    init_process_group(**kwargs)``, the twin of ``jax.distributed.
    initialize``) on its device, and return the device.

    The backend is NCCL on a CUDA device and gloo on the CPU unless
    ``backend`` is given; a CUDA device becomes the rank's current device
    first, as NCCL requires.  Pass the address (``init_method=
    "tcp://localhost:<port>"`` or a ``store``), ``world_size`` and
    ``rank``: nothing on a single machine supplies them.
    """
    device = _rank_device(device, kwargs.get("rank"))
    kwargs.setdefault("backend", "nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(**kwargs)
    return device


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = SAMPLE_AXIS, device=None) -> DeviceMesh:
    """A 1-D mesh over every rank of the process group, its one dimension
    named ``axis_name``.

    The workloads have one embarrassingly parallel sample axis and no
    parameters to shard, so a 1-D mesh is the whole story.  ``device``
    is this rank's (default ``cuda:<local rank>``); ``n_devices``, when
    given, must be the world size.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "distributed_initialize first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh over {n_devices} ranks of a world of "
                         f"{world}: the mesh spans every rank")
    device = _rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return init_device_mesh(device.type, (world,),
                            mesh_dim_names=(axis_name,))


def sample_sharding(mesh: DeviceMesh, axis_name: str = SAMPLE_AXIS
                    ) -> NamedSharding:
    """The leading (sample) axis split over the mesh's ``axis_name``."""
    if mesh.mesh_dim_names != (axis_name,):
        raise ValueError(f"the mesh's dimension is {mesh.mesh_dim_names}, "
                         f"not ({axis_name!r},)")
    return NamedSharding(mesh, (Shard(0),))


def replicated(mesh: DeviceMesh) -> NamedSharding:
    """Every rank holds the whole tensor."""
    return NamedSharding(mesh, (Replicate(),))
