"""Device meshes over the ranks of the current process group (PyTorch
counterpart of ``repro.launch.mesh``).

A rank is one process with one device (``runtime.ranks.run_ranks`` or
``torchrun`` starts them); a ``DeviceMesh`` lays the group's ranks out on
named axes. ``use_mesh`` makes a mesh ambient for ``maybe_shard``.

The reference's ``compat_make_mesh`` shims jax versions and has no
counterpart; ``make_production_mesh`` (the 256- and 512-device meshes)
belongs to the dry-run (ROADMAP, Queue 1 item 14). The trainer and the
server (``launch/train.py``, ``launch/serve.py``) run on
``make_host_mesh`` under a process group.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..models.sharding_utils import ambient_mesh
from ..runtime.ranks import rank_device


def _device_type(device) -> str:
    """The type of this rank's device: ``device`` when given, else the one
    ``run_ranks`` gave the rank. It is never read off the backend: gloo ranks
    may hold a card's tensors, and a default group serves both types."""
    if device is None:
        device = rank_device()
        if device is None:
            raise ValueError("make_mesh: pass the rank's device (this process was not "
                             "started by runtime.ranks.run_ranks)")
    return torch.device(device).type


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              ranks: Optional[Sequence[int]] = None, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ``ranks`` (every
    rank of the current group, in order, when None), on the type of the
    rank's ``device`` (``run_ranks``'s device for the rank when None)."""
    from torch.distributed.device_mesh import DeviceMesh
    if ranks is None:
        ranks = range(dist.get_world_size())
    ranks = torch.tensor(list(ranks), dtype=torch.int64)
    if ranks.numel() != int(torch.tensor(list(shape)).prod()):
        raise ValueError(f"a {tuple(shape)} mesh needs {int(torch.tensor(list(shape)).prod())} "
                         f"ranks, got {ranks.numel()}")
    return DeviceMesh(_device_type(device), ranks.reshape(tuple(shape)), mesh_dim_names=tuple(axes))


def make_host_mesh(device=None):
    """Every rank of the current group as a (1, world) ('data', 'model')
    mesh, the reference's (1, n) over its local devices (``device`` as in
    ``make_mesh``)."""
    return make_mesh((1, dist.get_world_size()), ("data", "model"), device=device)


def use_mesh(mesh):
    """Context manager making ``mesh`` ambient for ``maybe_shard``."""
    return ambient_mesh(mesh)
