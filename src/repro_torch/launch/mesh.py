"""Meshes (port of ``repro.launch.mesh``).

The production meshes are shapes only: the dry run and the partition specs
read axis sizes, never devices, so :func:`make_production_mesh` returns a
:class:`MeshShape` and needs no card.  :func:`make_host_mesh` is a real
``DeviceMesh`` over the ranks of an initialised process group, the mesh the
expert-parallel MoE runs its collectives on.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Mapping, Tuple


class MeshShape:
    """Named mesh axes and their sizes, in order; ``shape`` (name -> size)
    is what ``sharding.make_rules`` and ``launch.specs`` read."""

    def __init__(self, sizes: Tuple[int, ...], names: Tuple[str, ...]):
        if len(sizes) != len(names):
            raise ValueError(f"{len(sizes)} sizes for {len(names)} axis names")
        self.shape: Mapping[str, int] = OrderedDict(zip(names, sizes))

    def __repr__(self) -> str:
        return f"MeshShape({dict(self.shape)})"


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """(16, 16) data×model single pod; (2, 16, 16) pod×data×model for 2 pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(shape, axes)


def make_host_mesh():
    """Every rank of the initialised process group as a (1, world) mesh of
    axes ("data", "model"), on the process group's device type: "cuda" under
    NCCL, "cpu" under gloo."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_host_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (1, dist.get_world_size()),
                            mesh_dim_names=("data", "model"))


def chips(mesh) -> int:
    """The number of devices in ``mesh`` (a MeshShape or a DeviceMesh)."""
    shape = mesh.shape
    return math.prod(shape.values() if isinstance(shape, Mapping) else shape)
