"""Mesh construction over ``torch.distributed`` (functions: importing this
module never touches a process group).

A mesh is a ``DeviceMesh`` with named dims, the counterpart of a JAX
``Mesh``: one rank a device, and a mesh dim's ``ProcessGroup``
(``mesh.get_group(axis)``) in the place of an axis name. The ranks come
from the default process group; when none is open, ``init_device_mesh``
opens one from the environment that ``torch.distributed.run`` sets. A CUDA
mesh runs over NCCL, a CPU one (``device="cpu"``) over gloo.
"""
from __future__ import annotations

import math
import os
from typing import Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.config.torch_env import resolve_device


def _world_size() -> int:
    """Ranks of the default group, or those the launcher announced."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` over every rank, its dims named ``axes``.
    ``device="cuda"`` raises without a card; ``"cpu"`` runs on gloo."""
    dev = resolve_device(device)
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if math.prod(shape) != _world_size():
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the world has {_world_size()}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    """16x16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)
