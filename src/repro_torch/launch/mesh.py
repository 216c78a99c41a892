"""Mesh construction over ``torch.distributed`` (functions: importing this
module never touches a process group).

A mesh is a ``DeviceMesh`` with named dims, the counterpart of a JAX
``Mesh``: one rank a device, and a mesh dim's ``ProcessGroup``
(``mesh.get_group(axis)``) in the place of an axis name. The ranks come
from the default process group; when none is open, ``init_device_mesh``
opens one from the environment that ``torch.distributed.run`` sets. A CUDA
mesh runs over NCCL, a CPU one (``device="cpu"``) over gloo.

:func:`fake_world` is the dry run's world: 256 or 512 ranks in one
process, as rank 0, over torch's ``"fake"`` process group, whose
collectives move nothing. The JAX package gets its production mesh's
devices from ``XLA_FLAGS`` set before jax starts
(``src/repro/launch/dryrun.py:2``).
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Iterator, Sequence

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


@contextlib.contextmanager
def fake_world(size: int) -> Iterator[None]:
    """A world of ``size`` ranks in this process, this one rank 0, over a
    ``"fake"`` process group: its collectives return at once and move
    nothing, which is all a trace on fake tensors needs. Opened only where
    no default group is open, and destroyed on exit; an open fake world of
    the same size is used as it is. A real group raises, as does a fake
    one of another size."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group is "
                               "open; a fake world would replace it")
        if dist.get_world_size() != size:
            raise RuntimeError(f"a fake world of {dist.get_world_size()} "
                               f"ranks is open, {size} were asked for")
        yield
        return
    # Importing the module registers the "fake" backend.
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()
