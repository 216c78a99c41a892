"""Convert parameters and optimizer state between the JAX package's layout
and the port's.

The JAX package's ``init_params`` pytree has a ``blocks`` entry: a list of
per-position dicts, each leaf stacked over ``num_layers // period``
repeats (``src/repro/models/transformer.py:131-142``); layer ``i`` is
repeat ``i // period`` of position ``i % period``. The port keeps one dict
per layer under ``layers``. Its optimizer state (``OptState(step, m, v)``)
has the parameters' structure, with ``QTensor``/``QTensorLog`` leaves for
int8 moments, whose children stack the same way.

* ``from_jax_params`` / ``from_jax_opt_state`` take what
  ``jax.tree.map(np.asarray, ...)`` gives (nested dicts and lists of
  numpy arrays; the JAX package's ``QTensor``/``QTensorLog`` are read by
  their fields), or the same layout with tensors (a restored checkpoint).
  JAX's bf16 arrays arrive as ``ml_dtypes.bfloat16``, which
  ``torch.from_numpy`` refuses; their bits are taken through an int16
  view.
* ``to_jax_params`` / ``to_jax_opt_state`` re-stack the port's layers
  into ``blocks`` (tensors, detached, on their device): the inverse, and
  the layout a checkpoint is written in, so that its keys are the JAX
  keypaths and it restores in either package. DTensor leaves stack and
  unstack as DTensors, each shard where it was.
* ``to_jax_shardings`` gives a sharding tree of the port's layout
  (``launch.specs.params_shardings``, ``opt_shardings``) in the JAX
  layout: a stacked leaf takes its layer's sharding, whole along the
  stacking dim. ``training.checkpoint.restore(..., shardings=)`` reads a
  checkpoint with it straight into local shards.
* ``from_jax_resnet_params`` / ``from_jax_yolo_params`` and their
  inverses ``to_jax_resnet_params`` / ``to_jax_yolo_params`` carry the
  vision models' weights across: the same nested dicts and lists, each
  4-D leaf (a conv kernel) turned from the JAX package's HWIO into the
  port's OIHW (stored ``channels_last``) and back; the inverses give
  numpy arrays.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from torch.distributed.tensor import Shard

from repro_torch.config.base import ModelConfig
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.models.transformer import block_period
from repro_torch.training.optimizer import OptState, QTensor, QTensorLog
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _q_fields(x: Any):
    """(class, children) of a QTensor/QTensorLog of either package, read
    by its fields; None for anything else."""
    if hasattr(x, "log_min") and hasattr(x, "q"):
        return QTensorLog, (x.q, x.log_min, x.log_scale)
    if hasattr(x, "scale") and hasattr(x, "q"):
        return QTensor, (x.q, x.scale)
    return None


def _is_q(x: Any) -> bool:
    return _q_fields(x) is not None


def _tensor(a: Any, device: torch.device, r: Optional[int] = None
            ) -> torch.Tensor:
    """A copy of ``a`` (or of its slice ``r``) on ``device``."""
    if isinstance(a, torch.Tensor):
        return (a if r is None else a[r]).detach().to(device, copy=True)
    a = np.asarray(a)
    a = np.array(a if r is None else a[r])  # writable, contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _leaf_fn(device: torch.device) -> Callable[[Any, Optional[int]], Any]:
    def take(a, r=None):
        q = _q_fields(a)
        if q is None:
            return _tensor(a, device, r)
        cls, children = q
        return cls(*(_tensor(c, device, r) for c in children))
    return take


def _from_jax_layout(tree: Dict[str, Any], cfg: ModelConfig,
                     device: torch.device) -> Dict[str, Any]:
    take = _leaf_fn(device)
    blocks = tree["blocks"]
    period = len(blocks)
    if cfg.num_layers % period:
        raise ValueError(f"{len(blocks)} block positions do not divide "
                         f"{cfg.num_layers} layers")
    layers = [tree_map(lambda a, r=i // period: take(a, r),
                       blocks[i % period], is_leaf=_is_q)
              for i in range(cfg.num_layers)]
    return {"embed": tree_map(take, tree["embed"], is_leaf=_is_q),
            "layers": layers,
            "final_norm": tree_map(take, tree["final_norm"], is_leaf=_is_q)}


def _stack(xs):
    if isinstance(xs[0], (QTensor, QTensorLog)):
        return type(xs[0])(*(torch.stack(cs) for cs in
                             zip(*(x.children() for x in xs))))
    return torch.stack([x.detach() for x in xs])


def _to_jax_layout(tree: Dict[str, Any], cfg: ModelConfig
                   ) -> Dict[str, Any]:
    period = block_period(cfg)
    blocks = []
    for j in range(period):
        reps = tree["layers"][j::period]
        cols = [tree_leaves(t, is_leaf=_is_q) for t in reps]
        blocks.append(tree_unflatten(
            reps[0], [_stack([c[i] for c in cols])
                      for i in range(len(cols[0]))], is_leaf=_is_q))
    same = lambda t: tree_map(lambda x: x if _is_q(x) else x.detach(), t,
                              is_leaf=_is_q)
    return {"embed": same(tree["embed"]), "blocks": blocks,
            "final_norm": same(tree["final_norm"])}


def from_jax_params(tree: Dict[str, Any], cfg: ModelConfig,
                    device: torch.device | str) -> Dict[str, Any]:
    return _from_jax_layout(tree, cfg, torch.device(device))


def to_jax_params(params: Dict[str, Any], cfg: ModelConfig
                  ) -> Dict[str, Any]:
    return _to_jax_layout(params, cfg)


def from_jax_opt_state(state: Any, cfg: ModelConfig,
                       device: torch.device | str) -> OptState:
    """``state``: anything with ``step``, ``m``, ``v`` in the JAX layout
    (the JAX package's ``OptState``, or ``to_jax_opt_state``'s)."""
    device = torch.device(device)
    step = _tensor(state.step, device).to(torch.int32).reshape(())
    return OptState(step, _from_jax_layout(state.m, cfg, device),
                    _from_jax_layout(state.v, cfg, device))


def to_jax_opt_state(state: OptState, cfg: ModelConfig) -> OptState:
    return OptState(state.step.detach(), _to_jax_layout(state.m, cfg),
                    _to_jax_layout(state.v, cfg))


def to_jax_shardings(shardings: Any, cfg: ModelConfig) -> Any:
    """A params sharding tree (``{"embed", "layers", "final_norm"}``) or an
    ``OptState`` of them, in the port's layout -> the JAX layout."""
    if isinstance(shardings, OptState):
        return OptState(shardings.step, to_jax_shardings(shardings.m, cfg),
                        to_jax_shardings(shardings.v, cfg))

    def stacked(ns):
        if _is_q(ns):
            return type(ns)(*(stacked(c) for c in ns.children()))
        return NamedSharding(ns.mesh, tuple(
            Shard(p.dim + 1) if isinstance(p, Shard) else p
            for p in ns.placements))

    leaf = lambda x: isinstance(x, NamedSharding) or _is_q(x)
    keep = lambda t: tree_map(lambda x: x, t, is_leaf=leaf)
    return {"embed": keep(shardings["embed"]),
            "blocks": [tree_map(stacked, shardings["layers"][j], is_leaf=leaf)
                       for j in range(block_period(cfg))],
            "final_norm": keep(shardings["final_norm"])}


def _from_jax_conv_tree(tree: Any, device: torch.device | str) -> Any:
    device = torch.device(device)

    def take(a):
        t = _tensor(a, device)
        if t.dim() == 4:            # HWIO -> OIHW
            t = t.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
        return t
    return tree_map(take, tree)


def _to_jax_conv_tree(tree: Any) -> Any:
    def give(t):
        if t.dim() == 4:            # OIHW -> HWIO
            t = t.permute(2, 3, 1, 0)
        return np.ascontiguousarray(t.detach().cpu().numpy())
    return tree_map(give, tree)


def from_jax_resnet_params(tree: Dict[str, Any], device: torch.device | str
                           ) -> Dict[str, Any]:
    """``jax.tree.map(np.asarray, resnet_init(...))`` -> the port's."""
    return _from_jax_conv_tree(tree, device)


def to_jax_resnet_params(params: Dict[str, Any]) -> Dict[str, Any]:
    return _to_jax_conv_tree(params)


def from_jax_yolo_params(tree: Dict[str, Any], device: torch.device | str
                         ) -> Dict[str, Any]:
    """``jax.tree.map(np.asarray, yolo_init(...))`` -> the port's."""
    return _from_jax_conv_tree(tree, device)


def to_jax_yolo_params(params: Dict[str, Any]) -> Dict[str, Any]:
    return _to_jax_conv_tree(params)
