"""Logical-axis sharding rules.

Every tensor dimension in the model carries a *logical* name ("batch",
"heads", "mlp", ...). A :class:`RuleSet` maps logical names to an ordered
tuple of physical mesh axes. The resolver assigns mesh axes to dims with two
safety properties that make the 40-cell dry-run robust:

* **divisibility fallback** — a mesh axis whose size does not divide the dim
  is dropped (e.g. ``kv_heads=10`` over ``model=16`` resolves to replicated),
  never an error;
* **no double-use** — a mesh axis is used by at most one dim of a tensor.

The rules, the context and the resolver are the JAX package's
(``src/repro/distributed/sharding.py``). A resolved spec is a tuple in
``PartitionSpec``'s canonical form: one entry a dim, ``None``, a mesh axis
name or a tuple of names, trailing ``None`` s trimmed. A mesh is a
``DeviceMesh`` with named dims, or an :class:`AbstractMesh` (sizes and
names, no ranks) for resolution alone.

A spec becomes DTensor placements (:func:`placements`): ``Shard(d)`` on
each mesh dim that shards tensor dim ``d``, ``Replicate()`` on the rest.
DTensor splits a dim sharded over several mesh dims in mesh-dim order,
the outer dim's chunks major, which is how JAX lays out ``("pod",
"data")``; the two agree only when a spec's tuple follows the mesh's
order, so :func:`placements` refuses any other (every rule is written in
mesh order). A sharding is the ``(mesh, placements)`` pair
(:class:`NamedSharding`).

:func:`shard` redistributes a DTensor under an active mesh and is the
identity otherwise; no model calls it yet.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import (Any, Callable, Dict, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

Logical = Tuple[Optional[str], ...]
SpecEntry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[SpecEntry, ...]


@dataclass(frozen=True)
class AbstractMesh:
    """Mesh axis sizes and names without ranks (as JAX's
    ``AbstractMesh(axis_sizes, axis_names)``), for resolving specs."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]


Mesh = Union[DeviceMesh, AbstractMesh]


class NamedSharding(NamedTuple):
    """A tensor's sharding: its mesh and one placement a mesh dim."""

    mesh: Mesh
    placements: Tuple[Placement, ...]


@dataclass(frozen=True)
class RuleSet:
    """Mapping logical axis name -> ordered physical mesh axes to try."""

    rules: Dict[str, Tuple[str, ...]]

    def get(self, name: Optional[str]) -> Tuple[str, ...]:
        if name is None:
            return ()
        return self.rules.get(name, ())

    def override(self, **kw: Tuple[str, ...]) -> "RuleSet":
        d = dict(self.rules)
        d.update(kw)
        return RuleSet(d)


# ---------------------------------------------------------------------------
# Default rule tables. ``pod`` only exists on the multi-pod mesh; the
# resolver silently skips axes missing from the mesh.
# ---------------------------------------------------------------------------
def train_rules() -> RuleSet:
    return RuleSet({
        # activations
        "batch": ("pod", "data"),
        "seq": (),
        "embed_act": (),
        "heads_act": ("model",),
        "mlp_act": ("model",),
        "vocab_act": ("model",),
        "expert_act": ("model",),
        "expert_flat": ("model",),
        "kv_seq": ("model",),
        # params: fsdp over (pod,data), tensor-parallel over model
        "p_vocab": ("model",),
        "p_embed": ("pod", "data"),
        "p_heads": ("model",),
        "p_kv_heads": ("model",),
        "p_mlp": ("model",),
        "p_expert": ("model",),
        "p_inner": ("model",),        # mamba d_inner
        "p_state": (),
        "p_head_dim": (),
        "p_ff_fsdp": ("pod", "data"),  # second fsdp-able dim for expert w
    })


def serve_rules(serve_fsdp: bool = False, batch1: bool = False) -> RuleSet:
    fsdp: Tuple[str, ...] = ("pod", "data") if serve_fsdp else ()
    return RuleSet({
        "batch": ("pod", "data"),
        "seq": (),
        "embed_act": (),
        "heads_act": ("model",),
        "mlp_act": ("model",),
        "vocab_act": ("model",),
        "expert_act": ("model",),
        "expert_flat": ("model",),
        # decode caches: sequence-sharded (flash-decode combine); when
        # batch==1 the data axis is idle, so shard kv_seq over both.
        "kv_seq": ("pod", "data", "model") if batch1 else ("model",),
        "p_vocab": ("model",),
        "p_embed": fsdp,
        "p_heads": ("model",),
        "p_kv_heads": ("model",),
        "p_mlp": ("model",),
        "p_expert": ("model",),
        "p_inner": ("model",),
        "p_state": (),
        "p_head_dim": (),
        "p_ff_fsdp": fsdp,
    })


# ---------------------------------------------------------------------------
# Context.
# ---------------------------------------------------------------------------
class _Ctx(threading.local):
    def __init__(self) -> None:
        self.mesh: Optional[Mesh] = None
        self.rules: Optional[RuleSet] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_sharding(mesh: Optional[Mesh], rules: Optional[RuleSet]):
    """Activate (mesh, rules) for `shard()` calls."""
    old = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = old


def active_mesh() -> Optional[Mesh]:
    return _CTX.mesh


# ---------------------------------------------------------------------------
# Resolution.
# ---------------------------------------------------------------------------
def axis_sizes(mesh: Mesh) -> Dict[str, int]:
    """Mesh axis name -> size, in mesh order."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.axis_sizes))
    if mesh.mesh_dim_names is None:
        raise ValueError("a mesh for logical sharding needs named dims")
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def resolve_spec(shape: Sequence[int], logical: Logical, rules: RuleSet,
                 mesh: Mesh) -> Spec:
    """Resolve logical names to a spec honoring divisibility and
    single-use of mesh axes."""
    assert len(shape) == len(logical), (shape, logical)
    used: set = set()
    out: list = []
    sizes = axis_sizes(mesh)
    for dim, name in zip(shape, logical):
        cand = [a for a in rules.get(name)
                if a in sizes and a not in used]
        # Greedily keep a prefix of candidate axes whose product divides dim.
        chosen: list = []
        prod = 1
        for a in cand:
            if dim % (prod * sizes[a]) == 0:
                chosen.append(a)
                prod *= sizes[a]
        for a in chosen:
            used.add(a)
        if not chosen:
            out.append(None)
        elif len(chosen) == 1:
            out.append(chosen[0])
        else:
            out.append(tuple(chosen))
    # Trim trailing Nones (canonical form).
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _axes(entry: SpecEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: Spec, mesh: Mesh) -> Tuple[Placement, ...]:
    """One placement a mesh dim: ``Shard(d)`` where the spec's dim ``d``
    names that mesh axis, else ``Replicate()``. A dim over several axes
    must name them in mesh order (see the module docstring)."""
    names = list(axis_sizes(mesh))
    owner: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: dim {d} names {axes} out of "
                             f"the mesh's order {tuple(names)}")
        for a in axes:
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in names)


def shard_shape(shape: Sequence[int], spec: Spec,
                mesh: Mesh) -> Tuple[int, ...]:
    """The local shard's shape under ``spec`` (JAX's
    ``NamedSharding.shard_shape``); the resolver keeps it exact."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in _axes(entry))
        assert out[d] % n == 0, (shape, spec)
        out[d] //= n
    return tuple(out)


def named_sharding(shape: Sequence[int], logical: Logical,
                   mesh: Optional[Mesh] = None,
                   rules: Optional[RuleSet] = None
                   ) -> Optional[NamedSharding]:
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None or rules is None:
        return None
    return NamedSharding(mesh, placements(
        resolve_spec(shape, logical, rules, mesh), mesh))


def shard(x: torch.Tensor, logical: Logical) -> torch.Tensor:
    """Redistribute a DTensor to its logical sharding (the identity
    without a mesh context, or on a plain tensor)."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or rules is None or not isinstance(x, DTensor):
        return x
    spec = resolve_spec(x.shape, logical, rules, mesh)
    return x.redistribute(mesh, placements(spec, mesh))


def is_spec(t: Any) -> bool:
    """A logical spec: a tuple of names and ``None`` s (``()`` included)."""
    return isinstance(t, tuple) and not hasattr(t, "_fields") and all(
        isinstance(e, (str, type(None))) for e in t)


def map_specs(fn: Callable[[Any, Logical], Any], tree: Any,
              specs: Any) -> Any:
    """``fn(leaf, spec)`` over a tree and its spec tree, which has the
    tree's structure with a spec where the tree has a leaf: nested dicts
    and lists, ``NamedTuple`` s (``OptState``) and objects with
    ``children()`` (the optimizer's ``QTensor``/``QTensorLog``, rebuilt
    from their children). The result has the spec tree's structure."""
    if is_spec(specs):
        return fn(tree, specs)
    if isinstance(specs, dict):
        return {k: map_specs(fn, tree[k], s) for k, s in specs.items()}
    if hasattr(specs, "children"):
        return type(specs)(*(map_specs(fn, t, s) for t, s in
                             zip(tree.children(), specs.children())))
    if hasattr(specs, "_fields"):
        return type(specs)(*(map_specs(fn, t, s)
                             for t, s in zip(tree, specs)))
    if isinstance(specs, (list, tuple)):
        assert len(tree) == len(specs), (len(tree), len(specs))
        return [map_specs(fn, t, s) for t, s in zip(tree, specs)]
    raise TypeError(f"not a spec tree node: {specs!r}")


def tree_shardings(tree_of_shapes, tree_of_logical, mesh: Mesh,
                   rules: RuleSet):
    """Map (shape-tree, logical-tree) -> NamedSharding tree. A shape leaf
    is a tuple of ints or a tensor (meta tensors included)."""
    def one(shp, lg):
        shape = tuple(shp.shape) if isinstance(shp, torch.Tensor) else shp
        return NamedSharding(mesh, placements(
            resolve_spec(shape, lg, rules, mesh), mesh))
    return map_specs(one, tree_of_shapes, tree_of_logical)
