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
identity otherwise. The models call it at the JAX package's call sites,
in the same logical names, so that under ``use_sharding(mesh, rules)``
the parameters, activations and caches of a model step are DTensors laid
out as GSPMD lays out JAX's, and PyTorch's own DTensor rules carry every
operation between two ``shard()`` calls.

A kernel op runs on local shards (:func:`on_local_shards`, over
``local_map``): each rank calls the kernel on its own shard, and the
results are its shards of the output. The op names the placements of its
inputs. An input that stays whole (``Replicate``) on a mesh dim where the
op's work is split (its primary input's ``Shard`` dims) gets a local
gradient on each rank that covers only that rank's share of the work, so
its gradient placement there is ``Partial()`` (:func:`grad_placements`);
left at ``Replicate``, the step would still run, with each rank's share
taken for the whole gradient.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import (Any, Callable, Dict, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset as _local_shape_and_offset
from torch.distributed.tensor.experimental import local_map

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


def active_rules() -> Optional[RuleSet]:
    return _CTX.rules


# ---------------------------------------------------------------------------
# Resolution.
# ---------------------------------------------------------------------------
def check_mesh_device(mesh: Mesh, device: torch.device, what: str) -> None:
    """Refuse a mesh of another device type than ``device``'s for ``what``
    (an :class:`AbstractMesh` has no device and builds anywhere)."""
    kind = getattr(mesh, "device_type", None)
    if kind is not None and kind != device.type:
        raise ValueError(f"a {kind} mesh for {what} on {device}")


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
    names that mesh axis, else ``Replicate()``; an axis of size 1 splits
    nothing and is ``Replicate()`` (DTensor will not reshape away a dim
    sharded over it, a batch of 1 at prefill). A dim over several axes
    must name them in mesh order (see the module docstring)."""
    sizes = axis_sizes(mesh)
    names = list(sizes)
    owner: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: dim {d} names {axes} out of "
                             f"the mesh's order {tuple(names)}")
        for a in axes:
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner and sizes[a] > 1
                 else Replicate() for a in names)


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


def _map_tree(fn, tree, other, at_leaf: Callable[[Any], bool]) -> Any:
    if at_leaf(other):
        return fn(tree, other)
    if isinstance(other, dict):
        return {k: _map_tree(fn, tree[k], s, at_leaf)
                for k, s in other.items()}
    if hasattr(other, "children"):
        return type(other)(*(_map_tree(fn, t, s, at_leaf) for t, s in
                             zip(tree.children(), other.children())))
    if hasattr(other, "_fields"):
        return type(other)(*(_map_tree(fn, t, s, at_leaf)
                             for t, s in zip(tree, other)))
    if isinstance(other, (list, tuple)):
        assert len(tree) == len(other), (len(tree), len(other))
        return [_map_tree(fn, t, s, at_leaf) for t, s in zip(tree, other)]
    raise TypeError(f"not a spec or sharding tree node: {other!r}")


def map_specs(fn: Callable[[Any, Logical], Any], tree: Any,
              specs: Any) -> Any:
    """``fn(leaf, spec)`` over a tree and its spec tree, which has the
    tree's structure with a spec where the tree has a leaf: nested dicts
    and lists, ``NamedTuple`` s (``OptState``) and objects with
    ``children()`` (the optimizer's ``QTensor``/``QTensorLog``, rebuilt
    from their children). The result has the spec tree's structure."""
    return _map_tree(fn, tree, specs, is_spec)


def map_shardings(fn: Callable[[Any, NamedSharding], Any], tree: Any,
                  shardings: Any) -> Any:
    """``fn(leaf, sharding)`` over a tree and its sharding tree (what
    :func:`tree_shardings` gives), as :func:`map_specs`."""
    return _map_tree(fn, tree, shardings,
                     lambda s: isinstance(s, NamedSharding))


def tree_shardings(tree_of_shapes, tree_of_logical, mesh: Mesh,
                   rules: RuleSet):
    """Map (shape-tree, logical-tree) -> NamedSharding tree. A shape leaf
    is a tuple of ints or a tensor (meta tensors included)."""
    def one(shp, lg):
        shape = tuple(shp.shape) if isinstance(shp, torch.Tensor) else shp
        return NamedSharding(mesh, placements(
            resolve_spec(shape, lg, rules, mesh), mesh))
    return map_specs(one, tree_of_shapes, tree_of_logical)


# ---------------------------------------------------------------------------
# Kernels on local shards.
# ---------------------------------------------------------------------------
def compute_local_shape_and_global_offset(shape, mesh, plc):
    """DTensor's ``compute_local_shape_and_global_offset``, out of any
    fake-tensor mode: it computes with tensors and reads them back, which a
    fake tensor cannot (the dry run traces under one)."""
    with unset_fake_temporarily():
        return _local_shape_and_offset(shape, mesh, plc)


def replicated(t: torch.Tensor, like: Any) -> torch.Tensor:
    """``t`` (the same on every rank) as a DTensor replicated over the mesh
    of ``like`` where ``like`` is a DTensor; ``t`` itself otherwise. For
    the tensors a model step makes from scratch (RoPE tables, masks) that
    meet its DTensors."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _Gather(torch.autograd.Function):
    """``x`` redistributed to ``plc``; the gradient passes back in the
    placements it comes in (value for value the same tensor), not
    redistributed to ``x``'s own, which may be the very split that the
    gather undid."""

    @staticmethod
    def forward(ctx, x: DTensor, plc: Tuple[Placement, ...]) -> DTensor:
        return x.redistribute(x.device_mesh, plc)

    @staticmethod
    def backward(ctx, grad: DTensor):
        return grad, None


class _OwnGrad(torch.autograd.Function):
    """``x`` itself; its gradient redistributed to ``x``'s own placements
    on the way back."""

    @staticmethod
    def forward(ctx, x: DTensor) -> DTensor:
        ctx.plc = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: DTensor) -> DTensor:
        return grad.redistribute(grad.device_mesh, ctx.plc)


def own_grad(x: DTensor) -> DTensor:
    """``x``, for one of several uses of a leaf (a tied embedding's lookup
    and its unembedding): each use hands its gradient back in the leaf's
    own placements, so autograd sums like with like (torch 2.11's DTensor
    cannot add a ``Partial`` gradient to a ``Shard`` one: it would turn
    the shard into a partial)."""
    return _OwnGrad.apply(x)


def _whole_head_placements(x: DTensor, h: int) -> Tuple[Placement, ...]:
    """``x``'s placements (x (..., h * k)) with the mesh dims that would
    split its last dim into pieces other than whole groups of ``k`` made
    ``Replicate``: in mesh order, a dim that shards the last dim stays
    while the product of the sizes kept divides ``h``."""
    mesh, kept, out = x.device_mesh, 1, []
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim % x.ndim == x.ndim - 1:
            if h % (kept * mesh.size(i)):
                p = Replicate()
            else:
                kept *= mesh.size(i)
        out.append(p)
    return tuple(out)


def whole_heads(y: DTensor, h: int) -> DTensor:
    """``y`` (..., h * k) with every mesh dim that splits its last dim
    into pieces other than whole groups of ``k``
    (:func:`_whole_head_placements`) gathered (``Replicate``), so the last
    dim splits into (h, k); ``y`` itself where none does."""
    plc = _whole_head_placements(y, h)
    if plc == tuple(y.placements):
        return y
    return _Gather.apply(y, plc)


class _WholeHeadsGrad(torch.autograd.Function):
    """``x`` itself; its gradient gathered over the mesh dims that split
    its last dim into pieces other than whole heads on the way back."""

    @staticmethod
    def forward(ctx, x: DTensor, h: int) -> DTensor:
        ctx.h = h
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: DTensor):
        plc = _whole_head_placements(grad, ctx.h)
        if plc != tuple(grad.placements):
            grad = grad.redistribute(grad.device_mesh, plc)
        return grad, None


def whole_heads_grad(y: torch.Tensor, h: int) -> torch.Tensor:
    """``y`` (..., h * k), flattened from (..., h, k), for a product that
    follows: its gradient comes back split into whole heads (DTensor
    splits a product's input gradient over whatever mesh dim it likes,
    16 pieces of 48 columns for 12 heads of 64), so that the backward of
    the flatten can unflatten it. ``y`` itself off a mesh."""
    if not isinstance(y, DTensor):
        return y
    return _WholeHeadsGrad.apply(y, h)


def kernel_placements(x: DTensor, logical: Logical
                      ) -> Tuple[Placement, ...]:
    """The placements a kernel takes ``x`` in: its logical spec resolved
    under the active rules on ``x``'s mesh."""
    rules = _CTX.rules
    if rules is None:
        raise ValueError("a kernel on DTensors runs under use_sharding()")
    mesh = x.device_mesh
    return placements(resolve_spec(x.shape, logical, rules, mesh), mesh)


def row_placements(x: DTensor, whole_dims: Sequence[int]
                   ) -> Tuple[Placement, ...]:
    """``x``'s placements with every ``Partial`` and every shard of a dim
    in ``whole_dims`` made ``Replicate``: the rows stay where they are."""
    whole = {d % x.ndim for d in whole_dims}
    return tuple(p if isinstance(p, Shard) and p.dim % x.ndim not in whole
                 else Replicate() for p in x.placements)


def grad_placements(own: Sequence[Placement], work: Sequence[Placement]
                    ) -> Tuple[Placement, ...]:
    """An input's gradient placements: ``Partial()`` where the input is
    whole (``Replicate``) but the work is split (``work``, the placements
    of the op's primary input, is ``Shard``), each rank holding the
    gradient of its own share; the input's own placement elsewhere."""
    return tuple(Partial() if isinstance(w, Shard) and isinstance(p, Replicate)
                 else p for p, w in zip(own, work))


def local_slice(x: DTensor, plc: Sequence[Placement], dim: int
                ) -> Tuple[int, int]:
    """(offset, length) along ``dim`` of this rank's shard of ``x`` laid
    out in ``plc``."""
    shape, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, list(plc))
    return offset[dim], shape[dim]


def on_local_shards(fn: Callable, mesh: DeviceMesh, in_placements,
                    out_placements, in_grad_placements) -> Callable:
    """``fn`` over local shards (``local_map``): each DTensor argument is
    redistributed to its entry of ``in_placements`` (None for an argument
    that is not a DTensor) and given to ``fn`` as its local tensor; ``fn``'s
    outputs become DTensors in ``out_placements`` (one placement tuple for
    a single output, a tuple of them for several); the backward gives each
    input's gradient in its entry of ``in_grad_placements``."""
    def one(plc):
        return None if plc is None else list(plc)

    def each(plcs):
        return None if plcs is None else tuple(one(p) for p in plcs)

    single = all(isinstance(p, Placement) for p in out_placements)
    return local_map(fn, out_placements=(one(out_placements) if single
                                         else each(out_placements)),
                     in_placements=each(in_placements),
                     in_grad_placements=each(in_grad_placements),
                     device_mesh=mesh, redistribute_inputs=True)


def distribute(t: torch.Tensor, ns: NamedSharding) -> DTensor:
    """``t``, the whole tensor (the same on every rank, on any device), as
    a DTensor laid out by ``ns``: each rank copies its own slice to the
    mesh's device; nothing crosses ranks. A slice that is the whole tensor
    on the mesh's device is taken without a copy."""
    mesh, plc = ns.mesh, list(ns.placements)
    shape, offset = compute_local_shape_and_global_offset(t.shape, mesh, plc)
    local = t
    if tuple(shape) != tuple(t.shape):
        local = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))
                  ].clone(memory_format=torch.contiguous_format)
    local = local.to(mesh.device_type)
    return DTensor.from_local(local, mesh, plc, run_check=False,
                              shape=t.shape,
                              stride=torch.empty(t.shape,
                                                 device="meta").stride())


def place(t: torch.Tensor, ns: NamedSharding) -> DTensor:
    """``t`` laid out by ``ns``: a DTensor redistributed where its
    placements differ, a whole tensor distributed (:func:`distribute`)."""
    if isinstance(t, DTensor):
        if tuple(t.placements) == tuple(ns.placements):
            return t
        return t.redistribute(ns.mesh, ns.placements)
    return distribute(t, ns)


def distribute_tree(tree: Any, shardings: Any) -> Any:
    """Lay out a tree of nested dicts and lists of whole tensors by its
    sharding tree, in place and leaf by leaf: each whole tensor is dropped
    from the tree as soon as its shard takes its place, so a whole copy
    and the sharded one coexist one leaf at a time. Returns ``tree``."""
    keys = tree.keys() if isinstance(tree, dict) else range(len(tree))
    for k in keys:
        if isinstance(shardings[k], NamedSharding):
            tree[k] = place(tree[k], shardings[k])
        else:
            distribute_tree(tree[k], shardings[k])
    return tree


def zeros(shape: Sequence[int], dtype: torch.dtype,
          ns: NamedSharding) -> DTensor:
    """A DTensor of zeros laid out by ``ns``, each rank allocating only its
    shard."""
    mesh, plc = ns.mesh, list(ns.placements)
    local_shape, _ = compute_local_shape_and_global_offset(
        tuple(shape), mesh, plc)
    local = torch.zeros(local_shape, dtype=dtype, device=mesh.device_type)
    return DTensor.from_local(local, mesh, plc, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())
