"""The recorder of the dry run: what a step traced on fake tensors costs
one chip. It is the port's counterpart of the JAX package's
``compiled.cost_analysis()``, ``compiled.memory_analysis()`` and HLO
collective parse (``src/repro/launch/dryrun.py:49-64,145-149``).

:class:`Recorder` is a ``TorchDispatchMode``. An op on DTensors it hands
back to DTensor (``NotImplemented``, as ``CommDebugMode`` does), so what it
counts are the ops DTensor then runs on rank 0's **local** shards, and the
collectives it issues for them; a count on the DTensor level would be of
the global product (``FlopCounterMode`` entered around DTensor code counts
a matmul 256x over on a 16 x 16 mesh). DTensor's sharding propagation
also runs each new op once on global fake tensors to learn the output's
shape; those runs are not counted (:func:`_propagating`).

* **FLOPs**: ``FlopCounterMode``'s formulas (``flop_registry``, 2 a
  multiply-add), applied as it applies them, to local shapes.
* **HBM bytes**: each local op's tensor inputs read once and its outputs
  written once; a view moves nothing, and neither does an allocation that
  writes nothing (``empty``). Eager PyTorch fuses nothing, so this is what
  the port moves, not XLA's post-fusion count.
* **Kernels**: a hand-written kernel's fake path (``kernels/*.py``) calls
  :func:`record_kernel` with its :mod:`kernel_cost` and is counted as one
  op of its own, apart from the aten ops; its launches are not counted
  (``launch_counts()`` counts real launches only).
* **Collectives**: each functional or c10d collective's kind, result
  bytes and group size, turned into wire bytes by
  ``analysis.wire_bytes``. On a CPU mesh DTensor runs an all-to-all as an
  all-gather and a chunk, and it is counted as what ran.
* **Memory**: live fake storage, by storage, allocated and freed as the
  eager trace allocates and frees it; ``memory_analysis`` forms the JAX
  package's keys from it.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Set

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.analysis import CollectiveStats
from repro_torch.roofline.kernel_cost import Cost

aten = torch.ops.aten
_funcol = torch.ops._c10d_functional
_c10d = torch.ops.c10d

# FlopCounterMode hands these back untouched (size and layout queries).
_QUERIES = {aten.sym_is_contiguous.default, aten.is_contiguous.default,
            aten.is_contiguous.memory_format,
            aten.is_strides_like_format.default,
            aten.is_non_overlapping_and_dense.default, aten.size.default,
            aten.sym_size.default, aten.stride.default,
            aten.sym_stride.default, aten.storage_offset.default,
            aten.sym_storage_offset.default, aten.numel.default,
            aten.sym_numel.default, aten.dim.default,
            torch.ops.prim.layout.default}
# Ops that move no data: allocations that write nothing, and views the
# schema does not mark as views.
_NO_WRITE = {aten.empty.memory_format, aten.empty_like.default,
             aten.empty_strided.default, aten.new_empty.default,
             aten.new_empty_strided.default, aten._unsafe_view.default,
             aten.lift_fresh.default}
# Writes of a few rows into a tensor in place: the rows are read and
# written, the rest of the tensor is not touched.
_ROW_WRITES = {aten.index_put_.default, aten._index_put_impl_.default,
               aten.index_copy_.default, aten.scatter_.src,
               aten.scatter_.value, aten.scatter_add_.default}
# Collectives by op packet: (kind, how the group is named). The functional
# ops name it by string, the c10d ops pass the ProcessGroup.
_FUNCOL = {_funcol.all_gather_into_tensor: "all-gather",
           _funcol.all_reduce: "all-reduce",
           _funcol.reduce_scatter_tensor: "reduce-scatter",
           _funcol.all_to_all_single: "all-to-all",
           _funcol.all_gather_into_tensor_coalesced: "all-gather",
           _funcol.all_reduce_coalesced: "all-reduce",
           _funcol.reduce_scatter_tensor_coalesced: "reduce-scatter"}
_C10D = {_c10d.allreduce_: "all-reduce", _c10d._allgather_base_: "all-gather",
         _c10d.allgather_: "all-gather",
         _c10d._reduce_scatter_base_: "reduce-scatter",
         _c10d.reduce_scatter_: "reduce-scatter",
         _c10d.alltoall_base_: "all-to-all", _c10d.alltoall_: "all-to-all"}
# DTensor's own all-to-all of a shard dim (a CUDA mesh; a CPU one gathers).
try:
    _FUNCOL[torch.ops._dtensor.shard_dim_alltoall] = "all-to-all"
except AttributeError:      # a torch without it
    pass

# DTensor's sharding propagation, wrapped while a recorder is active so
# that the ops it runs on global fake tensors are not counted.
_PROP = threading.local()


def _propagating() -> bool:
    return getattr(_PROP, "depth", 0) > 0


@contextlib.contextmanager
def _mark_propagation():
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def marked(self, *args, **kwargs):
        _PROP.depth = getattr(_PROP, "depth", 0) + 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            _PROP.depth -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


@dataclass
class KernelTally:
    calls: int = 0
    flops: float = 0.0
    bytes: float = 0.0


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_tensors(tree: Any) -> List[torch.Tensor]:
    """The local tensors of a tree (a DTensor's local shard): what rank 0
    holds of it."""
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in _tensors(tree)]


def local_bytes(tree: Any) -> int:
    """Bytes rank 0 holds of a tree's tensors, each storage once."""
    seen: Set[int] = set()
    total = 0
    for t in local_tensors(tree):
        st = t.untyped_storage()
        key = id(st)
        if key not in seen:
            seen.add(key)
            total += st.nbytes()
    return total


class Recorder(TorchDispatchMode):
    """Counts rank 0's local ops of whatever runs under it (see the module
    docstring). Enter it around one step; read :attr:`flops`,
    :attr:`bytes`, :attr:`kernels`, :attr:`collectives` and
    :meth:`memory_analysis`."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0.0            # aten ops, the kernels' apart
        self.bytes = 0.0
        self.ops = 0
        self.kernels: Dict[str, KernelTally] = {}
        self.collectives = CollectiveStats()
        # Live storage allocated under the recorder: (+/- bytes, key) in
        # the order of the trace.
        self._events: List[tuple] = []
        self._live: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._depth = 0
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        if self._depth == 0:
            self._stack.enter_context(_mark_propagation())
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                self._stack.close()

    # -- totals ------------------------------------------------------------
    @property
    def kernel_flops(self) -> float:
        return sum(k.flops for k in self.kernels.values())

    @property
    def kernel_bytes(self) -> float:
        return sum(k.bytes for k in self.kernels.values())

    def kernel_calls(self) -> Dict[str, int]:
        return {name: k.calls for name, k in sorted(self.kernels.items())}

    def cost(self) -> Dict[str, float]:
        """The JAX package's ``cost_analysis()`` keys the roofline reads:
        aten ops and kernels together."""
        return {"flops": self.flops + self.kernel_flops,
                "bytes accessed": self.bytes + self.kernel_bytes}

    # -- memory ------------------------------------------------------------
    def _track(self, ins: Iterable[torch.Tensor],
               outs: Iterable[torch.Tensor]) -> None:
        """Count the storages an op's outputs hold that none of its inputs
        held (a view or an in-place op allocates nothing)."""
        held = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in held or key in self._live:
                continue
            n = st.nbytes()
            with self._lock:
                self._live[key] = n
                self._events.append((n, key))
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        with self._lock:
            n = self._live.pop(key, None)
            if n is not None:
                self._events.append((-n, key))

    def temp_bytes(self, exclude: Iterable[torch.Tensor] = ()) -> int:
        """The peak of storage allocated under the recorder and live at
        once, less the storages of ``exclude`` (the step's new outputs,
        which ``output_size_in_bytes`` counts)."""
        skip = {id(t.untyped_storage()) for t in exclude}
        live = peak = 0
        with self._lock:
            for n, key in self._events:
                if key not in skip:
                    live += n
                    peak = max(peak, live)
        return peak

    def memory_analysis(self, args: Any, outputs: Any,
                        aliased: Any) -> Dict[str, float]:
        """The JAX package's ``_memory_analysis_dict`` keys, per chip:
        ``args`` the step's inputs, ``outputs`` its results, ``aliased``
        the inputs it updates in place (params and optimizer state in
        training, caches in decode), which XLA counts as aliased outputs.
        Outputs that are not inputs are left out of the temp peak, as XLA
        keeps them out of its temp buffers."""
        arg_keys = {id(t.untyped_storage()) for t in local_tensors(args)}
        new_outs = [t for t in local_tensors(outputs)
                    if id(t.untyped_storage()) not in arg_keys]
        out = {"argument_size_in_bytes": float(local_bytes(args)),
               "output_size_in_bytes": float(local_bytes(outputs)),
               "temp_size_in_bytes": float(self.temp_bytes(new_outs)),
               "generated_code_size_in_bytes": 0.0,
               "alias_size_in_bytes": float(local_bytes(aliased))}
        out["total_nonalias_bytes"] = (
            out["argument_size_in_bytes"] + out["output_size_in_bytes"]
            + out["temp_size_in_bytes"] - out["alias_size_in_bytes"])
        return out

    # -- ops ---------------------------------------------------------------
    def record_kernel(self, name: str, cost: Cost) -> None:
        k = self.kernels.setdefault(name, KernelTally())
        k.calls += 1
        k.flops += float(cost.ops)
        k.bytes += float(cost.bytes)

    def _collective(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if packet in _FUNCOL:
            kind = _FUNCOL[packet]
            name = args[-1] if isinstance(args[-1], str) else \
                kwargs.get("group_name")
            group = dist.distributed_c10d._resolve_process_group(name).size()
        else:
            kind = _C10D[packet]
            pg = next(a for a in args if isinstance(
                a, (torch.ScriptObject, dist.ProcessGroup)))
            if isinstance(pg, torch.ScriptObject):
                pg = dist.ProcessGroup.unbox(pg)
            group = pg.size()
        result = _tensors(out) if packet in _FUNCOL else _tensors(args[0])
        self.collectives.add(kind, float(sum(map(_nbytes, result))), group)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # let DTensor run it on local shards
        if _propagating():
            return func(*args, **kwargs)
        if func in _QUERIES:
            return NotImplemented
        if isinstance(func, torch._ops.HigherOrderOperator):
            return NotImplemented
        if func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if packet in _FUNCOL or packet in _C10D:
            self._collective(func, args, kwargs, out)
        elif func in _ROW_WRITES:
            self.bytes += 2 * sum(map(_nbytes, _tensors((args[1:], kwargs))))
        elif outs and not func.is_view and func not in _NO_WRITE and \
                packet is not _funcol.wait_tensor:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.ops += 1
        self._track(ins, outs)
        return out


def active_recorder() -> Optional[Recorder]:
    """The innermost :class:`Recorder` on the dispatch mode stack, if any
    (the stack follows the autograd engine onto its threads)."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, Recorder):
            return mode
    return None


def record_kernel(name: str, cost: Cost) -> None:
    """Count one call of kernel ``name`` with ``cost`` on the active
    recorder (a kernel's fake path; nothing when no dry run records)."""
    rec = active_recorder()
    if rec is not None:
        rec.record_kernel(name, cost)
