"""Atomic, retention-managed checkpointing in the JAX package's on-disk
layout (``src/repro/training/checkpoint.py``):

    <dir>/step_<n>/manifest.json       # keypath -> {file, shape, dtype}
    <dir>/step_<n>/leaf_NNNNN.npy
    <dir>/LATEST                       # contains "step_<n>"

Keys are JAX keypaths: dict keys, list indices, NamedTuple field names and
the children of ``QTensor``/``QTensorLog`` (0, 1, 2), joined by ``/``;
dict keys are visited sorted, as JAX flattens them, so the same tree gives
the same leaf files. bf16 leaves are written as their raw uint16 bits with
dtype ``bfloat16``. A tree in the JAX layout (``convert.to_jax_params``,
``convert.to_jax_opt_state``) therefore restores in either package.

Guarantees, as in the JAX package: atomic (written into
``.tmp-step_<n>``, then renamed; ``LATEST`` replaced by rename), retention
of the last ``keep``, and ``save_async``, which copies every leaf to host
memory before it returns (the trainer updates its tensors in place) and
writes on a worker thread.

On a mesh (DTensor leaves) every rank calls ``save``/``save_async``: the
whole of each leaf is gathered (``full_tensor()``, a collective) on the
calling thread, leaf by leaf in the same order on every rank, and only
rank 0 writes; the worker thread does file I/O alone, since a collective
issued there could deadlock against the next step. ``wait()`` ends in a
barrier, so that no rank reads a checkpoint before it is written.
``restore(..., shardings=)`` is the elastic path: each rank builds its
local shard of each leaf from the host array, sliced as the leaf's
placements give, on whatever mesh the shardings name.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import NamedSharding, distribute
from repro_torch.training.optimizer import QTensor, QTensorLog

Params = Any


def _children(node: Any) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of a container node, None for a leaf."""
    if isinstance(node, NamedSharding):
        return None
    if isinstance(node, (QTensor, QTensorLog)):
        return [(str(i), c) for i, c in enumerate(node.children())]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if hasattr(node, "_fields"):            # NamedTuple (OptState)
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _flatten(tree: Params, prefix: str = "") -> List[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k, c in kids:
        out += _flatten(c, f"{prefix}/{k}" if prefix else k)
    return out


def _rebuild(template: Params, leaf_fn, prefix: str = "") -> Params:
    """``template``'s structure, leaf ``key`` replaced by leaf_fn(key,
    leaf)."""
    kids = _children(template)
    if kids is None:
        return leaf_fn(prefix, template)
    new = {k: _rebuild(c, leaf_fn, f"{prefix}/{k}" if prefix else k)
           for k, c in kids}
    if isinstance(template, (QTensor, QTensorLog)):
        return type(template)(*(new[str(i)] for i in range(len(new))))
    if isinstance(template, dict):
        return {k: new[str(k)] for k in template}
    if hasattr(template, "_fields"):
        return type(template)(**new)
    return [new[str(i)] for i in range(len(template))]


def _host(leaf: Any) -> Tuple[np.ndarray, str]:
    """A host copy of a leaf as numpy; bf16 as its uint16 bits. A DTensor
    is gathered whole first (a collective)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.detach().full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.array(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _write(ckpt_dir: str, step: int, flat: List[Tuple[str, Any]],
           keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, f".tmp-{name}")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest: Dict[str, Dict] = {}
    for i, (key, (arr, dtype_name)) in enumerate(flat):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr, allow_pickle=False)
        manifest[key] = {"file": fname, "shape": list(arr.shape),
                         "dtype": dtype_name}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # LATEST pointer (atomic via rename).
    latest_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(name)
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    _apply_retention(ckpt_dir, keep)
    return final


def _snapshot(tree: Params) -> Tuple[List[Tuple[str, Any]], bool, bool]:
    """(host copies of the leaves, whether any was a DTensor, whether this
    rank writes: every rank without a mesh, rank 0 with one)."""
    flat = _flatten(tree)
    sharded = any(isinstance(l, DTensor) for _, l in flat)
    host = [(k, _host(l)) for k, l in flat]
    return host, sharded, not sharded or dist.get_rank() == 0


def save(ckpt_dir: str, step: int, tree: Params, keep: int = 3) -> str:
    """Synchronous atomic save. Returns the checkpoint path."""
    flat, sharded, writes = _snapshot(tree)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if writes:
        path = _write(ckpt_dir, step, flat, keep)
    if sharded:
        dist.barrier()
    return path


class AsyncSave:
    def __init__(self, thread: Optional[threading.Thread],
                 sharded: bool = False):
        self._thread = thread
        self._sharded = sharded

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
        if self._sharded:
            dist.barrier()


def save_async(ckpt_dir: str, step: int, tree: Params,
               keep: int = 3) -> AsyncSave:
    """Snapshot to host memory now; write on a worker thread."""
    flat, sharded, writes = _snapshot(tree)
    t = None
    if writes:
        t = threading.Thread(target=_write,
                             args=(ckpt_dir, step, flat, keep), daemon=True)
        t.start()
    return AsyncSave(t, sharded)


def _apply_retention(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    latest = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str, template: Params, step: Optional[int] = None,
            device: Optional[torch.device | str] = None,
            shardings: Optional[Params] = None) -> Params:
    """Restore into the structure of ``template``: each leaf a tensor of
    the template leaf's dtype, on ``device`` (default: the template
    leaf's; the template may hold meta tensors, shapes alone). With
    ``shardings`` (a tree of ``NamedSharding`` s of the template's
    structure) each leaf is a DTensor laid out by its sharding, built from
    this rank's slice of the host array; ``device`` is then the mesh's."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]

    layout = dict(_flatten(shardings)) if shardings is not None else {}

    def load(key: str, tmpl: Any) -> torch.Tensor:
        if key not in manifest:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        entry = manifest[key]
        arr = np.load(os.path.join(path, entry["file"]), allow_pickle=False)
        if entry["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if key in layout:
            if isinstance(tmpl, torch.Tensor):
                t = t.to(dtype=tmpl.dtype)
            return distribute(t, layout[key])
        if isinstance(tmpl, torch.Tensor):
            t = t.to(device=device or tmpl.device, dtype=tmpl.dtype)
        elif device is not None:
            t = t.to(device)
        return t

    return _rebuild(template, load)


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_"))
