"""GPipe-style pipeline parallelism over a "stage" process group.

Each rank along the ``stage`` mesh dim owns a contiguous chunk of layers
(params pre-stacked with a leading stage dim). Microbatches stream through
the ring: at tick t stage s runs microbatch (t - s), activations hop
stage s -> s+1 (``batch_isend_irecv``). Bubble fraction is the usual
(S-1)/(M+S-1); pick M >= 4*S.

The JAX package's ``distributed/pipeline.py`` in PyTorch: its ``shard_map``
is ``local_map`` over DTensors, its axis name the mesh dim's
``ProcessGroup``. JAX runs every stage at every tick and masks the idle
ones to zero; here an idle stage skips its call and hands on zeros, which
gives the same outputs.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed import ProcessGroup
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.collectives import (as_dtensor, finish_hop,
                                                 post_hop)
from repro_torch.distributed.sharding import placements
from repro_torch.tree import tree_leaves, tree_unflatten

Params = Any


def _shift_right(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """Stage s sends ``x`` to s + 1 and receives s - 1's (a ring)."""
    a = group.size()
    if a == 1:
        return x
    s = dist.get_rank(group)
    return finish_hop(*post_hop(x.contiguous(),
                                dist.get_global_rank(group, (s + 1) % a),
                                dist.get_global_rank(group, (s - 1) % a),
                                group))


def pipeline_forward(stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                     stage_params: Params, x_mb: torch.Tensor,
                     group: ProcessGroup) -> torch.Tensor:
    """Run on one rank. x_mb: (M, mb, ...) microbatched inputs (the same
    on every stage); stage_params: this stage's params. Returns (M, mb, ...)
    outputs on every stage (the last stage's, broadcast by a masked
    all-reduce).
    """
    s_idx = dist.get_rank(group)
    n_stage = group.size()
    m = x_mb.shape[0]
    ticks = m + n_stage - 1

    state = torch.zeros_like(x_mb[0])
    outputs = torch.zeros_like(x_mb)
    for t in range(ticks):
        # Stage 0 ingests microbatch t (if any); others take the incoming
        # activation from the previous stage.
        inp = x_mb[min(t, m - 1)] if s_idx == 0 else state
        if 0 <= t - s_idx < m:
            out = stage_fn(stage_params, inp)
        else:
            out = torch.zeros_like(state)
        # Last stage records its finished microbatch.
        mb_done = t - (n_stage - 1)
        if s_idx == n_stage - 1 and 0 <= mb_done < m:
            outputs[mb_done] = out
        # Everyone forwards to the next stage.
        state = _shift_right(out, group)
    # Broadcast results from the last stage to all stages (masked sum).
    if s_idx != n_stage - 1:
        outputs.zero_()
    dist.all_reduce(outputs, group=group)
    return outputs


def make_pipelined_fn(stage_fn: Callable, mesh: DeviceMesh, n_stages: int,
                      axis_name: str = "stage"):
    """Wrap stage_fn into a pipelined callable over ``mesh``'s
    ``axis_name`` dim.

    stage_params must be stacked with a leading (n_stages,) dim (each
    stage gets its slice: the leading dim is sharded); inputs are
    (M, mb, ...) microbatches, replicated. Full tensors or DTensors in,
    a replicated DTensor out.
    """
    group = mesh.get_group(axis_name)
    if group.size() != n_stages:
        raise ValueError(f"{n_stages} stages on a {axis_name!r} mesh dim "
                         f"of {group.size()}")
    stacked_spec, rep = (axis_name,), ()

    def wrapper(stacked_params, x_mb):
        leaves = tree_leaves(stacked_params)

        def body(*local):
            p = tree_unflatten(stacked_params,
                               [a[0] for a in local[:-1]])
            return pipeline_forward(stage_fn, p, local[-1], group)

        fn = local_map(
            body, out_placements=list(placements(rep, mesh)),
            in_placements=(*(placements(stacked_spec, mesh)
                             for _ in leaves), placements(rep, mesh)),
            device_mesh=mesh)
        return fn(*(as_dtensor(a, mesh, stacked_spec) for a in leaves),
                  as_dtensor(x_mb, mesh, rep))

    return wrapper

