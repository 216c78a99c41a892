"""Overlapped collectives: the ring collective-matmul over a process group.

The paper's §5.3 insight ("transfer computation-required data first", to
pipeline communication with computation), as the JAX package's
``distributed/collectives.py`` implements it under ``shard_map``: instead
of `all_gather(x) @ w` (a blocking transfer followed by compute), the
gathered operand circulates around the ring one shard-chunk per step
while the chunk already in hand is multiplied. Peak comm/compute overlap
is ~(A-1)/A of the transfer.

Each function runs on one rank's local tensors, with the mesh dim's
``ProcessGroup`` (``mesh.get_group(axis)``) in the place of JAX's axis
name. The ring is JAX's (rank ``j`` sends to ``j - 1``) and so is the
order of the hops. Each hop's send and receive (``batch_isend_irecv``) are
posted before the product on the chunk in hand and waited for after it,
so under NCCL the transfer really overlaps the product. The last hop of
JAX's all-gather loop, whose chunk is never used, is not made. A group of
one makes no hop. Products are ``torch.matmul`` of the operands in fp32
(JAX's ``preferred_element_type=float32``), cast back to the input dtype
at the end.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed import ProcessGroup
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import placements


def _ring(group: ProcessGroup) -> Tuple[int, int, int, int]:
    """(size, own index, global rank of j - 1, global rank of j + 1):
    sends go to j - 1, receives come from j + 1."""
    a = group.size()
    idx = dist.get_rank(group)
    return (a, idx, dist.get_global_rank(group, (idx - 1) % a),
            dist.get_global_rank(group, (idx + 1) % a))


def post_hop(t: torch.Tensor, to: int, frm: int, group: ProcessGroup):
    """Start sending ``t`` to global rank ``to`` and receiving a tensor of
    its shape from ``frm``; returns (buffer, works) for ``finish_hop``."""
    buf = torch.empty_like(t)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t, to, group),
        dist.P2POp(dist.irecv, buf, frm, group)])
    return buf, works


def finish_hop(buf: torch.Tensor, works) -> torch.Tensor:
    """Wait for a hop's send and receive; returns what was received."""
    for w in works:
        w.wait()
    return buf


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float())


# ---------------------------------------------------------------------------
# All-gather matmul:  y = all_gather(x, axis) @ w_local
#   x_local : (m, k_l)      -- sharded on k (the contracting dim)
#   w_local : (A*k_l, n_l)  -- full contracting dim, n sharded
# Returns y_local: (m, n_l).
# ---------------------------------------------------------------------------
def ring_ag_matmul(x_local: torch.Tensor, w_local: torch.Tensor,
                   group: ProcessGroup) -> torch.Tensor:
    a, idx, prev, nxt = _ring(group)
    kl = x_local.shape[1]
    chunk = x_local.contiguous()
    acc = None
    for i in range(a):
        hop = post_hop(chunk, prev, nxt, group) if i < a - 1 else None
        src = (idx + i) % a
        part = _mm32(chunk, w_local[src * kl:(src + 1) * kl])
        acc = part if acc is None else acc + part
        if hop is not None:
            chunk = finish_hop(*hop)
    return acc.to(x_local.dtype)


# ---------------------------------------------------------------------------
# Matmul reduce-scatter:  y = reduce_scatter(x @ w, axis, scatter dim=1)
#   x_local : (m, k_l)      -- k sharded (partial contributions)
#   w_local : (k_l, n)      -- full n
# Returns y_local: (m, n / A): the n-shard owned by this rank, fully
# reduced. Partial products for the chunk that is `i` hops away are computed
# while the accumulator ring-hops toward its owner.
# ---------------------------------------------------------------------------
def ring_matmul_rs(x_local: torch.Tensor, w_local: torch.Tensor,
                   group: ProcessGroup) -> torch.Tensor:
    a, idx, prev, nxt = _ring(group)
    n = w_local.shape[1]
    assert n % a == 0
    nl = n // a

    def partial(i):
        # partial(j) contributes to the accumulator that is j ring-hops away
        # from its final owner; with a j->j-1 ring that owner is idx - j.
        tgt = (idx - i) % a
        return _mm32(x_local, w_local[:, tgt * nl:(tgt + 1) * nl])

    acc = partial(a - 1)
    for i in range(1, a):
        hop = post_hop(acc, prev, nxt, group)
        step = partial(a - 1 - i)   # chunks farthest from their owner first
        acc = finish_hop(*hop) + step
    return acc.to(x_local.dtype)


# ---------------------------------------------------------------------------
# Baseline (unoverlapped) variants — the paper-faithful §5.3 "tensor
# parallelism without pipelining" reference points.
# ---------------------------------------------------------------------------
def naive_ag_matmul(x_local: torch.Tensor, w_local: torch.Tensor,
                    group: ProcessGroup) -> torch.Tensor:
    a = group.size()
    m, kl = x_local.shape
    x_full = torch.empty((a * m, kl), dtype=x_local.dtype,
                         device=x_local.device)
    dist.all_gather_into_tensor(x_full, x_local.contiguous(), group=group)
    x_full = x_full.reshape(a, m, kl).transpose(0, 1).reshape(m, a * kl)
    return _mm32(x_full, w_local).to(x_local.dtype)


def naive_matmul_rs(x_local: torch.Tensor, w_local: torch.Tensor,
                    group: ProcessGroup) -> torch.Tensor:
    y = _mm32(x_local, w_local)
    dist.all_reduce(y, group=group)
    a = group.size()
    idx = dist.get_rank(group)
    nl = y.shape[1] // a
    return y[:, idx * nl:(idx + 1) * nl].to(x_local.dtype)


# ---------------------------------------------------------------------------
# The mesh-level helper that wraps the ring op in local_map for a mesh dim.
# ---------------------------------------------------------------------------
def as_dtensor(x: torch.Tensor, mesh: DeviceMesh, spec) -> DTensor:
    """``x`` itself if it is a DTensor, else the full tensor (the same on
    every rank) distributed with ``spec``'s placements."""
    if isinstance(x, DTensor):
        return x
    return distribute_tensor(x, mesh, list(placements(spec, mesh)))


def tp_matmul_overlapped(x: torch.Tensor, w: torch.Tensor, mesh: DeviceMesh,
                         axis: str = "model") -> DTensor:
    """y = x @ w with x k-sharded and w n-sharded on `axis`, overlapped.
    Full tensors or DTensors in, a DTensor sharded on n out."""
    spec = (None, axis)
    group = mesh.get_group(axis)
    fn = local_map(lambda xl, wl: ring_ag_matmul(xl, wl, group),
                   out_placements=list(placements(spec, mesh)),
                   in_placements=(placements(spec, mesh),) * 2,
                   device_mesh=mesh)
    return fn(as_dtensor(x, mesh, spec), as_dtensor(w, mesh, spec))
