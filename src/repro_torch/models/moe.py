"""Top-k Mixture-of-Experts with capacity-bounded scatter dispatch.

The JAX package's ``models/moe.py`` with its names and semantics: tokens
are cut into groups (``_num_groups``: the active mesh's data-parallel
shards, one group without a mesh), each group routed on its own by a fp32
router, softmax, top-k of the probabilities and renormalised combine
weights; each (token, choice) assignment takes a position in its expert's
buffer of ``expert_capacity(tokens a group)`` rows, counted within its
group, and assignments past the capacity are dropped; the experts run as
one grouped SwiGLU over the ``(groups, experts, capacity, d)`` buffer and
the results gather back, weighted. The aux loss is the mean over groups of
each group's Switch loss.

Differences of form, not of numbers:

* **Positions in one cumsum.** JAX assigns positions in a Python loop over
  the ``k`` choices: a within-round exclusive cumsum plus the counts of the
  earlier rounds. Here each group's assignments are flattened k-major and
  one cumsum over their one-hot gives the same integers
  (``dispatch_positions``).
* **Dispatch v1 and v2.** Both compute the same numbers in JAX: v1 sends a
  dropped assignment to an overflow row that is cut off, v2 drops it, and
  both read it back as zero. They differ in the buffer's row count, which
  matters to the JAX package's sharding only. PyTorch's scatters have no
  drop mode, so both variants here scatter into ``e*cap + 1`` rows a
  group, the last one taking every dropped assignment, and cut it off
  (v1's form).
* **The aux loss** (Switch: ``E * sum_e f_e p_e``) is computed only when
  asked for (train mode). JAX computes it in its jitted prefill and decode
  too, where XLA removes it because both discard it; run eagerly, it would
  be host cost at every decode tick.
* **On a mesh** the three stages run on local shards
  (``distributed.sharding.on_local_shards``), since a group never reads
  another group's tokens: the routing and the scatter into the buffer
  (:func:`route`) and the combine's gather (:func:`combine`) on each
  rank's own groups (the group dim sharded over ``batch``), the experts
  (:func:`experts`) on its own groups and experts (``expert_act``), their
  weights gathered along the fsdp dim. The combine takes the buffer whole
  along the experts, redistributed from the experts' shards. JAX's
  ``shard()`` of the v2 buffer (``expert_flat``) and of the hidden
  activations falls inside the local stages and has no counterpart.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.config.base import ModelConfig, MoEConfig
from repro_torch.distributed.sharding import (active_mesh, axis_sizes,
                                              grad_placements,
                                              on_local_shards, replicated,
                                              row_placements, shard)
from repro_torch.models.layers import dense_init, mlp_apply

Params = Dict[str, Any]


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             device: torch.device) -> Params:
    moe = cfg.moe
    assert moe is not None
    d, f, e = cfg.d_model, moe.d_ff_expert, moe.num_experts
    return {
        "router": dense_init(gen, (d, e), torch.float32, device),
        "w_gate": dense_init(gen, (e, d, f), dtype, device),
        "w_up": dense_init(gen, (e, d, f), dtype, device),
        "w_down": dense_init(gen, (e, f, d), dtype, device),
    }


def moe_specs(cfg: ModelConfig) -> Params:
    return {
        "router": ("p_embed", None),
        "w_gate": ("p_expert", "p_ff_fsdp", None),
        "w_up": ("p_expert", "p_ff_fsdp", None),
        "w_down": ("p_expert", None, "p_ff_fsdp"),
    }


def _num_groups() -> int:
    """Token groups = number of data-parallel shards (1 without a mesh)."""
    mesh = active_mesh()
    if mesh is None:
        return 1
    sizes = axis_sizes(mesh)
    return sizes.get("data", 1) * sizes.get("pod", 1)


def expert_capacity(tokens_per_group: int, moe: MoEConfig) -> int:
    c = math.ceil(tokens_per_group * moe.top_k * moe.capacity_factor
                  / moe.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def dispatch_positions(top_i: torch.Tensor, num_experts: int
                       ) -> torch.Tensor:
    """top_i (g, t, k) int64 -> (g, k, t) position of each assignment in its
    expert's buffer: the number of assignments of its group to the same
    expert before it, counted k-major (every token's first choice, then
    every token's second, ...) over all assignments, kept or dropped. A
    (t, k) input is one group and gives (k, t)."""
    if top_i.dim() == 2:
        return dispatch_positions(top_i[None], num_experts)[0]
    g, t, k = top_i.shape
    flat = top_i.transpose(1, 2).reshape(g, 1, k * t)
    # The one-hot is laid out (g, e, k*t), one row an expert, so that the
    # cumsum runs along the contiguous dim, which CUDA scans in parallel;
    # over the (k*t, e) layout it is an outer-dim scan, which took 0.37 ms
    # a layer at a 258-token granite-moe prefill on an H100.
    hits = torch.arange(num_experts, device=top_i.device)[:, None] == flat
    upto = torch.cumsum(hits, dim=2)                           # inclusive
    return (upto.gather(1, flat) - 1).reshape(g, k, t)


def _flat_rows(dest: torch.Tensor, rows: int) -> torch.Tensor:
    """dest (g, k, t), rows of each group's ``rows + 1``-row buffer -> rows
    of the groups' buffers laid end to end."""
    g = dest.shape[0]
    if g == 1:
        return dest
    return dest + (rows + 1) * torch.arange(g, device=dest.device)[:, None,
                                                                   None]


def route(xg: torch.Tensor, router: torch.Tensor,
          noise: Optional[torch.Tensor], moe: MoEConfig, cap: int,
          aux_loss: bool) -> Tuple[torch.Tensor, ...]:
    """Route groups of tokens and scatter them into their experts' buffers.
    xg (g, t, d) -> (xb (g, e, cap, d), w (g, k, t) in xg's dtype, the
    combine weight of each assignment and 0 where it dropped, dest (g, k, t)
    int64, its row in its group's ``e*cap + 1``-row buffer, ``e*cap`` where
    it dropped), then, with ``aux_loss``, each group's ``sum_e me*ce``
    (g,) fp32."""
    g, t, d = xg.shape
    e, k = moe.num_experts, moe.top_k
    # The router is fp32, or bf16 when int8 serving dequantized it; JAX
    # promotes it against the fp32 activations, so it is upcast here.
    logits = xg.float() @ router.float()                       # (g, t, e)
    if noise is not None:
        logits = logits + moe.router_jitter * noise
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)                # (g, t, k)
    combine_w = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- dispatch: k-major positions under capacity, within each group ----
    pos = dispatch_positions(top_i, e)                         # (g, k, t)
    keep = pos < cap
    rows = e * cap
    # Destinations stay below rows + 1 (int64, as topk and cumsum give
    # them); each kept one is unique, so the scatter is a copy.
    dest = torch.where(keep, top_i.transpose(1, 2) * cap + pos, rows)
    buf = xg.new_zeros((g * (rows + 1), d))
    buf[_flat_rows(dest, rows)] = xg[:, None]   # (g, k, t) rows <- (g, t, d)
    xb = buf.view(g, rows + 1, d)[:, :rows].reshape(g, e, cap, d)
    w = (combine_w.transpose(1, 2) * keep).to(xg.dtype)        # (g, k, t)
    if not aux_loss:
        return xb, w, dest
    me = probs.mean(1)                                         # (g, e)
    ce = F.one_hot(top_i, e).float().sum(2).mean(1) / k        # (g, e)
    return xb, w, dest, torch.sum(me * ce, dim=-1)


def experts(xb: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, lowp: bool = False) -> torch.Tensor:
    """The grouped expert SwiGLU: xb (g, e, cap, d) -> (g, e, cap, d), as
    three batched products over the experts, each over its groups' rows."""
    g, e, cap, d = xb.shape
    xe = xb.transpose(0, 1).reshape(e, g * cap, d)
    ye = mlp_apply({"w_gate": w_gate, "w_up": w_up, "w_down": w_down}, xe,
                   lowp=lowp)                                  # (e, g*cap, d)
    return ye.view(e, g, cap, d).transpose(0, 1)


def combine(yb: torch.Tensor, w: torch.Tensor, dest: torch.Tensor
            ) -> torch.Tensor:
    """Gather each assignment's expert output back to its token, weighted:
    yb (g, e, cap, d), w and dest (g, k, t) -> (g, t, d). The k products
    and adds round in yb's dtype, as JAX's do."""
    g, e, cap, d = yb.shape
    rows = e * cap
    y_flat = torch.cat([yb.reshape(g, rows, d), yb.new_zeros((g, 1, d))],
                       dim=1).view(g * (rows + 1), d)
    terms = y_flat[_flat_rows(dest, rows)] * w[..., None]     # (g, k, t, d)
    out = torch.zeros_like(terms[:, 0])
    for kk in range(w.shape[1]):
        out = out + terms[:, kk]
    return out


def moe_apply(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
              generator: Optional[torch.Generator] = None,
              aux_loss: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (b, s, d) -> (out, aux), aux the fp32 load-balancing loss when
    ``aux_loss`` is set, else None. Router jitter runs only when a
    ``generator`` is given, as JAX runs it only with ``rng``."""
    moe = cfg.moe
    assert moe is not None
    b, s, d = x.shape
    e = moe.num_experts
    tokens = b * s
    groups = _num_groups()
    if tokens % groups != 0:
        groups = 1
    tpg = tokens // groups
    cap = expert_capacity(tpg, moe)

    xr = x.reshape(groups, tpg, d)
    xg = shard(xr, ("batch", None, "embed_act"))
    noise = None
    if moe.router_jitter and generator is not None:
        noise = replicated(torch.randn((groups, tpg, e), generator=generator,
                                       device=x.device), xg)
    ws = (params["w_gate"], params["w_up"], params["w_down"])
    if not isinstance(xg, DTensor):
        xb, w, dest, *grp = route(xg, params["router"], noise, moe, cap,
                                  aux_loss)
        out = combine(experts(xb, *ws, lowp=cfg.mlp_lowp), w, dest)
    else:
        mesh = xg.device_mesh
        gp = row_placements(xg, [1, 2])     # the groups where they lie
        rep = (Replicate(),) * mesh.ndim
        xb, w, dest, *grp = on_local_shards(
            lambda xl, rl, nl: route(xl, rl, nl, moe, cap, aux_loss), mesh,
            (gp, rep, None if noise is None else gp),
            (gp,) * (4 if aux_loss else 3),
            (gp, grad_placements(rep, gp), None))(
                xg, replicated(params["router"], xg), noise)
        xb = shard(xb, ("batch", "expert_act", None, "embed_act"))
        xp = xb.placements
        # the expert weights sharded along the experts where xb is, whole
        # elsewhere (the fsdp dim gathered)
        wp = tuple(Shard(0) if p == Shard(1) else Replicate() for p in xp)
        wg = grad_placements(wp, xp)
        yb = on_local_shards(
            lambda xl, gl, ul, dl: experts(xl, gl, ul, dl, lowp=cfg.mlp_lowp),
            mesh, (xp, wp, wp, wp), xp, (xp, wg, wg, wg))(xb, *ws)
        yb = shard(yb, ("batch", "expert_act", None, "embed_act"))
        out = on_local_shards(combine, mesh, (gp, gp, gp), gp,
                              (gp, gp, gp))(yb, w, dest)
        # Back to the split of x's rows: where the data shards outnumber
        # the rows (16 a microbatch over pod x data = 32), the groups'
        # split cuts rows in half, which no (b, s) view keeps.
        if tuple(out.placements) != tuple(xr.placements):
            out = out.redistribute(mesh, xr.placements)
    aux = moe.aux_loss_weight * e * torch.mean(grp[0]) if aux_loss else None
    out = out.reshape(b, s, d)
    return shard(out, ("batch", "seq", "embed_act")), aux
