"""Top-k Mixture-of-Experts with capacity-bounded scatter dispatch.

The JAX package's ``models/moe.py`` with its names and semantics: a fp32
router, softmax, top-k of the probabilities and renormalised combine
weights; each (token, choice) assignment takes a position in its expert's
buffer of ``expert_capacity`` rows, assignments past the capacity are
dropped; the experts run as one grouped SwiGLU over the
``(experts, capacity, d)`` buffer and the results gather back, weighted.

Differences of form, not of numbers:

* **One token group.** The JAX package groups tokens by data shard
  (``_num_groups``, ``src/repro/models/moe.py:51-58``) and gives each
  group its own capacity; without a mesh that is one group, as here. The
  port's model steps run on a mesh for the dense and Mamba-2 stacks only:
  one group over a data-sharded batch would drop other tokens than JAX's
  per-shard capacities do, so a MoE (or hybrid) config on a mesh raises
  ``NotImplementedError`` (``models/model.py::check_mesh_support``;
  ROADMAP Queue 1) rather than run a path that differs from JAX's.
* **Positions in one cumsum.** JAX assigns positions in a Python loop over
  the ``k`` choices: a within-round exclusive cumsum plus the counts of the
  earlier rounds. Here the assignments are flattened k-major and one
  cumsum over their one-hot gives the same integers
  (``dispatch_positions``).
* **Dispatch v1 and v2.** Both compute the same numbers in JAX: v1 sends a
  dropped assignment to an overflow row that is cut off, v2 drops it, and
  both read it back as zero. They differ in the buffer's row count, which
  matters to the JAX package's sharding only. PyTorch's scatters have no
  drop mode, so both variants here scatter into ``e*cap + 1`` rows, the
  last one taking every dropped assignment, and cut it off (v1's form).
* **The aux loss** (Switch: ``E * sum_e f_e p_e``) is computed only when
  asked for (train mode). JAX computes it in its jitted prefill and decode
  too, where XLA removes it because both discard it; run eagerly, it would
  be host cost at every decode tick.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig, MoEConfig
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


def expert_capacity(tokens_per_group: int, moe: MoEConfig) -> int:
    c = math.ceil(tokens_per_group * moe.top_k * moe.capacity_factor
                  / moe.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def dispatch_positions(top_i: torch.Tensor, num_experts: int
                       ) -> torch.Tensor:
    """top_i (t, k) int64 -> (k, t) position of each assignment in its
    expert's buffer: the number of assignments to the same expert before
    it, counted k-major (every token's first choice, then every token's
    second, ...) over all assignments, kept or dropped."""
    t, k = top_i.shape
    flat = top_i.t().reshape(1, k * t)
    # The one-hot is laid out (e, k*t), one row an expert, so that the
    # cumsum runs along the contiguous dim, which CUDA scans in parallel;
    # over the (k*t, e) layout it is an outer-dim scan, which took 0.37 ms
    # a layer at a 258-token granite-moe prefill on an H100.
    hits = torch.arange(num_experts, device=top_i.device)[:, None] == flat
    upto = torch.cumsum(hits, dim=1)                           # inclusive
    return (upto.gather(0, flat) - 1).reshape(k, t)


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
    e, k = moe.num_experts, moe.top_k
    t = b * s
    cap = expert_capacity(t, moe)
    xt = x.reshape(t, d)

    # The router is fp32, or bf16 when int8 serving dequantized it; JAX
    # promotes it against the fp32 activations, so it is upcast here.
    logits = xt.float() @ params["router"].float()             # (t, e)
    if moe.router_jitter and generator is not None:
        logits = logits + moe.router_jitter * torch.randn(
            logits.shape, generator=generator, device=logits.device)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)                # (t, k)
    combine = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    aux = None
    if aux_loss:
        me = probs.mean(0)                                     # (e,)
        ce = F.one_hot(top_i, e).float().sum(1).mean(0) / k    # (e,)
        aux = moe.aux_loss_weight * e * torch.sum(me * ce)

    # ---- dispatch: k-major positions under capacity ----
    pos = dispatch_positions(top_i, e)                         # (k, t)
    keep = pos < cap
    rows = e * cap
    # Destinations stay below rows + 1 (int64, as topk and cumsum give
    # them); each kept one is unique, so the scatter is a copy.
    dest = torch.where(keep, top_i.t() * cap + pos, rows)      # (k, t)
    buf = x.new_zeros((rows + 1, d))
    buf[dest] = xt                              # (k, t) rows <- (t, d)
    xb = buf[:rows].view(e, cap, d)

    # ---- grouped expert SwiGLU: three batched products ----
    yb = mlp_apply(params, xb, lowp=cfg.mlp_lowp)              # (e, cap, d)

    # ---- combine, rounding as JAX does: k products and adds in x.dtype ----
    y_flat = torch.cat([yb.reshape(rows, d), yb.new_zeros((1, d))])
    w = (combine.t() * keep).to(x.dtype)                       # (k, t)
    terms = y_flat[dest] * w[..., None]                        # (k, t, d)
    out = torch.zeros_like(xt)
    for kk in range(k):
        out = out + terms[kk]
    return out.reshape(b, s, d), aux
