"""Decoder stack: the layers as a plain loop over ``num_layers``.

The JAX package stacks per-layer parameters over a block period and runs
them as one ``lax.scan`` (``src/repro/models/transformer.py:179-241``) to
keep compile time flat in depth. PyTorch runs eagerly, so the port keeps
one parameter dict and one cache dict per layer and loops.

Each layer is dispatched on its signature ``(mixer kind, ffn kind)`` as
``layer_signature`` does there: an attention or a Mamba mixer, then no
FFN, a dense one or a MoE one. That covers the dense, SSM, MoE and hybrid
stacks. The MoE layers' load-balancing loss is summed over the stack in
train mode only (see ``models/moe.py``).

Remat (``src/repro/models/transformer.py:201-207``), in train mode where
autograd records: ``"full"`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant), so its forward runs again in
the backward; ``"dots"`` checkpoints each layer selectively, saving the
outputs of its 2-D matrix products (``aten.mm``, JAX's
``checkpoint_dots_with_no_batch_dims``: a batched product, ``aten.bmm``,
is recomputed) and recomputing the rest; ``"none"`` keeps everything.
JAX checkpoints a block of ``block_period`` layers; here each layer is its
own block, which gives the same gradients.

The logical sharding specs (``stack_specs``, ``stack_cache_specs``) follow
the same layout, one spec tree a layer: layer ``i``'s spec of a leaf is
the JAX package's spec of its stacked leaf at position ``i % period``
without the leading ``None`` of the stacking dim
(``src/repro/models/transformer.py:145-153``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config.base import ATTN, ModelConfig
from repro_torch.distributed.sharding import (active_mesh, active_rules,
                                              shard, use_sharding)
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (mlp_apply, mlp_init, mlp_specs,
                                       rmsnorm_apply, rmsnorm_init,
                                       rmsnorm_specs)

Params = Dict[str, Any]


def layer_signature(cfg: ModelConfig, i: int) -> Tuple[str, str]:
    """(mixer kind, ffn kind) of layer ``i``: ATTN or MAMBA, then "moe",
    "dense" or "none"."""
    kind = cfg.layer_kinds()[i]
    if cfg.is_moe_layer(i):
        ffn = "moe"
    elif cfg.d_ff:
        ffn = "dense"
    else:
        ffn = "none"
    return kind, ffn


def block_period(cfg: ModelConfig) -> int:
    """The JAX package's layer-stacking period: the least p dividing
    num_layers with layer i's signature that of layer i % p. Its params
    stack layer i as repeat i // p of position i % p (``convert.py``)."""
    sigs = [layer_signature(cfg, i) for i in range(cfg.num_layers)]
    for p in range(1, cfg.num_layers + 1):
        if cfg.num_layers % p:
            continue
        if all(sigs[i] == sigs[i % p] for i in range(cfg.num_layers)):
            return p
    return cfg.num_layers


def layer_init(gen: torch.Generator, cfg: ModelConfig, i: int,
               dtype: torch.dtype, device: torch.device) -> Params:
    kind, ffn = layer_signature(cfg, i)
    p: Params = {"norm1": rmsnorm_init(cfg.d_model, device)}
    if kind == ATTN:
        p["mixer"] = attn_mod.attn_init(gen, cfg, dtype, device)
    else:
        p["mixer"] = mamba_mod.mamba_init(gen, cfg, dtype, device)
    if ffn != "none":
        p["norm2"] = rmsnorm_init(cfg.d_model, device)
        p["ffn"] = (moe_mod.moe_init(gen, cfg, dtype, device) if ffn == "moe"
                    else mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device))
    return p


def layer_specs(cfg: ModelConfig, i: int) -> Params:
    kind, ffn = layer_signature(cfg, i)
    p: Params = {"norm1": rmsnorm_specs()}
    p["mixer"] = (attn_mod.attn_specs(cfg) if kind == ATTN
                  else mamba_mod.mamba_specs(cfg))
    if ffn != "none":
        p["norm2"] = rmsnorm_specs()
        p["ffn"] = moe_mod.moe_specs(cfg) if ffn == "moe" else mlp_specs()
    return p


def layer_apply(params: Params, cfg: ModelConfig, sig: Tuple[str, str],
                x: torch.Tensor, *, mode: str, cache: Optional[Params], pos,
                max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[Params],
                           Optional[torch.Tensor]]:
    """Returns (x, cache, aux): aux is the MoE layer's load-balancing loss
    in train mode, else None."""
    kind, ffn = sig
    h = rmsnorm_apply(params["norm1"], x, cfg.norm_eps, lowp=cfg.mlp_lowp)
    if kind == ATTN:
        mix, new_cache = attn_mod.attn_apply(
            params["mixer"], cfg, h, mode=mode, cache=cache, pos=pos,
            max_len=max_len)
    else:
        mix, new_cache = mamba_mod.mamba_apply(
            params["mixer"], cfg, h, mode=mode, cache=cache)
    x = x + mix
    aux = None
    if ffn != "none":
        h = rmsnorm_apply(params["norm2"], x, cfg.norm_eps,
                          lowp=cfg.mlp_lowp)
        if ffn == "moe":
            f, aux = moe_mod.moe_apply(params["ffn"], cfg, h,
                                       aux_loss=mode == "train")
        else:
            f = mlp_apply(params["ffn"], h, lowp=cfg.mlp_lowp)
        x = x + f
    return shard(x, ("batch", "seq", "embed_act")), new_cache, aux


def stack_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
               device: torch.device) -> List[Params]:
    return [layer_init(gen, cfg, i, dtype, device)
            for i in range(cfg.num_layers)]


def init_layer_cache(cfg: ModelConfig, i: int, batch: int, max_len: int,
                     dtype: torch.dtype, device: torch.device) -> Params:
    if layer_signature(cfg, i)[0] == ATTN:
        return attn_mod.init_cache(cfg, batch, max_len, dtype, device)
    return mamba_mod.init_mamba_cache(cfg, batch, dtype, device)


def layer_cache_specs(cfg: ModelConfig, i: int) -> Params:
    if layer_signature(cfg, i)[0] == ATTN:
        return attn_mod.cache_specs()
    return mamba_mod.mamba_cache_specs()


def stack_specs(cfg: ModelConfig) -> List[Params]:
    return [layer_specs(cfg, i) for i in range(cfg.num_layers)]


def stack_cache_specs(cfg: ModelConfig) -> List[Params]:
    return [layer_cache_specs(cfg, i) for i in range(cfg.num_layers)]


def stack_caches(cfg: ModelConfig, batch: int, max_len: int,
                 dtype: torch.dtype, device: torch.device) -> List[Params]:
    return [init_layer_cache(cfg, i, batch, max_len, dtype, device)
            for i in range(cfg.num_layers)]


REMATS = ("none", "full", "dots")


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_call(remat: str, fn, *args):
    """``fn(*args)`` under the remat policy ``remat`` (see the module
    docstring); a plain call where autograd records nothing. The forward
    that the backward runs again runs under the sharding context of this
    call: the backward may run on another thread (the autograd engine's
    for a CUDA device) or after the context has closed."""
    if remat not in REMATS:
        raise ValueError(f"remat {remat!r} not in {REMATS}")
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    mesh, rules = active_mesh(), active_rules()
    body = fn

    def fn(*a):
        with use_sharding(mesh, rules):
            return body(*a)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts, _save_dots))


def stack_apply(layers: List[Params], cfg: ModelConfig, x: torch.Tensor, *,
                mode: str, caches: Optional[List[Params]] = None, pos=None,
                max_len: Optional[int] = None, remat: str = "none"
                ) -> Tuple[torch.Tensor, Optional[List[Params]],
                           Optional[torch.Tensor]]:
    """Run all layers. Returns (x, caches, aux): caches are None in train;
    aux, the MoE layers' load-balancing loss summed over the stack, is an
    fp32 scalar in train (0 without MoE layers) and None otherwise.
    ``remat`` applies in train mode only."""
    new_caches = []
    aux = (torch.zeros((), dtype=torch.float32, device=x.device)
           if mode == "train" else None)
    for i, lp in enumerate(layers):
        sig = layer_signature(cfg, i)
        if mode == "train":
            x, a = remat_call(
                remat, lambda x, lp=lp, sig=sig: layer_apply(
                    lp, cfg, sig, x, mode="train", cache=None,
                    pos=None)[::2], x)
            nc = None
        else:
            cache = None if caches is None else caches[i]
            x, nc, a = layer_apply(lp, cfg, sig, x, mode=mode, cache=cache,
                                   pos=pos, max_len=max_len)
        new_caches.append(nc)
        if a is not None:
            aux = aux + a
    return x, (new_caches if mode in ("prefill", "decode") else None), aux
