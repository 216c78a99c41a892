"""Decoder stack: the layers as a plain loop over ``num_layers``.

The JAX package stacks per-layer parameters over a block period and runs
them as one ``lax.scan`` (``src/repro/models/transformer.py:179-241``) to
keep compile time flat in depth. PyTorch runs eagerly, so the port keeps
one parameter dict and one cache dict per layer and loops.

Each layer is dispatched on its signature ``(mixer kind, ffn kind)`` as
``layer_signature`` does there: an attention or a Mamba mixer, then no FFN
or a dense one. That covers dense, SSM and hybrid stacks; MoE FFNs raise.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config.base import ATTN, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models.layers import mlp_apply, mlp_init, rmsnorm_apply, rmsnorm_init

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet, naming the ROADMAP item."""
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet "
            "(ROADMAP.md, Queue 1: 'MoE')")


def layer_signature(cfg: ModelConfig, i: int) -> Tuple[str, str]:
    """(mixer kind, ffn kind) of layer ``i``: ATTN or MAMBA, then "none"
    or "dense" (MoE is refused by ``check_supported``)."""
    return cfg.layer_kinds()[i], ("dense" if cfg.d_ff else "none")


def layer_init(gen: torch.Generator, cfg: ModelConfig, i: int,
               dtype: torch.dtype, device: torch.device) -> Params:
    kind, ffn = layer_signature(cfg, i)
    p: Params = {"norm1": rmsnorm_init(cfg.d_model, device)}
    if kind == ATTN:
        p["mixer"] = attn_mod.attn_init(gen, cfg, dtype, device)
    else:
        p["mixer"] = mamba_mod.mamba_init(gen, cfg, dtype, device)
    if ffn == "dense":
        p["norm2"] = rmsnorm_init(cfg.d_model, device)
        p["ffn"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def layer_apply(params: Params, cfg: ModelConfig, sig: Tuple[str, str],
                x: torch.Tensor, *, mode: str, cache: Optional[Params], pos,
                max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[Params]]:
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
    if ffn == "dense":
        h = rmsnorm_apply(params["norm2"], x, cfg.norm_eps,
                          lowp=cfg.mlp_lowp)
        x = x + mlp_apply(params["ffn"], h, lowp=cfg.mlp_lowp)
    return x, new_cache


def stack_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
               device: torch.device) -> List[Params]:
    check_supported(cfg)
    return [layer_init(gen, cfg, i, dtype, device)
            for i in range(cfg.num_layers)]


def init_layer_cache(cfg: ModelConfig, i: int, batch: int, max_len: int,
                     dtype: torch.dtype, device: torch.device) -> Params:
    if layer_signature(cfg, i)[0] == ATTN:
        return attn_mod.init_cache(cfg, batch, max_len, dtype, device)
    return mamba_mod.init_mamba_cache(cfg, batch, dtype, device)


def stack_caches(cfg: ModelConfig, batch: int, max_len: int,
                 dtype: torch.dtype, device: torch.device) -> List[Params]:
    return [init_layer_cache(cfg, i, batch, max_len, dtype, device)
            for i in range(cfg.num_layers)]


def stack_apply(layers: List[Params], cfg: ModelConfig, x: torch.Tensor, *,
                mode: str, caches: Optional[List[Params]] = None, pos=None,
                max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[List[Params]]]:
    """Run all layers. Returns (x, caches); caches are None in train."""
    new_caches = []
    for i, lp in enumerate(layers):
        cache = None if caches is None else caches[i]
        x, nc = layer_apply(lp, cfg, layer_signature(cfg, i), x, mode=mode,
                            cache=cache, pos=pos, max_len=max_len)
        new_caches.append(nc)
    return x, (new_caches if mode in ("prefill", "decode") else None)
