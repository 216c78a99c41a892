"""Decoder stack: dense layers as a plain loop over ``num_layers``.

The JAX package stacks per-layer parameters over a block period and runs
them as one ``lax.scan`` (``src/repro/models/transformer.py:179-241``) to
keep compile time flat in depth. PyTorch runs eagerly, so the port keeps
one parameter dict and one cache dict per layer and loops.

Only dense stacks are ported: Mamba layers and MoE FFNs raise.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config.base import MAMBA, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import mlp_apply, mlp_init, rmsnorm_apply, rmsnorm_init

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet, naming the ROADMAP item."""
    if MAMBA in cfg.layer_kinds():
        raise NotImplementedError(
            f"{cfg.name}: Mamba layers are not ported yet "
            "(ROADMAP.md, Queue 1: 'SSM and hybrid')")
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet "
            "(ROADMAP.md, Queue 1: 'MoE')")


def layer_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
               device: torch.device) -> Params:
    p: Params = {"norm1": rmsnorm_init(cfg.d_model, device),
                 "mixer": attn_mod.attn_init(gen, cfg, dtype, device)}
    if cfg.d_ff:
        p["norm2"] = rmsnorm_init(cfg.d_model, device)
        p["ffn"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def layer_apply(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
                mode: str, cache: Optional[Params], pos,
                max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    h = rmsnorm_apply(params["norm1"], x, cfg.norm_eps, lowp=cfg.mlp_lowp)
    mix, new_cache = attn_mod.attn_apply(
        params["mixer"], cfg, h, mode=mode, cache=cache, pos=pos,
        max_len=max_len)
    x = x + mix
    if "ffn" in params:
        h = rmsnorm_apply(params["norm2"], x, cfg.norm_eps,
                          lowp=cfg.mlp_lowp)
        x = x + mlp_apply(params["ffn"], h, lowp=cfg.mlp_lowp)
    return x, new_cache


def stack_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
               device: torch.device) -> List[Params]:
    check_supported(cfg)
    return [layer_init(gen, cfg, dtype, device)
            for _ in range(cfg.num_layers)]


def stack_caches(cfg: ModelConfig, batch: int, max_len: int,
                 dtype: torch.dtype, device: torch.device) -> List[Params]:
    return [attn_mod.init_cache(cfg, batch, max_len, dtype, device)
            for _ in range(cfg.num_layers)]


def stack_apply(layers: List[Params], cfg: ModelConfig, x: torch.Tensor, *,
                mode: str, caches: Optional[List[Params]] = None, pos=None,
                max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[List[Params]]]:
    """Run all layers. Returns (x, caches); caches are None in train."""
    new_caches = []
    for i, lp in enumerate(layers):
        cache = None if caches is None else caches[i]
        x, nc = layer_apply(lp, cfg, x, mode=mode, cache=cache, pos=pos,
                            max_len=max_len)
        new_caches.append(nc)
    return x, (new_caches if mode in ("prefill", "decode") else None)
