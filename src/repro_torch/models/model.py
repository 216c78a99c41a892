"""The LM wrapper: init / forward / prefill / decode.

``batch`` dict convention, as in the JAX package's ``models/model.py``:
  tokens : (b, s) integer tensor
  vision_embeds : (b, ft, d)  (optional; VLM/audio frontend stubs)

Parameters are a dict ``{"embed": {...}, "layers": [per-layer dicts],
"final_norm": {...}}``; ``repro_torch.convert.from_jax_params`` builds one
from the JAX package's ``init_params`` pytree. Dense, SSM (Mamba-2), MoE
and hybrid stacks run. ``forward`` returns (logits, caches, aux) as the
JAX package's does; aux, the MoE load-balancing loss, is computed in train
mode only (None otherwise), and ``prefill``/``decode_step`` drop it as
JAX's do. A layer's cache is ``{"k", "v"}`` for attention and
``{"conv", "ssd"}`` for Mamba.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models import transformer as stack
from repro_torch.models.layers import (embed_apply, embed_init,
                                       rmsnorm_apply, rmsnorm_init,
                                       unembed_apply)

Params = Dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# ---------------------------------------------------------------------------
# Params.
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, gen: torch.Generator,
                device: torch.device) -> Params:
    """Random weights (normal, scale 0.02, as the JAX package's
    ``dense_init``) drawn from ``gen``, which must live on ``device``."""
    dtype = torch_dtype(cfg.dtype)
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                            cfg.tie_embeddings, device),
        "layers": stack.stack_init(gen, cfg, dtype, device),
        "final_norm": rmsnorm_init(cfg.d_model, device),
    }


# ---------------------------------------------------------------------------
# Forward passes.
# ---------------------------------------------------------------------------
def _embed_inputs(params: Params, batch: Dict[str, Any]) -> torch.Tensor:
    x = embed_apply(params["embed"], batch["tokens"])
    ve = batch.get("vision_embeds")
    if ve is not None:
        x = torch.cat([ve.to(x.dtype), x], dim=1)
    return x


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, Any], *,
            mode: str = "train", caches: Optional[List[Params]] = None,
            pos=None, max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[List[Params]],
                       Optional[torch.Tensor]]:
    """Returns (logits, caches, aux); aux is None outside train."""
    x = _embed_inputs(params, batch)
    x, new_caches, aux = stack.stack_apply(
        params["layers"], cfg, x, mode=mode, caches=caches, pos=pos,
        max_len=max_len)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps,
                      lowp=cfg.mlp_lowp)
    return unembed_apply(params["embed"], x), new_caches, aux


# ---------------------------------------------------------------------------
# Serving entry points.
# ---------------------------------------------------------------------------
def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Any], *,
            max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, List[Params]]:
    """Returns (last-position logits, caches padded to max_len)."""
    logits, caches, _ = forward(params, cfg, batch, mode="prefill",
                                max_len=max_len)
    return logits[:, -1], caches


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                caches: List[Params], pos
                ) -> Tuple[torch.Tensor, List[Params]]:
    """tokens: (b, 1). Returns (logits (b, vocab), caches), the caches
    updated in place."""
    logits, new_caches, _ = forward(params, cfg, {"tokens": tokens},
                                    mode="decode", caches=caches, pos=pos)
    return logits[:, 0], new_caches


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device: torch.device, dtype: Optional[torch.dtype] = None
                ) -> List[Params]:
    dtype = dtype or torch_dtype(cfg.dtype)
    return stack.stack_caches(cfg, batch, max_len, dtype, device)
