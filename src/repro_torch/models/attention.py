"""GQA multi-head attention with RoPE and a decode KV cache.

Modes, as in the JAX package's ``models/attention.py``:
  * train   — full causal self-attention (no cache)
  * prefill — causal self-attention that also emits the KV cache, padded
              to ``max_len``
  * decode  — one new token written at ``pos`` into the cache, then
              attention against the first ``pos + 1`` cache rows

The JAX package returns a new cache (its engine donates the old one). Here
decode writes the new K/V row into the given cache tensors **in place** and
returns the same dict, which saves a copy of the whole cache per token.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rope_apply, rope_table

Params = Dict[str, Any]


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
              device: torch.device) -> Params:
    d, hq, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    p: Params = {
        "wq": dense_init(gen, (d, hq, hd), dtype, device),
        "wk": dense_init(gen, (d, hkv, hd), dtype, device),
        "wv": dense_init(gen, (d, hkv, hd), dtype, device),
        "wo": dense_init(gen, (hq, hd, d), dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((hkv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((hkv, hd), dtype=dtype, device=device)
    return p


def attn_specs(cfg: ModelConfig) -> Params:
    p: Params = {
        "wq": ("p_embed", "p_heads", "p_head_dim"),
        "wk": ("p_embed", "p_kv_heads", "p_head_dim"),
        "wv": ("p_embed", "p_kv_heads", "p_head_dim"),
        "wo": ("p_heads", "p_head_dim", "p_embed"),
    }
    if cfg.qkv_bias:
        p["bq"] = ("p_heads", "p_head_dim")
        p["bk"] = ("p_kv_heads", "p_head_dim")
        p["bv"] = ("p_kv_heads", "p_head_dim")
    return p


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype, device: torch.device) -> Params:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_specs() -> Params:
    return {
        "k": ("batch", "kv_seq", "kv_heads_act", "head_dim_act"),
        "v": ("batch", "kv_seq", "kv_heads_act", "head_dim_act"),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (b, s, d) @ w (d, h, k) -> (b, s, h, k)."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).reshape(*x.shape[:2], h, k)


def _project_qkv(params: Params, cfg: ModelConfig, x: torch.Tensor):
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q, k, v


def attn_apply(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
               mode: str, cache: Optional[Params] = None,
               pos: Union[int, torch.Tensor, None] = None,
               max_len: Optional[int] = None
               ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (b, s, d). Returns (out, cache). ``pos`` is an int (every row at
    the same position, as ``generate`` decodes) or a (b,) integer tensor
    (one position per slot, as the continuous batcher decodes)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    if mode in ("train", "prefill"):
        sin, cos = rope_table(torch.arange(s, device=x.device), hd,
                              cfg.rope_theta)
        q, k, v = _project_qkv(params, cfg, x)
        q = rope_apply(q, sin, cos)
        k = rope_apply(k, sin, cos)
        out = ops.attention(q, k, v, causal=True, impl=cfg.attn_impl,
                            chunk=cfg.attn_chunk)
        new_cache = None
        if mode == "prefill":
            if max_len is not None and max_len > s:
                kc = k.new_zeros((b, max_len, *k.shape[2:]))
                vc = v.new_zeros((b, max_len, *v.shape[2:]))
                kc[:, :s] = k
                vc[:, :s] = v
            else:
                kc, vc = k, v
            new_cache = {"k": kc, "v": vc}
    elif mode == "decode":
        if cache is None or pos is None:
            raise ValueError("decode needs a cache and a position")
        q, k, v = _project_qkv(params, cfg, x)              # s == 1
        k_cache, v_cache = cache["k"], cache["v"]
        cdt = k_cache.dtype
        if isinstance(pos, torch.Tensor) and pos.dim() == 1:
            # Per-slot RoPE phases (continuous batching: every slot is at
            # its own sequence position).
            sin, cos = rope_table(pos, hd, cfg.rope_theta)  # (b, d/2)
            sin, cos = sin[:, None], cos[:, None]           # (b, 1, d/2)
            q = rope_apply(q, sin, cos)
            k = rope_apply(k, sin, cos)
            bidx = torch.arange(b, device=x.device)
            k_cache[bidx, pos.long()] = k[:, 0].to(cdt)
            v_cache[bidx, pos.long()] = v[:, 0].to(cdt)
            length = (pos + 1).to(torch.int32)
        else:
            p = int(pos)
            sin, cos = rope_table(torch.full((1,), p, device=x.device), hd,
                                  cfg.rope_theta)
            q = rope_apply(q, sin, cos)
            k = rope_apply(k, sin, cos)
            k_cache[:, p:p + 1] = k.to(cdt)
            v_cache[:, p:p + 1] = v.to(cdt)
            length = torch.full((b,), p + 1, dtype=torch.int32,
                                device=x.device)
        out = ops.decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                                   length, impl=cfg.attn_impl)[:, None]
        new_cache = cache
    else:
        raise ValueError(f"unknown mode {mode!r}")
    hq, _, d = params["wo"].shape
    y = torch.matmul(out.reshape(b, s, hq * hd),
                     params["wo"].reshape(hq * hd, d))
    return y, new_cache
