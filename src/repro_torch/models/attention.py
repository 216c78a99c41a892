"""GQA multi-head attention with RoPE and a decode KV cache.

Modes, as in the JAX package's ``models/attention.py``:
  * train   — full causal self-attention (no cache)
  * prefill — causal self-attention that also emits the KV cache, padded
              to ``max_len``
  * decode  — one new token written at ``pos`` into the cache, then
              attention against the first ``pos + 1`` cache rows

The JAX package returns a new cache (its engine donates the old one). Here
decode writes the new K/V row into the given cache tensors **in place** and
returns the same dict, which saves a copy of the whole cache per token. On
a mesh the cache is a DTensor, sequence-sharded over ``kv_seq``; the row
at ``pos`` is written by the rank whose shard holds it, into its local
shard (:func:`_write_rows`), and the decode kernel reads each rank's
slice (``kernels/ops.py``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.config.base import ModelConfig
from repro_torch.distributed.sharding import (local_slice, shard,
                                              whole_heads)
from repro_torch.kernels import ops
from repro_torch.models.layers import (dense_init, linear, pad_seq,
                                       rope_apply, rope_table)

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
    """x (b, s, d) @ w (d, h, k) -> (b, s, h, k). On a mesh, DTensor may
    split the product's h * k columns over a mesh dim whose size does not
    divide h (8 kv heads over a model axis of 16), which no split into
    (h, k) keeps: there the columns are gathered first."""
    d, h, k = w.shape
    y = linear(x, w.reshape(d, h * k))
    if isinstance(y, DTensor):
        y = whole_heads(y, h)
    return y.reshape(*x.shape[:2], h, k)


def _project_qkv(params: Params, cfg: ModelConfig, x: torch.Tensor):
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = shard(q, ("batch", "seq", "heads_act", None))
    k = shard(k, ("batch", "seq", "kv_heads_act", None))
    v = shard(v, ("batch", "seq", "kv_heads_act", None))
    return q, k, v


CACHE_LOGICAL = ("batch", "kv_seq", "kv_heads_act", None)


def _write_rows(cache: DTensor, new: torch.Tensor, pos: torch.Tensor
                ) -> None:
    """Write ``new`` (b, 1, hkv, d) at row ``pos[i]`` of slot ``i`` of a
    DTensor cache (b, max_len, hkv, d), in place: each rank writes the
    slots and rows its local shard holds; a row held elsewhere leaves the
    shard as it was."""
    plc = cache.placements
    if any(isinstance(p, Shard) and p.dim >= 2 for p in plc):
        raise NotImplementedError("a cache sharded over kv heads or d")
    local = cache.to_local()
    b_off, b_len = local_slice(cache, plc, 0)
    s_off, s_len = local_slice(cache, plc, 1)
    rows = new.redistribute(placements=[
        p if p == Shard(0) else Replicate() for p in plc]).to_local()
    at = pos.to(local.device).long()[b_off:b_off + b_len] - s_off
    own = (at >= 0) & (at < s_len)
    at = torch.clamp(at, 0, s_len - 1)
    bidx = torch.arange(b_len, device=local.device)
    local[bidx, at] = torch.where(own[:, None, None],
                                  rows[:, 0].to(local.dtype),
                                  local[bidx, at])


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
        if mode == "prefill" and isinstance(k, DTensor):
            pad = max(0, (max_len or s) - s)
            new_cache = {"k": shard(pad_seq(k, 0, pad), CACHE_LOGICAL),
                         "v": shard(pad_seq(v, 0, pad), CACHE_LOGICAL)}
        elif mode == "prefill":
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
            if isinstance(k_cache, DTensor):
                _write_rows(k_cache, k, pos)
                _write_rows(v_cache, v, pos)
            else:
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
            length = torch.full((b,), p + 1, dtype=torch.int32,
                                device=x.device)
            if isinstance(k_cache, DTensor):
                _write_rows(k_cache, k, length - 1)
                _write_rows(v_cache, v, length - 1)
            else:
                k_cache[:, p:p + 1] = k.to(cdt)
                v_cache[:, p:p + 1] = v.to(cdt)
        out = ops.decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                                   length, impl=cfg.attn_impl)[:, None]
        new_cache = cache
    else:
        raise ValueError(f"unknown mode {mode!r}")
    out = shard(out, ("batch", "seq", "heads_act", None))
    hq, _, d = params["wo"].shape
    y = linear(out.reshape(b, s, hq * hd), params["wo"].reshape(hq * hd, d))
    return y, new_cache
