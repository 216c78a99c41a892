"""Shared layers: initializers, RMSNorm, RoPE, SwiGLU MLP, embeddings.

Plain functions on dicts of tensors, one for one with the JAX package's
``models/layers.py``: every module is an ``init(gen, ..., device) ->
params`` plus an ``apply(params, x, ...)``. Parameter names and layouts are
the JAX package's, so that ``repro_torch.convert`` maps one onto the other
leaf by leaf. Each ``specs()`` gives the JAX package's logical sharding
spec of every leaf (``distributed.sharding`` resolves it on a mesh), and
the activations are ``shard()``-ed at the JAX package's call sites, in
its logical names: the identity without a mesh, a DTensor redistribute
under ``use_sharding(mesh, rules)``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (on_local_shards, replicated,
                                              row_placements, shard)
from repro_torch.kernels import ops

Params = Dict[str, Any]


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               device: torch.device, scale: float = 0.02) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * scale).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm_init(d: int, device: torch.device) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm_specs() -> Params:
    return {"scale": (None,)}


def rmsnorm_apply(params: Params, x: torch.Tensor, eps: float,
                  lowp: bool = False) -> torch.Tensor:
    return ops.rmsnorm(x, params["scale"], eps, lowp=lowp)


def pad_seq(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Zero-pad dim 1, the sequence, of ``x`` (b, s, ...). A DTensor is
    padded on its local shards with the sequence whole: PyTorch 2.11's
    DTensor gives ``constant_pad_nd`` a wrong placement list on a mesh of
    more than one dim."""
    pad = (0, 0) * (x.dim() - 2) + (before, after)
    if not isinstance(x, DTensor):
        return F.pad(x, pad)
    plc = row_placements(x, [1])
    return on_local_shards(lambda t: F.pad(t, pad), x.device_mesh, (plc,),
                           plc, (plc,))(x)


# ---------------------------------------------------------------------------
# Rotary position embeddings.
# ---------------------------------------------------------------------------
def rope_table(positions: torch.Tensor, head_dim: int, theta: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (s,) int -> (sin, cos) each (s, head_dim//2) fp32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    # theta stays a Python scalar: a device tensor made from it would be a
    # host-to-device copy, which waits for the stream, in every layer.
    freqs = 1.0 / torch.pow(theta, exps)
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.sin(ang), torch.cos(ang)


def rope_apply(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """x: (b, s, h, d); sin/cos: (s, d//2) or per-batch (b, s, d//2)."""
    half = x.shape[-1] // 2
    sin, cos = replicated(sin, x), replicated(cos, x)
    if sin.dim() == 2:
        sin, cos = sin[None, :, None, :], cos[None, :, None, :]
    else:
        sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP (dense FFN).
# ---------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, d: int, f: int, dtype: torch.dtype,
             device: torch.device) -> Params:
    return {
        "w_gate": dense_init(gen, (d, f), dtype, device),
        "w_up": dense_init(gen, (d, f), dtype, device),
        "w_down": dense_init(gen, (f, d), dtype, device),
    }


def mlp_specs() -> Params:
    return {
        "w_gate": ("p_embed", "p_mlp"),
        "w_up": ("p_embed", "p_mlp"),
        "w_down": ("p_mlp", "p_embed"),
    }


def mlp_apply(params: Params, x: torch.Tensor, lowp: bool = False
              ) -> torch.Tensor:
    g = torch.matmul(x, params["w_gate"])
    u = torch.matmul(x, params["w_up"])
    if lowp:
        h = F.silu(g) * u
    else:
        h = F.silu(g.float()).to(x.dtype) * u
    h = shard(h, ("batch", "seq", "mlp_act"))
    return torch.matmul(h, params["w_down"])


# ---------------------------------------------------------------------------
# Token embedding / unembedding.
# ---------------------------------------------------------------------------
def embed_init(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype,
               tie: bool, device: torch.device) -> Params:
    p = {"embedding": dense_init(gen, (vocab, d), dtype, device)}
    if not tie:
        p["unembed"] = dense_init(gen, (d, vocab), dtype, device)
    return p


def embed_specs(tie: bool) -> Params:
    p = {"embedding": ("p_vocab", "p_embed")}
    if not tie:
        p["unembed"] = ("p_embed", "p_vocab")
    return p


def embed_apply(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return shard(params["embedding"][tokens], ("batch", "seq", "embed_act"))


def unembed_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    if "unembed" in params:
        logits = torch.matmul(x, params["unembed"])
    else:
        logits = torch.matmul(x, params["embedding"].t())
    return shard(logits, ("batch", "seq", "vocab_act"))
