"""Mamba-2 (SSD) mixer layer with causal depthwise conv and gated RMSNorm.

One for one with the JAX package's ``models/mamba2.py``: train and prefill
run the chunked SSD (``kernels.ops.ssd``: the CUDA kernels on the card,
forward and, under grad, backward; the plain ``ref.ssd_chunked`` and its
closed-form backward on the CPU); decode runs the O(1) one-token
recurrence ``ref.ssd_decode_ref`` in plain PyTorch, as the JAX package
runs it outside any kernel, carrying (conv_state, ssd_state).

Decode updates the given cache tensors **in place** and returns the same
dict, as ``models/attention.py`` does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.distributed.sharding import shard
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_decode_ref
from repro_torch.models.layers import dense_init, linear, pad_seq

Params = Dict[str, Any]


def _dims(cfg: ModelConfig):
    m = cfg.mamba
    if m is None:
        raise ValueError(f"{cfg.name}: a Mamba layer needs cfg.mamba")
    return m, m.d_inner(cfg.d_model), m.n_heads(cfg.d_model)


def mamba_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
               device: torch.device) -> Params:
    m, di, nh = _dims(cfg)
    d, n = cfg.d_model, m.d_state
    conv_dim = di + 2 * n
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # in_proj emits [z (di), x (di), B (n), C (n), dt (nh)]
        "w_in": dense_init(gen, (d, 2 * di + 2 * n + nh), dtype, device),
        "conv_w": dense_init(gen, (m.d_conv, conv_dim), dtype, device,
                             scale=0.1),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "dt_bias": torch.zeros((nh,), **f32),
        "D": torch.ones((nh,), **f32),
        "norm_scale": torch.ones((di,), **f32),
        "w_out": dense_init(gen, (di, d), dtype, device),
    }


def mamba_specs(cfg: ModelConfig) -> Params:
    return {
        "w_in": ("p_embed", "p_inner"),
        "conv_w": (None, "p_inner"),
        "conv_b": ("p_inner",),
        "A_log": (None,),
        "dt_bias": (None,),
        "D": (None,),
        "norm_scale": ("p_inner",),
        "w_out": ("p_inner", "p_embed"),
    }


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Params:
    m, di, nh = _dims(cfg)
    conv_dim = di + 2 * m.d_state
    return {
        "conv": torch.zeros((batch, m.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssd": torch.zeros((batch, nh, m.headdim, m.d_state),
                           dtype=torch.float32, device=device),
    }


def mamba_cache_specs() -> Params:
    return {
        "conv": ("batch", None, "mlp_act"),
        "ssd": ("batch", "heads_act", None, None),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    m, di, nh = _dims(cfg)
    n = m.d_state
    return (proj[..., :di], proj[..., di: 2 * di + 2 * n],
            proj[..., 2 * di + 2 * n:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv from a zero history. xbc: (b, s, c); w: (k, c).
    ``k`` shifted multiply-adds in fp32, as the JAX package writes it (a
    cuDNN convolution would run fp32 in TF32)."""
    k, s = w.shape[0], xbc.shape[1]
    xp = pad_seq(xbc, k - 1, 0)
    wf = w.float()
    out = xp[:, 0:s].float() * wf[0]
    for i in range(1, k):
        out = out + xp[:, i: i + s].float() * wf[i]
    out = out + b.float()
    return F.silu(out).to(xbc.dtype)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    g = y.float() * F.silu(z.float())
    var = torch.mean(g * g, dim=-1, keepdim=True)
    return (g * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def mamba_apply(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
                mode: str, cache: Optional[Params] = None
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (b, s, d) -> (out, cache)."""
    m, di, nh = _dims(cfg)
    n, p = m.d_state, m.headdim
    b, s, _ = x.shape
    proj = shard(linear(x, params["w_in"]), ("batch", "seq", "mlp_act"))
    z, xbc, dt_raw = _split_proj(cfg, proj)
    A = -torch.exp(params["A_log"])

    if mode in ("train", "prefill"):
        xbc_c = _causal_conv(xbc, params["conv_w"], params["conv_b"])
        xs = xbc_c[..., :di].reshape(b, s, nh, p).contiguous()
        B = xbc_c[..., di: di + n].contiguous()
        C = xbc_c[..., di + n:].contiguous()
        dt = F.softplus(dt_raw.float() + params["dt_bias"])
        y, state = ops.ssd(xs, dt, A, B, C, params["D"],
                           chunk=m.chunk_size)
        y = y.reshape(b, s, di)
        new_cache = None
        if mode == "prefill":
            keep = m.d_conv - 1
            conv = (xbc[:, s - keep:] if s >= keep
                    else pad_seq(xbc, keep - s, 0))
            new_cache = {"conv": conv.to(x.dtype).contiguous(), "ssd": state}
    elif mode == "decode":
        if cache is None or s != 1:
            raise ValueError("decode needs a cache and one token per row")
        conv_hist = torch.cat([cache["conv"], xbc], dim=1)   # (b, k, c)
        acc = torch.einsum("bkc,kc->bc", conv_hist.float(),
                           params["conv_w"].float())
        xbc_c = F.silu(acc + params["conv_b"].float()).to(x.dtype)
        xs = xbc_c[:, :di].reshape(b, nh, p)
        dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])
        y1, state = ssd_decode_ref(xs, dt, A, xbc_c[:, di: di + n],
                                   xbc_c[:, di + n:], params["D"],
                                   cache["ssd"])
        y = y1.reshape(b, 1, di)
        cache["conv"].copy_(conv_hist[:, 1:])
        cache["ssd"].copy_(state)
        new_cache = cache
    else:
        raise ValueError(f"unknown mode {mode!r}")

    y = _gated_norm(y, z, params["norm_scale"], cfg.norm_eps)
    y = shard(y, ("batch", "seq", "mlp_act"))
    return linear(y, params["w_out"]), new_cache
