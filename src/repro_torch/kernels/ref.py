"""Plain PyTorch versions of the kernels, one for one with the JAX
package's ``kernels/ref.py``.

These are the semantics of record: each CUDA kernel of the port is held
against the function here on the card (``chip_smoke.py``, the ``gpu``
tests), and the kernel wrappers run them for tensors that lie on the CPU.
Where the JAX version feeds low-precision operands to a dot with fp32
accumulation (``preferred_element_type``), the version here upcasts the
operands to fp32 first: a product of two bf16 values is exact in fp32, so
the two agree.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
                ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


def rmsnorm_lowp(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
                 ) -> torch.Tensor:
    """RMSNorm with fp32 statistics but storage-dtype wide ops: only the
    per-row variance reduction upcasts; ``inv`` is rounded to x's dtype and
    the two multiplies run in that dtype."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * w.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (prefill / train): GQA, causal or full.
# q: (b, sq, hq, d)   k, v: (b, skv, hkv, d)
# ---------------------------------------------------------------------------
def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: Optional[float] = None,
                  q_offset: int = 0, kv_len: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"hq={hq} is not a multiple of hkv={hkv}")
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.reshape(b, sq, hkv, g, d).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if kv_len is not None:
        kpos = torch.arange(skv, device=q.device)
        lmask = kpos[None, :] < torch.as_tensor(
            kv_len, device=q.device).reshape(-1, 1)
        scores = torch.where(lmask.reshape(b, 1, 1, 1, skv), scores,
                             NEG_INF)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(skv, device=q.device)[None, :]
        scores = torch.where((qi >= ki)[None, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode attention: single query token against a (possibly longer) cache.
# q: (b, hq, d)   k, v: (b, skv, hkv, d)   length: (b,) valid cache length
# ---------------------------------------------------------------------------
def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length: torch.Tensor, *,
                         scale: Optional[float] = None) -> torch.Tensor:
    out = attention_ref(q[:, None], k, v, causal=False, scale=scale,
                        kv_len=length)
    return out[:, 0]


def quantize_int8(x: torch.Tensor, axis: int = -1
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row (along ``axis`` reduced) int8 quantization."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=axis, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), torch.squeeze(scale, dim=axis)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, scale: Optional[float] = None,
                      chunk: int = 512) -> torch.Tensor:
    """Query-chunked attention with storage-dtype operands (fp32
    accumulation): the (s x s) score tensor never materializes, only one
    (chunk x s) slab per chunk."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    chunk = min(chunk, sq)
    if sq % chunk:
        raise ValueError(f"sq={sq} is not a multiple of chunk={chunk}")
    kf, vf = k.float(), v.float()
    kpos = torch.arange(skv, device=q.device)
    outs = []
    for c0 in range(0, sq, chunk):
        qc = q[:, c0:c0 + chunk].reshape(b, chunk, hkv, g, d).float()
        s = torch.einsum("bchgd,bkhd->bhcgk", qc, kf) * scale
        if causal:
            rows = c0 + torch.arange(chunk, device=q.device)
            mask = rows[:, None] >= kpos[None, :]
            s = torch.where(mask[None, None, :, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(v.dtype).float()
        o = torch.einsum("bhcgk,bkhd->bchgd", p, vf)
        outs.append(o.to(q.dtype).reshape(b, chunk, hq, d))
    return torch.cat(outs, dim=1)


def decode_attention_lowcast(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, length: torch.Tensor, *,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention without upcasting the KV cache: q is cast to the
    cache dtype and the dots accumulate in fp32; only the (b, h, skv)
    scores run in fp32."""
    b, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qr = q.reshape(b, hkv, g, d).to(k.dtype).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qr, k.float()) * scale
    lmask = torch.arange(skv, device=q.device)[None, None, None, :] < \
        torch.as_tensor(length, device=q.device).reshape(b, 1, 1, 1)
    s = torch.where(lmask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return o.reshape(b, hq, d).to(q.dtype)
