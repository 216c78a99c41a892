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
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _acc(t: torch.Tensor) -> torch.dtype:
    """The dtype the plain versions compute in: float32, or float64 for
    float64 inputs (``torch.autograd.gradcheck``)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
                ) -> torch.Tensor:
    xf = x.to(_acc(x))
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.to(xf.dtype)).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients of ``rmsnorm_ref`` in closed form: with r = rsqrt(mean(x^2)
    + eps), dx = r (w dy) - x r^3 mean(x w dy), rounded once to x's dtype,
    and dw = sum over rows of dy x r, in w's dtype."""
    acc = _acc(x)
    xf, wf, gf = x.to(acc), w.to(acc), dy.to(acc)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    wg = wf * gf
    k = r * r * r * torch.mean(xf * wg, dim=-1, keepdim=True)
    dx = r * wg - xf * k
    dw = (gf * (xf * r)).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw.to(w.dtype)


def rmsnorm_lowp(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
                 ) -> torch.Tensor:
    """RMSNorm with fp32 statistics but storage-dtype wide ops: only the
    per-row variance reduction upcasts; ``inv`` is rounded to x's dtype and
    the two multiplies run in that dtype."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * w.to(x.dtype)


def rmsnorm_lowp_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                         eps: float = 1e-5
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients of ``rmsnorm_lowp`` in closed form, rounded where
    ``jax.grad`` of the JAX package's ``rmsnorm_lowp`` rounds: with j =
    mean(x^2) + eps, r = rsqrt(j), inv = r in x's dtype and g = dy * w in
    x's dtype, every product below in x's dtype,
    dx = g inv + (sum(x g) (-r / (2 j)) / d) 2x, that term rounded before
    the add; dw = sum over rows of (x inv) dy, rounded to x's dtype, in w's.
    The sums run in fp32 and are rounded once. In float32 (and float64)
    every rounding is the identity: this is ``rmsnorm_bwd_ref``."""
    if x.dtype in (torch.float32, torch.float64):
        return rmsnorm_bwd_ref(x, w, dy, eps)
    dt, d = x.dtype, x.shape[-1]
    xf = x.float()
    j = torch.sum(xf * xf, dim=-1, keepdim=True) / d + eps
    r = torch.rsqrt(j)
    inv = r.to(dt)
    g = dy * w.to(dt)
    sd = (x * g).float().sum(-1, keepdim=True).to(dt).float()
    c = sd * (-0.5 * (r / j)) / d
    dx = ((g * inv).float() + (c * (2 * xf)).to(dt).float()).to(dt)
    dw = ((x * inv) * dy).float().reshape(-1, d).sum(0).to(dt)
    return dx, dw.to(w.dtype)


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
    qf = q.reshape(b, sq, hkv, g, d).to(_acc(q))
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(qf.dtype)) * scale
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
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(qf.dtype))
    return out.reshape(b, sq, hq, d).to(q.dtype)


def _causal_mask(sq: int, skv: int, device) -> torch.Tensor:
    """(sq, skv): True where key j is visible from query i (j <= i)."""
    return torch.arange(sq, device=device)[:, None] >= \
        torch.arange(skv, device=device)[None, :]


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, scale: Optional[float] = None
                      ) -> torch.Tensor:
    """Each query row's log-sum-exp of its scaled, masked scores, as the
    flash kernel writes it: (b, hq, sq), float32 (float64 for float64)."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.reshape(b, sq, hkv, g, d).to(_acc(q))
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(qf.dtype)) * scale
    if causal:
        s = torch.where(_causal_mask(sq, skv, q.device), s, NEG_INF)
    return torch.logsumexp(s, dim=-1).reshape(b, hq, sq)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, dout: torch.Tensor,
                      lse: torch.Tensor, *, causal: bool = True,
                      scale: Optional[float] = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of ``attention_ref`` (no kv_len, no q_offset) in closed
    form, FlashAttention's: P = exp(S scale - lse), delta = rowsum(dO O),
    dS = P (dO V^T - delta); dQ = dS K scale, dK = dS^T Q scale and
    dV = P^T dO, each summed over the q heads of its kv head. ``lse`` is
    the forward's (b, hq, sq). Returns (dq, dk, dv) in q's, k's, v's
    dtypes."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    acc = _acc(q)
    qf = q.reshape(b, sq, hkv, g, d).to(acc)
    of = out.reshape(b, sq, hkv, g, d).to(acc)
    gf = dout.reshape(b, sq, hkv, g, d).to(acc)
    kf, vf = k.to(acc), v.to(acc)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    p = torch.exp(s - lse.to(acc).reshape(b, hkv, g, sq, 1))
    if causal:
        p = torch.where(_causal_mask(sq, skv, q.device), p, 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", gf, vf)
    delta = torch.einsum("bqhgd,bqhgd->bhgq", gf, of)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, gf)
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


def decode_attention_partial_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, length: torch.Tensor, *,
                                 scale: Optional[float] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode attention over one slice of the cache, with each row's
    log-sum-exp of its scaled scores: (out (b, hq, d) in q's dtype, lse
    (b, hq) float32). A slot whose ``length`` is 0 gives out 0 and lse
    -inf, so that slices combine by ``exp(lse - max)`` weights."""
    b, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.reshape(b, hkv, g, d).to(_acc(q))
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k.to(qf.dtype)) * scale
    valid = (torch.arange(skv, device=q.device)[None, :]
             < length.to(q.device).reshape(b, 1))[:, None, None, :]
    s = torch.where(valid, s, -math.inf)
    lse = torch.logsumexp(s, dim=-1)                       # (b, hkv, g)
    empty = torch.isneginf(lse)[..., None]
    p = torch.where(valid, torch.exp(s - torch.where(
        empty, 0.0, lse[..., None])), 0.0)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v.to(qf.dtype))
    out = torch.where(empty, 0.0, out)
    return (out.reshape(b, hq, d).to(q.dtype),
            lse.reshape(b, hq).to(torch.float32))


# ---------------------------------------------------------------------------
# Int8 W8A8 matmul with per-channel scales.
# x_q: (m, k) int8, sx: (m,) f32;  w_q: (k, n) int8, sw: (n,) f32
# ---------------------------------------------------------------------------
def int8_matmul_ref(x_q: torch.Tensor, sx: torch.Tensor, w_q: torch.Tensor,
                    sw: torch.Tensor) -> torch.Tensor:
    """The JAX version accumulates in int32, which ``torch.matmul`` has no
    CUDA path for. float64 holds every partial sum exactly (|acc| <=
    127^2 * k, far below 2^53), so its product is the int32 one; the cast
    to float32 then rounds as int32 -> float32 does, and the scales apply
    in the reference's order."""
    acc = torch.matmul(x_q.double(), w_q.double())
    return acc.float() * sx.float()[:, None] * sw.float()[None, :]


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


# ---------------------------------------------------------------------------
# Mamba-2 SSD.
# x:  (b, s, h, p)    per-head inputs (p = headdim)
# dt: (b, s, h)       positive step sizes (already softplus'ed + bias)
# A:  (h,)            negative per-head decay rates
# B:  (b, s, n)       shared across heads (ngroups=1), n = d_state
# C:  (b, s, n)
# D:  (h,)            skip
# Returns y: (b, s, h, p) in x's dtype and the final state (b, h, p, n) fp32.
# ---------------------------------------------------------------------------
def ssd_ref(x, dt, A, B, C, D, init_state=None):
    """Sequential-recurrence oracle: one step at a time."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    decay = torch.exp(dtf * A.float()[None, None, :])      # (b, s, h)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(s):
        dbx = torch.einsum("bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], Bf[:, t])
        state = state * decay[:, t, :, None, None] + dbx
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((b, 0, h, p))
    y = y + xf * D.float()[None, None, :, None]
    return y.to(x.dtype), state


def ssd_decode_ref(x, dt, A, B, C, D, state):
    """One-token SSD recurrence. x: (b, h, p), dt: (b, h), B/C: (b, n),
    state: (b, h, p, n) fp32 -> (y (b, h, p) in x's dtype, new state)."""
    xf, dtf = x.float(), dt.float()
    a = torch.exp(dtf * A.float()[None, :])
    dbx = torch.einsum("bh,bhp,bn->bhpn", dtf, xf, B.float())
    state = state * a[..., None, None] + dbx
    y = torch.einsum("bhpn,bn->bhp", state, C.float())
    y = y + xf * D.float()[None, :, None]
    return y.to(x.dtype), state


def check_ssd_chunk(s: int, chunk: int) -> int:
    """The chunk ``ssd_chunked`` runs for ``s`` steps: ``min(chunk, s)``,
    which must divide ``s`` (the JAX package asserts the same)."""
    if s < 1 or chunk < 1:
        raise ValueError(f"ssd needs s >= 1 and chunk >= 1, got s={s}, "
                         f"chunk={chunk}")
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"ssd: s={s} is neither <= chunk={chunk} nor a "
                         "multiple of it")
    return q


def ssd_chunked(x, dt, A, B, C, D, chunk: int = 256, init_state=None):
    """Chunked SSD, the same math as the TPU kernel: within a chunk of Q
    steps, the masked-decay product M[t, j] = (C_t . B_j) exp(L_t - L_j)
    [j <= t] applied to dt * x; across chunks, a read of the carried fp32
    state and its update. The D skip is added in fp32 before the one
    rounding to x's dtype. (float64 inputs compute in float64, for
    ``torch.autograd.gradcheck``.)"""
    b, s, h, p = x.shape
    n = B.shape[-1]
    chunk = check_ssd_chunk(s, chunk)
    nc = s // chunk
    f32 = _acc(x)
    xr = x.to(f32).reshape(b, nc, chunk, h, p)
    dtr = dt.to(f32).reshape(b, nc, chunk, h)
    Br = B.to(f32).reshape(b, nc, chunk, n)
    Cr = C.to(f32).reshape(b, nc, chunk, n)
    Af = A.to(f32)

    L = torch.cumsum(dtr * Af[None, None, None, :], dim=2)  # (b,nc,Q,h)
    cb = torch.einsum("bctn,bcjn->bctj", Cr, Br)             # (b,nc,Q,Q)
    logdec = L[:, :, :, None, :] - L[:, :, None, :, :]      # (b,nc,Q,Q,h)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    M = cb[..., None] * torch.exp(
        torch.where(tri[None, None, :, :, None], logdec, NEG_INF))
    y_intra = torch.einsum("bctjh,bcjh,bcjhp->bcthp", M, dtr, xr)

    # chunk summaries: G_c = sum_j exp(L_last - L_j) dt_j B_j (x) x_j
    w = torch.exp(L[:, :, -1:, :] - L) * dtr                 # (b,nc,Q,h)
    G = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Br, w, xr)    # (b,nc,h,n,p)
    a_chunk = torch.exp(L[:, :, -1])                          # (b,nc,h)

    h_in = (torch.zeros((b, h, n, p), dtype=f32, device=x.device)
            if init_state is None else init_state.to(f32).transpose(-1, -2))
    h_ins = []
    for c in range(nc):                     # state BEFORE each chunk
        h_ins.append(h_in)
        h_in = h_in * a_chunk[:, c, :, None, None] + G[:, c]
    h_ins = torch.stack(h_ins, dim=1)                         # (b,nc,h,n,p)
    y_inter = torch.einsum("bctn,bcth,bchnp->bcthp", Cr, torch.exp(L), h_ins)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    y = y + x.to(f32) * D.to(f32)[None, None, :, None]
    return y.to(x.dtype), h_in.transpose(-1, -2).contiguous()


def ssd_chunked_bwd_ref(x, dt, A, B, C, D, dy, dstate=None, chunk: int = 256):
    """Gradients of ``ssd_chunked`` (no init_state) in closed form, with
    fp32 sums: ``dy`` the gradient of y (b, s, h, p), ``dstate`` that of the
    final state (b, h, p, n), or None for zero. Per head and chunk, with
    l_k = dt_k A, L its inclusive cumsum, T the chunk's last step, u_j =
    dt_j x_j, H the (n, p) state entering the chunk and dS the gradient of
    the state leaving it, K[t, j] = C_t . B_j, E[t, j] = exp(L_t - L_j)
    (j <= t, else 0), P[t, j] = dy_t . u_j and Q = K E P:

    * du_j = sum_t K E[t, j] dy_t + exp(L_T - L_j) dS^T B_j;
      dx_j = dt_j du_j + D dy_j; ddt_j = x_j . du_j + A dl_j;
    * dC_t = sum_j E P[t, j] B_j + exp(L_t) H dy_t,
      dB_j = sum_t E P[t, j] C_t + exp(L_T - L_j) dS u_j, both summed over
      the heads (B and C are shared across them); dD = sum dy . x;
    * the state entering the chunk gets exp(L_T) dS + sum_t exp(L_t) C_t
      dy_t^T: the previous chunk's dS, a reverse recurrence;
    * dl_k, the gradient of l_k, takes every term whose decay spans step
      k: sum_{t >= k} sum_{j < k} Q[t, j] (the pairs straddling k), sum_{t
      >= k} exp(L_t) (C_t^T H) . dy_t, exp(L_T) <H, dS> and sum_{j < k}
      exp(L_T - L_j) B_j^T dS u_j; dA = sum dt_k dl_k. Taken so, no two
      large sums cancel (the cumsum's own backward would subtract column
      sums of Q from row sums).

    Returns (dx, ddt, dA, dB, dC, dD): dx, dB, dC in their inputs' dtypes,
    rounded once; ddt, dA, dD in float32 (float64 for float64 inputs)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = check_ssd_chunk(s, chunk)
    nc = s // q
    acc = _acc(x)
    xr = x.to(acc).reshape(b, nc, q, h, p)
    gy = dy.to(acc).reshape(b, nc, q, h, p)
    dtr = dt.to(acc).reshape(b, nc, q, h)
    Br = B.to(acc).reshape(b, nc, q, n)
    Cr = C.to(acc).reshape(b, nc, q, n)
    Af, Df = A.to(acc), D.to(acc)

    L = torch.cumsum(dtr * Af, dim=2)                        # (b,nc,Q,h)
    eL = torch.exp(L)
    a = eL[:, :, -1]                                         # (b,nc,h)
    wl = torch.exp(L[:, :, -1:] - L)                         # exp(L_T - L_j)
    u = dtr[..., None] * xr                                  # (b,nc,Q,h,p)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    E = torch.exp(torch.where(tri[None, None, :, :, None],
                              L[:, :, :, None, :] - L[:, :, None, :, :],
                              NEG_INF))                      # (b,nc,t,j,h)
    K = torch.einsum("bctn,bcjn->bctj", Cr, Br)
    P = torch.einsum("bcthp,bcjhp->bctjh", gy, u)
    KE = K[..., None] * E
    EP = E * P
    Q = KE * P

    # States entering each chunk (forward) and the gradient of the state
    # leaving each chunk (reverse), (b, nc, h, n, p).
    G = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Br, wl * dtr, xr)
    Gd = torch.einsum("bctn,bcth,bcthp->bchnp", Cr, eL, gy)
    hs = torch.zeros((b, h, n, p), dtype=acc, device=x.device)
    ds = (torch.zeros_like(hs) if dstate is None
          else dstate.to(acc).transpose(-1, -2))
    H, dS = [None] * nc, [None] * nc
    for c in range(nc):
        H[c] = hs
        hs = hs * a[:, c, :, None, None] + G[:, c]
    for c in reversed(range(nc)):
        dS[c] = ds
        ds = ds * a[:, c, :, None, None] + Gd[:, c]
    H, dS = torch.stack(H, dim=1), torch.stack(dS, dim=1)

    du = torch.einsum("bctjh,bcthp->bcjhp", KE, gy) + wl[..., None] * \
        torch.einsum("bcjn,bchnp->bcjhp", Br, dS)
    dx = dtr[..., None] * du + Df[:, None] * gy
    hdy = torch.einsum("bchnp,bcthp->bcthn", H, gy)           # H dy_t
    dsu = torch.einsum("bchnp,bcjhp->bcjhn", dS, u)           # dS u_j
    dC = torch.einsum("bctjh,bcjn->bctn", EP, Br) + \
        torch.einsum("bcth,bcthn->bctn", eL, hdy)
    dB = torch.einsum("bctjh,bctn->bcjn", EP, Cr) + \
        torch.einsum("bcjh,bcjhn->bcjn", wl, dsu)

    qpre = torch.cumsum(Q, dim=3) - Q             # sum_{j < k} Q[t, j]
    dl = (qpre * tri[None, None, :, :, None]).sum(dim=2)     # sum_{t >= k}
    iy = eL * torch.einsum("bctn,bcthn->bcth", Cr, hdy)
    r = wl * torch.einsum("bcjn,bcjhn->bcjh", Br, dsu)
    dl = dl + torch.flip(torch.cumsum(torch.flip(iy, (2,)), 2), (2,)) + \
        (a * torch.einsum("bchnp,bchnp->bch", H, dS))[:, :, None] + \
        torch.cumsum(r, dim=2) - r
    ddt = torch.einsum("bcjhp,bcjhp->bcjh", xr, du) + Af * dl
    dA = torch.einsum("bcjh,bcjh->h", dtr, dl)
    dD = torch.einsum("bcthp,bcthp->h", gy, xr)
    return (dx.reshape(b, s, h, p).to(x.dtype), ddt.reshape(b, s, h),
            dA, dB.reshape(b, s, n).to(B.dtype),
            dC.reshape(b, s, n).to(C.dtype), dD)
