"""The backward kernels' algorithms on the CPU, against the JAX package.

The JAX package has no backward kernel: its gradient is ``jax.grad`` of
``repro.kernels.ref``. So each backward design of ``csrc/`` is emulated
here tile for tile in fp32 (the same tiles, the log-sum-exp recomputation,
the loop over a kv head's q heads, the causal tile skip; the rmsnorm
backward's per-block partials of dw and their fixed-order sum) and held,
with the closed-form plain backwards of ``kernels/ref.py``, to
``torch.autograd`` of the plain forward and to ``jax.grad`` of the JAX
package's reference at 1e-5 relative to the gradient's max-abs (fp32 sums
in other orders). The autograd Functions are held in float64 by
``torch.autograd.gradcheck``, and the wiring of the card path (the
Function, the grad guard of the kernels without a backward) is checked
with the device test monkeypatched, as the kernels cannot run here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import int8_matmul as tint8
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trmsnorm
from repro_torch.kernels import ssd_scan as tssd

TOL = 1e-5
TILE = 64   # q and kv rows a tile of csrc/flash_attention.cu's backward


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------------------
# Attention.
# ---------------------------------------------------------------------------
def fa2_bwd_emulated(q, k, v, out, dout, lse, causal, scale):
    """``flash_bwd_preprocess_kernel``, ``flash_bwd_dkdv_kernel`` and
    ``flash_bwd_dq_kernel`` in fp32: returns (dq, dk, dv, visited), where
    visited lists the (kv tile, q tile) pairs the dK/dV blocks walk."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    f = lambda t: t.detach().to(torch.float32)
    qf, kf, vf, of, gf = map(f, (q, k, v, out, dout))
    delta = (gf * of).sum(-1)                       # (b, sq, hq)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    visited = set()

    def p_ds(s_, lse_rows, delta_rows, dp, kv_idx, q_idx):
        ok = (kv_idx[:, None] <= q_idx[None, :]) if causal else \
            torch.ones_like(s_, dtype=torch.bool)
        p = torch.where(ok, torch.exp(s_ * scale - lse_rows), 0.0)
        return p, p * (dp - delta_rows)

    for bb in range(b):
        for kvh in range(hkv):
            for k0 in range(0, skv, TILE):
                K, V = kf[bb, k0:k0 + TILE, kvh], vf[bb, k0:k0 + TILE, kvh]
                kv_idx = torch.arange(k0, k0 + K.shape[0])
                dK, dV = torch.zeros_like(K), torch.zeros_like(V)
                for gi in range(g):
                    h = kvh * g + gi
                    for q0 in range((k0 // TILE) * TILE if causal else 0,
                                    sq, TILE):
                        visited.add((k0 // TILE, q0 // TILE))
                        Q = qf[bb, q0:q0 + TILE, h]
                        dO = gf[bb, q0:q0 + TILE, h]
                        q_idx = torch.arange(q0, q0 + Q.shape[0])
                        p, ds = p_ds(K @ Q.T, lse[bb, h, q0:q0 + TILE][None],
                                     delta[bb, q0:q0 + TILE, h][None],
                                     V @ dO.T, kv_idx, q_idx)
                        dV += p @ dO
                        dK += ds @ Q
                dk[bb, k0:k0 + TILE, kvh] = dK * scale
                dv[bb, k0:k0 + TILE, kvh] = dV
    for bb in range(b):
        for h in range(hq):
            kvh = h // g
            for q0 in range(0, sq, TILE):
                Q, dO = qf[bb, q0:q0 + TILE, h], gf[bb, q0:q0 + TILE, h]
                q_idx = torch.arange(q0, q0 + Q.shape[0])
                dQ = torch.zeros_like(Q)
                kv_end = min(skv, q0 + TILE) if causal else skv
                for k0 in range(0, kv_end, TILE):
                    K = kf[bb, k0:min(k0 + TILE, kv_end), kvh]
                    V = vf[bb, k0:min(k0 + TILE, kv_end), kvh]
                    kv_idx = torch.arange(k0, k0 + K.shape[0])
                    _, ds = p_ds((Q @ K.T).T, lse[bb, h, q0:q0 + TILE][None],
                                 delta[bb, q0:q0 + TILE, h][None],
                                 (dO @ V.T).T, kv_idx, q_idx)
                    dQ += ds.T @ K
                dq[bb, q0:q0 + TILE, h] = dQ * scale
    return dq, dk, dv, visited


def _attn_case(rng, b, s, hq, hkv, d):
    shapes = ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d))
    return [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
            for sh in shapes]


def _jax_attention_grads(q, k, v, dout, causal):
    _, vjp = jax.vjp(lambda a, b_, c: jref.attention_ref(a, b_, c,
                                                         causal=causal),
                     *(jnp.asarray(_np(t)) for t in (q, k, v)))
    return vjp(jnp.asarray(_np(dout)))


ATTN_CASES = [(2, 130, 8, 1, 16), (1, 65, 4, 2, 32), (2, 77, 16, 2, 16),
              (1, 64, 2, 2, 64), (1, 1, 8, 1, 16), (1, 200, 8, 4, 16)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,hq,hkv,d", ATTN_CASES)
def test_fa2_backward_emulation_matches_autograd_and_jax(causal, b, s, hq,
                                                         hkv, d, rng):
    """Groups 8, 2 and 1 (and 4, 2), lengths on, below and past the
    64-row tile; the emulated kernels, the closed form, torch.autograd of
    the plain forward and jax.grad of the JAX reference agree."""
    q, k, v, dout = _attn_case(rng, b, s, hq, hkv, d)
    scale = d ** -0.5
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tref.attention_ref(*leaves, causal=causal)
    auto = torch.autograd.grad(out, leaves, dout)
    lse = tref.attention_lse_ref(q, k, causal=causal)
    emu = fa2_bwd_emulated(q, k, v, out, dout, lse, causal, scale)
    closed = tflash.plain_bwd(q, k, v, out.detach(), dout, lse,
                              causal=causal)
    jgrads = _jax_attention_grads(q, k, v, dout, causal)
    for i in range(3):
        _close(_np(emu[i]), np.asarray(jgrads[i]))
        _close(_np(closed[i]), np.asarray(jgrads[i]))
        _close(_np(auto[i]), np.asarray(jgrads[i]))
    n_t = -(-s // TILE)
    want = {(i, j) for i in range(n_t) for j in range(n_t)
            if j >= i or not causal}
    assert emu[3] == want     # no q tile wholly above the diagonal


@pytest.mark.parametrize("causal", [True, False])
def test_attention_lse_matches_jax_logsumexp(causal, rng):
    q, k, _, _ = _attn_case(rng, 2, 70, 4, 2, 16)
    got = tref.attention_lse_ref(q, k, causal=causal)
    qj = jnp.asarray(_np(q)).reshape(2, 70, 2, 2, 16)
    s = jnp.einsum("bqhgd,bkhd->bhgqk", qj, jnp.asarray(_np(k))) / 4.0
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((70, 70), bool)), s, -1e30)
    want = jax.scipy.special.logsumexp(s, axis=-1).reshape(2, 4, 70)
    _close(_np(got), np.asarray(want))


# ---------------------------------------------------------------------------
# RMSNorm.
# ---------------------------------------------------------------------------
def rmsnorm_bwd_emulated(x, w, dy, eps, blocks, warps=8):
    """``rmsnorm_bwd_kernel`` and ``rmsnorm_dw_kernel`` in fp32: block j
    takes rows j, j + blocks, ... and keeps its own partial dw; the second
    kernel's warp i sums partials i, i + warps, ..., then the warps' sums
    are added in warp order."""
    xf, gf, wf = (t.detach().to(torch.float32) for t in (x, dy, w))
    d = xf.shape[-1]
    xf, gf = xf.reshape(-1, d), gf.reshape(-1, d)
    dx = torch.empty_like(xf)
    part = torch.zeros((blocks, d))
    for j in range(blocks):
        for r in range(j, xf.shape[0], blocks):
            rr = torch.rsqrt((xf[r] * xf[r]).sum() / d + eps)
            k = rr * rr * rr * ((xf[r] * (wf * gf[r])).sum() / d)
            dx[r] = rr * (wf * gf[r]) - xf[r] * k
            part[j] += gf[r] * (xf[r] * rr)
    by_warp = [part[i::warps].sum(0) for i in range(warps)]
    dw = torch.zeros(d)
    for s_ in by_warp:
        dw = dw + s_
    return dx.reshape(x.shape), dw


@pytest.mark.parametrize("rows,d,blocks", [(7, 64, 3), (33, 100, 33),
                                           (64, 2048, 5), (1, 16, 1)])
def test_rmsnorm_backward_emulation_matches_autograd_and_jax(rows, d,
                                                             blocks, rng):
    x = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32))
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(d))
                         .astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32))
    xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    auto = torch.autograd.grad(tref.rmsnorm_ref(xl, wl), (xl, wl), dy)
    emu = rmsnorm_bwd_emulated(x, w, dy, 1e-5, blocks)
    closed = trmsnorm.plain_bwd(x, w, dy)
    _, vjp = jax.vjp(lambda a, b_: jref.rmsnorm_ref(a, b_, 1e-5),
                     jnp.asarray(_np(x)), jnp.asarray(_np(w)))
    jgrads = vjp(jnp.asarray(_np(dy)))
    for got in (emu, closed, auto):
        for g, jg in zip(got, jgrads):
            _close(_np(g), np.asarray(jg))


@pytest.mark.parametrize("element_size", [2, 4])
@pytest.mark.parametrize("d", [8, 100, 768, 2048, 8192, 16384])
def test_rmsnorm_bwd_plan_fits_the_kernel(element_size, d):
    """nv chunks a thread cover the row, are 1, 2, 4 or 8 (the C
    dispatch), and blocks never exceed rows; wider rows raise."""
    for aligned in (True, False):
        chunks = d * element_size // 16 if aligned and \
            (d * element_size) % 16 == 0 else d
        if chunks > trmsnorm.BWD_MAX_NV * trmsnorm.BWD_THREADS:
            with pytest.raises(ValueError):
                trmsnorm.bwd_plan(5, d, element_size, aligned, 132)
            continue
        vec, nv, blocks = trmsnorm.bwd_plan(5, d, element_size, aligned, 132)
        assert nv in (1, 2, 4, 8) and nv * trmsnorm.BWD_THREADS >= chunks
        assert nv == 1 or (nv // 2) * trmsnorm.BWD_THREADS < chunks
        assert blocks == 5
    assert trmsnorm.bwd_plan(2048, 2048, 2, True, 132) == (True, 1, 264)


# ---------------------------------------------------------------------------
# The autograd Functions.
# ---------------------------------------------------------------------------
def test_rmsnorm_function_gradcheck_float64(rng):
    x = torch.from_numpy(rng.standard_normal((3, 5, 8))).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal(8)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b_: trmsnorm.RMSNormFunction.apply(a, b_, 1e-5), (x, w))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_gradcheck_float64(causal, rng):
    q = torch.from_numpy(rng.standard_normal((1, 6, 4, 8)))
    k = torch.from_numpy(rng.standard_normal((1, 6, 2, 8)))
    v = torch.from_numpy(rng.standard_normal((1, 6, 2, 8)))
    args = [t.requires_grad_(True) for t in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda a, b_, c: tflash.FlashAttentionFunction.apply(a, b_, c,
                                                             causal, None),
        args)


def test_cpu_grad_runs_through_the_functions(rng):
    x = torch.randn(4, 16, requires_grad=True)
    assert type(ops.rmsnorm(x, torch.ones(16)).grad_fn).__name__ == \
        "RMSNormFunctionBackward"
    q = torch.randn(1, 5, 2, 16, requires_grad=True)
    kv = torch.randn(1, 5, 1, 16)
    assert type(ops.attention(q, kv, kv).grad_fn).__name__ == \
        "FlashAttentionFunctionBackward"
    with torch.no_grad():       # serving: the plain forward, no Function
        assert ops.rmsnorm(x, torch.ones(16)).grad_fn is None
    # lowp has no backward kernel: on the CPU autograd runs through the
    # plain lowp version.
    assert ops.rmsnorm(x, torch.ones(16), lowp=True).grad_fn is not None


@pytest.fixture
def fake_card(monkeypatch):
    """Every kernel module believes its tensors lie on the card."""
    for mod in (trmsnorm, tflash, tdecode, tssd, tint8):
        monkeypatch.setattr(mod, "on_card", lambda t, name: True)
    return monkeypatch


def test_card_grad_runs_the_backward_kernels(fake_card, rng):
    """On the card, rmsnorm and attention under grad go through their
    Functions: forward kernel (with lse for attention), then the backward
    kernel, never an autograd trace of the plain version."""
    calls = []

    def fwd_rms(x, w, eps, lowp):
        calls.append("rmsnorm")
        return tref.rmsnorm_ref(x, w, eps)

    def bwd_rms(x, w, dy, eps):
        calls.append("rmsnorm_bwd")
        return tref.rmsnorm_bwd_ref(x, w, dy, eps)

    def fwd_flash(q, k, v, causal, scale, with_lse=False):
        calls.append("flash" + ("+lse" if with_lse else ""))
        return (tref.attention_ref(q, k, v, causal=causal, scale=scale),
                tref.attention_lse_ref(q, k, causal=causal, scale=scale)
                if with_lse else None)

    def bwd_flash(q, k, v, out, dout, lse, causal, scale):
        calls.append("flash_bwd")
        return tref.attention_bwd_ref(q, k, v, out, dout, lse,
                                      causal=causal, scale=scale)

    fake_card.setattr(trmsnorm, "_kernel_forward", fwd_rms)
    fake_card.setattr(trmsnorm, "_kernel_backward", bwd_rms)
    fake_card.setattr(tflash, "_kernel_forward", fwd_flash)
    fake_card.setattr(tflash, "_kernel_backward", bwd_flash)
    x = torch.randn(2, 5, 16, requires_grad=True)
    w = torch.ones(16, requires_grad=True)
    h = ops.rmsnorm(x, w)
    q = h.reshape(2, 5, 4, 4)
    out = ops.attention(q, q[:, :, :2], q[:, :, 2:])
    out.sum().backward()
    assert calls == ["rmsnorm", "flash+lse", "flash_bwd", "rmsnorm_bwd"]
    assert x.grad is not None and w.grad is not None
    with torch.no_grad():
        calls.clear()
        ops.attention(q, q[:, :, :2], q[:, :, 2:])
        assert calls == ["flash"]       # serving: no lse written


def test_card_kernels_without_backward_raise_under_grad(fake_card, rng):
    """decode_attention, ssd_scan and int8_matmul have no backward kernel:
    on the card, a call autograd would record raises rather than return a
    result that carries no gradient. So does rmsnorm with lowp."""
    q = torch.randn(2, 4, 16, requires_grad=True)
    kv = torch.randn(2, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.decode_attention(q, kv, kv, torch.tensor([3, 8],
                                                     dtype=torch.int32))
    x = torch.randn(1, 8, 2, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.ssd(x, torch.rand(1, 8, 2), -torch.rand(2), torch.randn(1, 8, 16),
                torch.randn(1, 8, 16), torch.randn(2), chunk=8)
    xq = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.int8_matmul(xq, torch.ones(4, requires_grad=True),
                        torch.zeros((8, 3), dtype=torch.int8), torch.ones(3))
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.rmsnorm(torch.randn(3, 16, requires_grad=True), torch.ones(16),
                    lowp=True)
