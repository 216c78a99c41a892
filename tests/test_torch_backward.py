"""The backward kernels' algorithms on the CPU, against the JAX package.

The JAX package has no backward kernel: its gradient is ``jax.grad`` of
``repro.kernels.ref``. So each backward design of ``csrc/`` is emulated
here tile for tile in fp32 (the same tiles, the log-sum-exp recomputation,
the loop over a kv head's q heads, the causal tile skip; each rmsnorm
backward design's rows a block and a row group, its partials of dw and
their fixed-order sums) and held,
with the closed-form plain backwards of ``kernels/ref.py``, to
``torch.autograd`` of the plain forward and to ``jax.grad`` of the JAX
package's reference at 1e-5 relative to the gradient's max-abs (fp32 sums
in other orders); the flash backward's bf16 tensor-core design, with its
bf16 operands, at the card's bf16 tolerance. The autograd Functions are held in float64 by
``torch.autograd.gradcheck``, and the wiring of the card path (the
Function, the grad guard of the kernels without a backward) is checked
with the device test monkeypatched, as the kernels cannot run here.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import int8_matmul as tint8
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trmsnorm
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.roofline import kernel_cost
from repro_torch.roofline.counter import Recorder

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
    ``flash_bwd_dq_kernel`` (the CUDA-core route: fp32, and bf16 at d 16
    or 32) in fp32: returns (dq, dk, dv, visited), where
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


# The card's bf16 tolerance (chip_smoke.py KERNEL_TOL[bf16], atol = rtol):
# each gradient is rounded to bf16 once (one ulp, 2^-8 relative), and the
# wgmma design also rounds P and dS to bf16 as operands of its products.
BF16_TOL = 2e-2
LOG2E = 1.4426950408889634


def fa2_bwd_wgmma_emulated(q, k, v, out, dout, lse, causal, scale):
    """``flash_bwd_preprocess_kernel``, ``flash_bwd_dkdv_wgmma_kernel`` and
    ``flash_bwd_dq_wgmma_kernel`` (bf16 at d 64 and 128), tile for tile:
    bf16 operands and fp32 products; P = exp2(S scale log2 e - lse log2 e)
    and dS = P (dP - delta) in fp32 (transposed, kv rows x q columns, in
    the dK/dV kernel), each rounded to bf16 before dV += P^T dO,
    dK += dS^T Q and dQ += dS K, whose sums are fp32; each gradient rounded
    to bf16 once. Returns (dq, dk, dv, visited) as ``fa2_bwd_emulated``."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    qf, kf, vf, of, gf = (t.detach().to(torch.float32)
                          for t in (q, k, v, out, dout))
    delta = (gf * of).sum(-1)                       # (b, sq, hq)
    l2 = lse * LOG2E
    c = scale * LOG2E
    bf = lambda t: t.to(torch.bfloat16).to(torch.float32)
    dq, dk, dv = torch.empty_like(qf), torch.empty_like(kf), \
        torch.empty_like(vf)
    visited = set()

    def ok(kv_idx, q_idx):
        return kv_idx <= q_idx if causal else \
            torch.ones((), dtype=torch.bool)

    for bb in range(b):
        for kvh in range(hkv):
            for k0 in range(0, skv, TILE):
                K, V = kf[bb, k0:k0 + TILE, kvh], vf[bb, k0:k0 + TILE, kvh]
                kv_idx = torch.arange(k0, k0 + K.shape[0])[:, None]
                dK, dV = torch.zeros_like(K), torch.zeros_like(V)
                for gi in range(g):
                    h = kvh * g + gi
                    for q0 in range(k0 if causal else 0, sq, TILE):
                        visited.add((k0 // TILE, q0 // TILE))
                        Q = qf[bb, q0:q0 + TILE, h]
                        dO = gf[bb, q0:q0 + TILE, h]
                        q_idx = torch.arange(q0, q0 + Q.shape[0])[None, :]
                        pt = torch.where(ok(kv_idx, q_idx), torch.exp2(
                            K @ Q.T * c - l2[bb, h, q0:q0 + TILE][None]), 0.0)
                        dst = pt * (V @ dO.T - delta[bb, q0:q0 + TILE, h])
                        dV += bf(pt) @ dO
                        dK += bf(dst) @ Q
                dk[bb, k0:k0 + TILE, kvh] = dK * scale
                dv[bb, k0:k0 + TILE, kvh] = dV
    for bb in range(b):
        for h in range(hq):
            for q0 in range(0, sq, TILE):
                Q, dO = qf[bb, q0:q0 + TILE, h], gf[bb, q0:q0 + TILE, h]
                q_idx = torch.arange(q0, q0 + Q.shape[0])[:, None]
                dQ = torch.zeros_like(Q)
                kv_end = min(skv, q0 + TILE) if causal else skv
                for k0 in range(0, kv_end, TILE):
                    K = kf[bb, k0:k0 + TILE, h // g]
                    V = vf[bb, k0:k0 + TILE, h // g]
                    kv_idx = torch.arange(k0, k0 + K.shape[0])[None, :]
                    p = torch.where(ok(kv_idx, q_idx), torch.exp2(
                        Q @ K.T * c - l2[bb, h, q0:q0 + TILE][:, None]), 0.0)
                    ds = p * (dO @ V.T - delta[bb, q0:q0 + TILE, h][:, None])
                    dQ += bf(ds) @ K
                dq[bb, q0:q0 + TILE, h] = dQ * scale
    return (dq.to(torch.bfloat16), dk.to(torch.bfloat16),
            dv.to(torch.bfloat16), visited)


def _bf16_attn_case(rng, b, sq, skv, hq, hkv, d):
    shapes = ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d),
              (b, sq, hq, d))
    return [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
            .to(torch.bfloat16) for sh in shapes]


def _check_wgmma_emulation(rng, b, sq, skv, hq, hkv, d, causal):
    """The emulation and ``plain_bwd`` (on the same bf16 forward output and
    log-sum-exp) against jax.grad of the JAX reference on the same bf16
    values, at BF16_TOL; the dK/dV blocks skip every q tile wholly above
    the diagonal."""
    q, k, v, dout = _bf16_attn_case(rng, b, sq, skv, hq, hkv, d)
    scale = d ** -0.5
    out = tref.attention_ref(q, k, v, causal=causal)           # bf16
    lse = tref.attention_lse_ref(q, k, causal=causal)
    emu = fa2_bwd_wgmma_emulated(q, k, v, out, dout, lse, causal, scale)
    closed = tflash.plain_bwd(q, k, v, out, dout, lse, causal=causal)
    jgrads = _jax_attention_grads(*(t.to(torch.float32)
                                    for t in (q, k, v, dout)), causal)
    for i, t in enumerate((q, k, v)):
        assert emu[i].dtype == torch.bfloat16 and emu[i].shape == t.shape
        for got in (emu[i], closed[i]):
            np.testing.assert_allclose(_np(got.to(torch.float32)),
                                       np.asarray(jgrads[i]),
                                       rtol=BF16_TOL, atol=BF16_TOL)
    n_kt, n_qt = -(-skv // TILE), -(-sq // TILE)
    assert emu[3] == {(i, j) for i in range(n_kt) for j in range(n_qt)
                      if j >= i or not causal}


# (b, sq, skv, hq, hkv, d): groups 8, 2, 4 and 1; lengths 1, 65, 130, 200;
# stablelm-12b's 32/8 heads at d 160 (three boxes, N 192).
WGMMA_CASES = [(2, 130, 130, 8, 1, 64), (1, 65, 65, 4, 2, 128),
               (1, 200, 200, 8, 2, 64), (1, 1, 1, 2, 2, 128),
               (1, 200, 200, 4, 4, 128), (1, 130, 130, 32, 8, 160)]
# Full attention only: skv differs from sq.
WGMMA_FULL_CASES = [(1, 65, 200, 4, 2, 64), (1, 200, 65, 8, 1, 128)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d", WGMMA_CASES)
def test_fa2_wgmma_backward_emulation_matches_jax(causal, b, sq, skv, hq,
                                                  hkv, d, rng):
    _check_wgmma_emulation(rng, b, sq, skv, hq, hkv, d, causal)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d", WGMMA_FULL_CASES)
def test_fa2_wgmma_backward_emulation_full_skv_differs(b, sq, skv, hq, hkv,
                                                       d, rng):
    _check_wgmma_emulation(rng, b, sq, skv, hq, hkv, d, False)


@pytest.mark.parametrize("d", [128, 64], ids=["internlm2", "granite-moe"])
def test_fa2_wgmma_backward_emulation_at_training_shape(d, rng):
    """One layer of the training step at b 1: s 256, 16/8 heads, causal, at
    internlm2-1.8b's head dim and granite-moe-1b-a400m's; the bf16
    rounding of P and dS stays within the card's tolerance."""
    _check_wgmma_emulation(rng, 1, 256, 256, 16, 8, d, True)


def test_flash_bwd_design_routes():
    """bf16 at d 64, 128, 160 and 256 (every instantiated d above 32)
    takes the wgmma kernels, bf16 at a d from 33 to 256 that is not a
    multiple of 8 the same kernels through staged rows ("wgmma_staged"),
    the forward alike; fp32 above 32 the CUDA-core tiles of route "wide"
    (one tile up to 256), both dtypes at 32 and below the CUDA-core
    kernels ("simt"); above 256 bf16 up to 768 takes the tensor-core
    column tiles, on the caller's rows at a multiple of 8 and through
    staged rows at any other d (forward and backward alike), fp32 and bf16
    above 768 the CUDA-core ones; the backward takes every head dim the
    forward does, on the forward's route; what no kernel takes raises."""
    assert tflash.bwd_design(torch.bfloat16, 160) == "wgmma"
    assert tflash.bwd_design(torch.float32, 160) == "wide"
    for dtype in (torch.float32, torch.bfloat16):
        for d in tflash.HEAD_DIMS:
            want = "simt" if d <= 32 else \
                "wgmma" if dtype == torch.bfloat16 else "wide"
            assert tflash.bwd_design(dtype, d) == want
    for d in (36, 76, 99, 100, 130, 250):
        assert tflash.bwd_design(torch.bfloat16, d) == "wgmma_staged"
        assert tflash.fwd_design(torch.bfloat16, d) == "wgmma_staged"
        assert tflash.bwd_design(torch.float32, d) == "wide"
        assert tflash.staged_ld(d) % 8 == 0
        assert 0 < tflash.staged_ld(d) - d < 8
    for d in (1, 7, 17, 31, 32):
        assert tflash.bwd_design(torch.bfloat16, d) == "simt"
        assert tflash.bwd_design(torch.float32, d) == "simt"
    for d in (40, 80, 96, 104, 136, 248):
        assert tflash.bwd_design(torch.bfloat16, d) == "wgmma"
        assert tflash.staged_ld(d) == d
    assert tflash.bwd_design(torch.bfloat16, 257) == "wgmma_wide_staged"
    for d in (264, 288, 512, 576, 768):
        assert tflash.bwd_design(torch.bfloat16, d) == "wgmma_wide"
        assert tflash.bwd_design(torch.float32, d) == "wide"
    for d in (257, 300, 767):
        assert tflash.bwd_design(torch.float32, d) == "wide"
        assert tflash.bwd_design(torch.bfloat16, d) == \
            tflash.fwd_design(torch.bfloat16, d) == "wgmma_wide_staged"
        assert tflash.staged_ld(d) % 8 == 0
        assert 0 < tflash.staged_ld(d) - d < 8
    for d in (769, 800, 1024):
        for dtype in (torch.float32, torch.bfloat16):
            assert tflash.bwd_design(dtype, d) == "wide"
    with pytest.raises(ValueError):
        tflash.bwd_design(torch.bfloat16, 0)
    with pytest.raises(TypeError):
        tflash.bwd_design(torch.float16, 64)


def test_flash_bwd_design_matches_the_kernel_dispatch():
    """``bwd_design`` (and ``fwd_design``, the same function) is
    ``repro_flash_attention_bwd``'s and ``repro_flash_attention``'s
    dispatch: bf16 where ``tc_route`` holds (evaluated from the source)
    launches ``bwd_tc::launch`` (``tc::launch``) at the padded head dims
    its cases list, bf16 where ``common.cuh``'s ``staged_route`` holds the
    staged instantiations at the same padded head dims, where
    ``simt_wide_route`` holds (fp32 above 32) route "wide"; the rest (d 32
    and below, both dtypes) ``bwd::dispatch`` (``dispatch_simt``), whose
    cases are 16 and 32 in both dtypes: no CUDA-core instantiation above
    32 is left."""
    csrc = Path(tflash.__file__).parents[1] / "csrc"
    src = (csrc / "flash_attention.cu").read_text()
    common = (csrc / "common.cuh").read_text()
    entry = src[src.index('extern "C" int repro_flash_attention_bwd'):]
    fwd_entry = src[src.index('extern "C" int repro_flash_attention('):
                    src.index('extern "C" int repro_flash_attention_bwd')]
    tc_dims = {int(x) for x in
               re.findall(r"case (\d+): return bwd_tc::launch<\1>", entry)}
    staged_dims = {int(x) for x in re.findall(
        r"case (\d+): return bwd_tc::launch<\1, true>", entry)}
    assert staged_dims == tc_dims
    assert {int(x) for x in re.findall(
        r"case (\d+): return tc::launch<\1>", fwd_entry)} == tc_dims
    assert {int(x) for x in re.findall(
        r"case (\d+): return tc::launch_as<\1, tc::kStaged>",
        fwd_entry)} == tc_dims
    for fn in ("int dispatch(int d, const void* q",
               "int dispatch_simt(int d, const void* q"):
        simt = src[src.index(fn):]
        simt = simt[:simt.index("default:")]
        assert {int(x) for x in re.findall(
            r"case (\d+): return launch(?:_simt)?<T, \1>", simt)} == \
            {16, 32}
    assert "flash_fwd_simt_kernel<T, D, kPad>" in src
    assert tc_dims == {d for d in tflash.HEAD_DIMS if d > 32}
    route = re.search(r"bool tc_route\(int d\) \{ return ([^;]+); \}",
                      src).group(1).replace("&&", "and")
    staged = re.search(r"bool staged_route\(int d\) \{\s*return ([^;]+);",
                       common).group(1)
    staged = staged.replace("&&", "and")
    wide = re.search(r"bool simt_wide_route\(int f32, int d\) \{\s*"
                     r"return f32 \? ([^:]+) : ([^;]+);", common)
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (\w+) = (\d+);", common)}
    for d in range(1, tflash.MAX_HEAD_DIM + 1):
        want = "wgmma" if eval(route, {"d": d}) else "simt"
        assert not (eval(route, {"d": d}) and eval(staged, {"d": d}))
        for design in (tflash.bwd_design, tflash.fwd_design):
            assert design(torch.bfloat16, d) == (
                "wgmma_staged" if eval(staged, {"d": d}) else want), d
            assert design(torch.float32, d) == (
                "wide" if eval(wide.group(1), {**consts, "d": d})
                else "simt"), d
        assert not eval(wide.group(2), {**consts, "d": d})
    for body in (entry, fwd_entry):
        assert body.index("simt_wide_route(dtype == kF32, d)") < \
            body.index("if (tc_route(d))") < \
            body.index("if (staged_route(d))")
    assert "if (dtype == kF32)\n    return bwd::dispatch<float>(" in entry
    assert entry.index("simt_wide_route(dtype == kF32, d)") < \
        entry.index("return bwd::dispatch<float>(")


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
# The ring design's launch layout, as ``csrc/rmsnorm.cu`` computes it (the
# C side owns it; test_rmsnorm_bwd_plan_matches_the_kernel_source holds
# these constants to its source).
RING_THREADS = trmsnorm.RING_WARPS * 32
MAX_SMEM = 232448               # dynamic shared memory a block (sm_90)


def ring_rows(rows, blocks, b):
    """The rows block ``b`` of a ring launch takes (``ring_row``)."""
    return range(b * rows // blocks, (b + 1) * rows // blocks)


def ring_smem(d, element_size, wpr, spg):
    """Dynamic shared memory of a ring launch (``ring_smem_bytes``): the
    slots' mbarriers padded to 128 bytes, then the larger of the slots (an
    x and a dy row each), the groups' dw sums and the column sums."""
    groups = trmsnorm.RING_WARPS // wpr
    slots = groups * spg
    ring = max(slots * 2 * d * element_size, groups * d * 4, RING_THREADS * 4)
    return -(-slots * 8 // 128) * 128 + ring


def dw_slice_width(d, nparts):
    """Columns of dw one block sums (``dw_slice_width``): the least power
    of two from 32 to ``RING_THREADS`` at or above d / nparts."""
    sw = 32
    while sw < -(-d // nparts) and sw < RING_THREADS:
        sw *= 2
    return sw


def _rb(t):
    """t rounded to bf16, back in fp32."""
    return t.to(torch.bfloat16).to(torch.float32)


def rmsnorm_bwd_row(xr, wf, gr, eps, lowp):
    """One row of every backward design (``bwd_row``, ``sd_add``, ``dx_of``
    and ``dw_add`` of ``csrc/rmsnorm.cu``), in fp32 on the row's values:
    (dx before the store rounds it, the row's dw term). ``lowp`` rounds as
    the bf16 kernels do; the plain arithmetic otherwise."""
    d = xr.shape[-1]
    j = (xr * xr).sum() / d + eps
    r = torch.rsqrt(j)
    if not lowp:
        k = r * r * r * ((xr * (wf * gr)).sum() / d)
        return r * (wf * gr) - xr * k, gr * (xr * r)
    g = _rb(gr * _rb(wf))
    inv = _rb(r)
    c = _rb(_rb(xr * g).sum()) * (-0.5 * (r / j)) / d
    return _rb(g * inv) + _rb(c * (2 * xr)), _rb(_rb(xr * inv) * gr)


def rmsnorm_bwd_emulated(x, w, dy, eps, plan, lowp=False):
    """The ring design of ``csrc/rmsnorm.cu`` in fp32, launch for launch:
    block b of ``plan.blocks`` takes the contiguous rows
    ``ring_rows(rows, blocks, b)``; its row group g of ``RING_WARPS //
    plan.wpr`` takes rows g, g + groups, ... of that range, summing dw over
    them in row order; the block adds its groups' sums in group order into
    its partial row. Then, after the grid sync, column slice j of
    ``dw_slice_width(d, blocks)`` columns: for each column, thread q of
    tpc = ``RING_THREADS // sw`` sums partials q, q + tpc, ... in order,
    and the tpc sums are added in q order (rounded to bf16 once under
    ``lowp``)."""
    xf, gf, wf = (t.detach().to(torch.float32) for t in (x, dy, w))
    d = xf.shape[-1]
    xf, gf = xf.reshape(-1, d), gf.reshape(-1, d)
    n, blocks = xf.shape[0], plan.blocks
    groups = trmsnorm.RING_WARPS // plan.wpr
    dx = torch.empty_like(xf)
    part = torch.zeros((blocks, d))
    for b in range(blocks):
        rows = ring_rows(n, blocks, b)
        sums = torch.zeros((groups, d))
        for g in range(groups):
            for r in rows[g::groups]:
                dx[r], dw_r = rmsnorm_bwd_row(xf[r], wf, gf[r], eps, lowp)
                sums[g] = sums[g] + dw_r
        for g in range(groups):
            part[b] = part[b] + sums[g]
    sw = dw_slice_width(d, blocks)
    tpc = RING_THREADS // sw
    dw = torch.zeros(d)
    for c0 in range(0, d, sw):
        cols = slice(c0, min(c0 + sw, d))
        for q in range(tpc):
            s_ = torch.zeros(cols.stop - c0)
            for p_ in range(q, blocks, tpc):
                s_ = s_ + part[p_, cols]
            dw[cols] = dw[cols] + s_
    return _stored(dx, x, lowp), _rb(dw) if lowp else dw


def _stored(dx, x, lowp):
    """dx as the kernel stores it: in x's dtype (bf16 under lowp)."""
    dx = dx.reshape(x.shape)
    return _rb(dx) if lowp else dx


def rmsnorm_bwd_block_rows_emulated(x, w, dy, eps, blocks, warps=8,
                                    lowp=False):
    """The block_rows design (``rmsnorm_bwd_kernel`` and
    ``rmsnorm_dw_kernel``) in fp32: block j takes rows j, j + blocks, ...
    and keeps its own partial dw; the second kernel's warp i sums partials
    i, i + warps, ..., then the warps' sums are added in warp order
    (rounded to bf16 once under ``lowp``). The stream design
    (``rmsnorm_bwd_stream_kernel``) takes the rows and sums the partials
    the same way: it differs in what it holds, not in its order."""
    xf, gf, wf = (t.detach().to(torch.float32) for t in (x, dy, w))
    d = xf.shape[-1]
    xf, gf = xf.reshape(-1, d), gf.reshape(-1, d)
    dx = torch.empty_like(xf)
    part = torch.zeros((blocks, d))
    for j in range(blocks):
        for r in range(j, xf.shape[0], blocks):
            dx[r], dw_r = rmsnorm_bwd_row(xf[r], wf, gf[r], eps, lowp)
            part[j] += dw_r
    by_warp = [part[i::warps].sum(0) for i in range(warps)]
    dw = torch.zeros(d)
    for s_ in by_warp:
        dw = dw + s_
    return _stored(dx, x, lowp), _rb(dw) if lowp else dw


def _rmsnorm_bwd_inputs(rng, rows, d):
    x = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32))
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(d))
                         .astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32))
    return x, w, dy


def _check_rmsnorm_grads(x, w, dy, emu):
    """``emu`` (dx, dw), the closed form and autograd against ``jax.vjp``
    of the JAX package's reference."""
    xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    auto = torch.autograd.grad(tref.rmsnorm_ref(xl, wl), (xl, wl), dy)
    closed = trmsnorm.plain_bwd(x, w, dy)
    _, vjp = jax.vjp(lambda a, b_: jref.rmsnorm_ref(a, b_, 1e-5),
                     jnp.asarray(_np(x)), jnp.asarray(_np(w)))
    jgrads = vjp(jnp.asarray(_np(dy)))
    for got in (emu, closed, auto):
        for g, jg in zip(got, jgrads):
            _close(_np(g), np.asarray(jg))


# (rows, d, SMs): one or several rows a block, rows not a multiple of the
# blocks, one warp a row (d 16 to 100), two (fp32 d 768: 192 chunks) and
# four (fp32 d 2048: 512 chunks).
RMS_BWD_CASES = [(7, 64, 3), (33, 100, 33), (64, 2048, 5), (1, 16, 1),
                 (50, 768, 7), (300, 768, 132)]


@pytest.mark.parametrize("rows,d,blocks", RMS_BWD_CASES)
def test_rmsnorm_backward_emulation_matches_autograd_and_jax(rows, d,
                                                             blocks, rng):
    x, w, dy = _rmsnorm_bwd_inputs(rng, rows, d)
    plan = trmsnorm.bwd_plan(rows, d, 4, True, blocks)
    assert plan.design == trmsnorm.RING
    _check_rmsnorm_grads(x, w, dy,
                         rmsnorm_bwd_emulated(x, w, dy, 1e-5, plan))


@pytest.mark.parametrize("rows,d,blocks", RMS_BWD_CASES)
def test_rmsnorm_block_rows_emulation_matches_autograd_and_jax(rows, d,
                                                               blocks, rng):
    x, w, dy = _rmsnorm_bwd_inputs(rng, rows, d)
    _check_rmsnorm_grads(x, w, dy, rmsnorm_bwd_block_rows_emulated(
        x, w, dy, 1e-5, min(rows, blocks)))


def _bf16_rms_inputs(rng, rows, d):
    x, w, dy = _rmsnorm_bwd_inputs(rng, rows, d)
    return x.to(torch.bfloat16), w, dy.to(torch.bfloat16)


def _jax_lowp_grads(x, w, dy):
    """``jax.vjp`` of the JAX package's ``rmsnorm_lowp`` in bf16."""
    _, vjp = jax.vjp(lambda a, b_: jref.rmsnorm_lowp(a, b_, 1e-5),
                     jnp.asarray(_np(x.float()), jnp.bfloat16),
                     jnp.asarray(_np(w)))
    gx, gw = vjp(jnp.asarray(_np(dy.float()), jnp.bfloat16))
    return np.asarray(gx.astype(jnp.float32)), np.asarray(gw)


@pytest.mark.parametrize("rows,d", [(7, 64), (33, 100), (2, 2050),
                                    (4, 4096), (64, 32)])
def test_rmsnorm_lowp_bwd_ref_matches_jax_grad(rows, d, rng):
    """``ref.rmsnorm_lowp_bwd_ref`` against ``jax.grad`` of
    ``repro.kernels.ref.rmsnorm_lowp`` in bf16, at BF16_TOL of max(1,
    max-abs): the same rounding points, but the sums in fp32 rounded once,
    where XLA on the CPU rounds a bf16 sum after every add. In fp32 it is
    the plain backward."""
    x, w, dy = _bf16_rms_inputs(rng, rows, d)
    dx, dw = tref.rmsnorm_lowp_bwd_ref(x, w, dy)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    for got, want in zip((dx, dw), _jax_lowp_grads(x, w, dy)):
        _close(_np(got.float()), want, BF16_TOL)
    xf, wf, gf = x.float(), w, dy.float()
    for a, b_ in zip(tref.rmsnorm_lowp_bwd_ref(xf, wf, gf),
                     tref.rmsnorm_bwd_ref(xf, wf, gf)):
        assert torch.equal(a, b_)


def test_rmsnorm_lowp_bwd_ref_rounds_where_jax_grad_rounds(rng):
    """One row of 32 (one window of XLA's bf16 sum, which then rounds after
    each add in order): the closed form with its sums so rounded gives
    ``jax.grad``'s dx and dw bit for bit, so every other rounding point is
    the JAX package's."""
    x, w, dy = _bf16_rms_inputs(rng, 32, 32)
    xf = x.float()
    j = (xf * xf).sum(-1, keepdim=True) / 32 + 1e-5
    r = torch.rsqrt(j)
    inv = r.to(torch.bfloat16)
    g = dy * w.to(torch.bfloat16)

    def seq(t, dim):        # a bf16 sum rounded after every add
        t = t.movedim(dim, 0)
        acc = torch.zeros_like(t[0])
        for i in range(t.shape[0]):
            acc = acc + t[i]
        return acc
    sd = seq(x * g, -1).unsqueeze(-1).float()
    c = sd * (-0.5 * (r / j)) / 32
    dx = ((g * inv).float() + (c * (2 * xf)).to(torch.bfloat16).float()
          ).to(torch.bfloat16)
    dw = seq((x * inv) * dy, 0).float()
    jdx, jdw = _jax_lowp_grads(x, w, dy)
    assert np.array_equal(_np(dx.float()), jdx)
    assert np.array_equal(_np(dw), jdw)


# (rows, d, design) of the emulations under lowp and of the stream design:
# training's 2048 x 2048 on the ring, block_rows at single elements, and
# the rows only the stream design takes (20000 16-byte-chunked elements,
# 2050 single ones).
RMS_LOWP_CASES = [(2048, 2048, "ring"), (64, 100, "block_rows"),
                  (2, 20000, "stream"), (2, 2050, "stream")]


@pytest.mark.parametrize("lowp", [False, True])
@pytest.mark.parametrize("rows,d,design", RMS_LOWP_CASES)
def test_rmsnorm_bwd_designs_under_lowp_and_wide_rows(rows, d, design, lowp,
                                                      rng):
    """Each design's emulation in bf16, the plan ``bwd_plan`` gives the
    shape, against the closed form (``rmsnorm_lowp_bwd_ref`` or
    ``rmsnorm_bwd_ref``) and ``jax.grad`` of the JAX reference, at
    BF16_TOL of max(1, max-abs)."""
    x, w, dy = _bf16_rms_inputs(rng, rows, d)
    plan = trmsnorm.bwd_plan(rows, d, 2, True, 132)
    assert trmsnorm.BWD_DESIGNS[plan.design] == design
    if plan.design == trmsnorm.RING:
        emu = rmsnorm_bwd_emulated(x, w, dy, 1e-5, plan, lowp)
    else:
        emu = rmsnorm_bwd_block_rows_emulated(x, w, dy, 1e-5, plan.blocks,
                                              lowp=lowp)
    closed = trmsnorm.plain_bwd(x, w, dy, 1e-5, lowp)
    if lowp:
        jgrads = _jax_lowp_grads(x, w, dy)
    else:
        _, vjp = jax.vjp(lambda a, b_: jref.rmsnorm_ref(a, b_, 1e-5),
                         jnp.asarray(_np(x.float()), jnp.bfloat16),
                         jnp.asarray(_np(w)))
        jgrads = [np.asarray(jnp.asarray(g_, jnp.float32)) for g_ in
                  vjp(jnp.asarray(_np(dy.float()), jnp.bfloat16))]
    for got, want, jw in zip(emu, closed, jgrads):
        _close(_np(got.float()), _np(want.float()), BF16_TOL)
        _close(_np(got.float()), jw, BF16_TOL)


@pytest.mark.parametrize("element_size", [2, 4])
@pytest.mark.parametrize("d", [8, 100, 768, 2048, 8192, 16384])
def test_rmsnorm_bwd_plan_fits_the_kernel(element_size, d):
    """16-byte chunks take the ring design, single elements block_rows;
    each plan's chunks cover the row with the fewest lanes and warps of the
    C dispatch, and rows wider than BWD_MAX_CHUNKS take the stream design
    (ring and block_rows, asked for there, raise). At 2048 rows on 132 SMs
    the ring's grid fits the grid barrier (a block an SM at most), its
    shared memory fits a block, and its blocks and row groups take every
    row once, in slots that fit RING_BYTES."""
    for aligned in (True, False):
        vec = aligned and (d * element_size) % 16 == 0
        chunks = d * element_size // 16 if vec else d
        if chunks > trmsnorm.BWD_MAX_CHUNKS:
            assert trmsnorm.bwd_plan(5, d, element_size, aligned, 132) == \
                trmsnorm.BwdPlan(trmsnorm.STREAM, vec, 1, 1, 0, 5)
            for design in (trmsnorm.RING, trmsnorm.BLOCK_ROWS):
                with pytest.raises(ValueError):
                    trmsnorm.bwd_plan(5, d, element_size, aligned, 132,
                                      design)
            continue
        p = trmsnorm.bwd_plan(5, d, element_size, aligned, 132)
        assert p.vec == vec and p.blocks == 5
        if not vec:
            assert p.design == trmsnorm.BLOCK_ROWS
            assert p.nv in (1, 2, 4, 8) and p.nv * trmsnorm.BWD_THREADS >= \
                chunks
            assert p.nv == 1 or (p.nv // 2) * trmsnorm.BWD_THREADS < chunks
            with pytest.raises(ValueError):
                trmsnorm.bwd_plan(5, d, element_size, aligned, 132,
                                  trmsnorm.RING)
            continue
        assert p.design == trmsnorm.RING
        assert p.wpr in (1, 2, 4, 8, 16) and 1 <= p.nv <= trmsnorm.RING_MAX_NV
        assert p.wpr == 1 or p.nv == trmsnorm.RING_MAX_NV
        assert p.nv * p.wpr * 32 >= chunks
        assert (p.nv - 1) * 32 < chunks if p.wpr == 1 \
            else (p.wpr // 2) * 32 * p.nv < chunks
        q = trmsnorm.bwd_plan(2048, d, element_size, True, 132,
                              trmsnorm.RING)
        assert q.design == trmsnorm.RING and q.blocks <= 132
        groups = trmsnorm.RING_WARPS // q.wpr
        assert ring_smem(d, element_size, q.wpr, q.spg) <= MAX_SMEM
        assert 1 <= q.spg and groups * q.spg <= trmsnorm.RING_MAX_SLOTS
        assert groups * q.spg * 2 * d * element_size <= trmsnorm.RING_BYTES
        taken = [r for b in range(q.blocks)
                 for g in range(groups)
                 for r in ring_rows(2048, q.blocks, b)[g::groups]]
        assert sorted(taken) == list(range(2048))
    assert trmsnorm.bwd_plan(2048, 2048, 2, True, 132) == \
        trmsnorm.BwdPlan(trmsnorm.RING, True, 4, 2, 2, 132)
    assert trmsnorm.bwd_plan(2048, 768, 2, True, 132) == \
        trmsnorm.BwdPlan(trmsnorm.RING, True, 3, 1, 1, 132)


def test_rmsnorm_bwd_block_rows_takes_what_it_did():
    """block_rows, asked for at a 16-byte shape (to be timed against the
    ring), takes rows of up to 1024 chunks of 16 bytes; single elements up
    to 2048, 264 blocks at 2048 rows as before."""
    br = trmsnorm.BLOCK_ROWS
    assert trmsnorm.bwd_plan(2048, 2048, 2, True, 132, br) == \
        trmsnorm.BwdPlan(br, True, 1, 1, 0, 264)
    assert trmsnorm.bwd_plan(9, 8192, 2, True, 132, br).nv == 4
    with pytest.raises(ValueError):
        trmsnorm.bwd_plan(9, 16384, 2, True, 132, br)
    assert trmsnorm.bwd_plan(9, 2048, 2, False, 132).nv == 8
    with pytest.raises(ValueError):
        trmsnorm.bwd_plan(9, 2048, 2, True, 132, 3)


def test_rmsnorm_bwd_plan_matches_the_kernel_source():
    """The plan's constants and design codes are ``csrc/rmsnorm.cu``'s, and
    its nv/wpr pairs are the ones the C dispatch instantiates."""
    src = (Path(trmsnorm.__file__).parents[1] / "csrc" /
           "rmsnorm.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kBwdThreads"]) == trmsnorm.BWD_THREADS
    assert int(consts["kRingWarps"]) == trmsnorm.RING_WARPS
    assert int(consts["kMaxSmem"]) == MAX_SMEM
    assert "kBlockRows = 0, kRing = 1, kStream = 2;" in src
    assert (trmsnorm.BLOCK_ROWS, trmsnorm.RING, trmsnorm.STREAM) == (0, 1, 2)
    assert set(trmsnorm.BWD_DESIGNS) == {0, 1, 2}
    assert "rmsnorm_bwd_stream_kernel<T, V, L>" in src and \
        "rmsnorm_bwd_stream_kernel<T, 1, L>" in src
    ring = {(int(a), int(b)) for a, b in
            re.findall(r"return REPRO_RING\((\d+), (\d+)\)", src)}
    assert ring == {(nv, 1) for nv in range(1, 5)} | {(4, 2), (4, 4), (4, 8),
                                                       (4, 16)}
    entry = src[src.index("cudaError_t dispatch_bwd("):]
    vec_nv = {int(n) for n in re.findall(r"launch_bwd<T, V, (\d+)>", entry)}
    one_nv = {int(n) for n in re.findall(r"launch_bwd<T, 1, (\d+)>", entry)}
    assert max(vec_nv) == trmsnorm.BLOCK_ROWS_MAX_NV[True]
    assert max(one_nv) == trmsnorm.BLOCK_ROWS_MAX_NV[False]
    for d, es in ((768, 2), (2048, 2), (768, 4), (2048, 4), (16384, 2)):
        p = trmsnorm.bwd_plan(2048, d, es, True, 132)
        assert (p.nv, p.wpr) in ring


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
    # lowp too: its closed-form backward on the CPU, its kernel on the card
    assert type(ops.rmsnorm(x, torch.ones(16), lowp=True).grad_fn
                ).__name__ == "RMSNormFunctionBackward"


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

    def bwd_rms(x, w, dy, eps, design=None, lowp=False):
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


def test_card_flash_at_head_dim_160_runs_its_backward_kernel(fake_card,
                                                             rng):
    """stablelm-12b's d 160 under grad on the card: the forward kernel
    with the log-sum-exp, then the backward kernel, whose gradients
    autograd hands back; under no_grad the forward kernel alone."""
    calls = []

    def fwd(q, k, v, causal, scale, with_lse=False):
        calls.append("flash" + ("+lse" if with_lse else ""))
        return (tref.attention_ref(q, k, v, causal=causal, scale=scale),
                tref.attention_lse_ref(q, k, causal=causal, scale=scale)
                if with_lse else None)

    def bwd(q, k, v, out, dout, lse, causal, scale):
        calls.append("flash_bwd")
        return tref.attention_bwd_ref(q, k, v, out, dout, lse,
                                      causal=causal, scale=scale)

    fake_card.setattr(tflash, "_kernel_forward", fwd)
    fake_card.setattr(tflash, "_kernel_backward", bwd)
    q = torch.randn(1, 8, 4, 160, requires_grad=True)
    kv = torch.randn(1, 8, 2, 160, requires_grad=True)
    ops.attention(q, kv, kv).sum().backward()
    assert calls == ["flash+lse", "flash_bwd"]
    want = torch.autograd.grad(tref.attention_ref(q, kv, kv).sum(),
                               (q, kv))
    torch.testing.assert_close(q.grad, want[0])
    torch.testing.assert_close(kv.grad, want[1])
    calls.clear()
    with torch.no_grad():
        ops.attention(q, kv, kv)
    assert calls == ["flash"]


def test_fake_flash_backward_at_head_dim_160_counts_one_call():
    """On fake CUDA tensors (the dry run's stablelm-12b train cells) the
    backward at d 160 takes its fake path: one ``flash_attention_bwd``
    call with its ``kernel_cost``, gradients of the inputs' shapes, no
    launch and no refusal."""
    before = ops.launch_counts()
    with FakeTensorMode():
        q = torch.empty(2, 64, 32, 160, dtype=torch.bfloat16, device="cuda")
        kv = torch.empty(2, 64, 8, 160, dtype=torch.bfloat16, device="cuda")
        lse = torch.empty(2, 32, 64, device="cuda")
        with Recorder() as rec:
            grads = tflash._kernel_backward(q, kv, kv, q, q, lse, True,
                                            160 ** -0.5)
    assert [tuple(g.shape) for g in grads] == [tuple(q.shape),
                                               tuple(kv.shape),
                                               tuple(kv.shape)]
    assert rec.kernel_calls() == {"flash_attention_bwd": 1}
    assert rec.kernel_flops == kernel_cost.flash_bwd(
        2, 64, 64, 32, 8, 160, torch.bfloat16, True).ops
    assert ops.launch_counts() == before


def test_card_kernels_without_backward_raise_under_grad(fake_card, rng):
    """decode_attention and int8_matmul have no backward kernel: on the
    card, a call autograd would record raises rather than return a result
    that carries no gradient. (rmsnorm with lowp has its kernel:
    test_card_rmsnorm_lowp_runs_its_backward_kernel.)"""
    q = torch.randn(2, 4, 16, requires_grad=True)
    kv = torch.randn(2, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.decode_attention(q, kv, kv, torch.tensor([3, 8],
                                                     dtype=torch.int32))
    xq = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.int8_matmul(xq, torch.ones(4, requires_grad=True),
                        torch.zeros((8, 3), dtype=torch.int8), torch.ones(3))



def test_card_rmsnorm_lowp_runs_its_backward_kernel(fake_card, rng):
    """rmsnorm with lowp under grad on the card: the forward kernel with
    lowp, then the backward kernel with lowp, whose gradients autograd
    hands back (the model's ``mlp_lowp`` training path)."""
    calls = []

    def fwd(x, w, eps, lowp):
        calls.append(("rmsnorm", lowp))
        return tref.rmsnorm_lowp(x, w, eps)

    def bwd(x, w, dy, eps, design=None, lowp=False):
        calls.append(("rmsnorm_bwd", lowp))
        return tref.rmsnorm_lowp_bwd_ref(x, w, dy, eps)

    fake_card.setattr(trmsnorm, "_kernel_forward", fwd)
    fake_card.setattr(trmsnorm, "_kernel_backward", bwd)
    x = torch.from_numpy(rng.standard_normal((3, 5, 32)).astype(np.float32)
                         ).to(torch.bfloat16).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal(32).astype(np.float32)
                         ).requires_grad_(True)
    dy = torch.from_numpy(rng.standard_normal((3, 5, 32)).astype(np.float32)
                          ).to(torch.bfloat16)
    ops.rmsnorm(x, w, lowp=True).backward(dy)
    assert calls == [("rmsnorm", True), ("rmsnorm_bwd", True)]
    want = tref.rmsnorm_lowp_bwd_ref(x.detach(), w.detach(), dy)
    assert torch.equal(x.grad, want[0]) and torch.equal(w.grad, want[1])
