"""The port's kernels at every shape the Pallas kernels compute, on the
CPU: head dims off the instantiated set (80, 96, 100 and gemma-2b's 256)
and above 256 (257, 288 and 512 in flash; 512 and the 576 of an absorbed
MLA decode, a group of 128 on one latent head, in decode), groups above
16 (falcon-7b's 71 q heads on one kv head) and d_state 512.

Each wrapper's plain version (what a CPU tensor runs) is held against the
JAX package's Pallas kernel in interpret mode and its ``repro.kernels.ref``
oracle on the same seeded numpy inputs, each backward against ``jax.grad``
of the oracle, at the tolerances of the ``tests/test_kernels_*.py`` case
nearest each shape. The design functions name the route the card takes at
each new shape and still refuse what no kernel takes (head dim 0 or -1);
``kernel_cost`` counts the work at the real d, group and d_state, never at
the padded size. Three smoke-size models with the overridden attention of
``chip_smoke.py``'s ``contract`` phase are held to ``repro``: logits,
loss and every gradient leaf. The CUDA kernels themselves are held to
their plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda_kernels.py``.
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jget_config
from repro.config import smoke_config as jsmoke_config
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jdecode
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.ssd_scan import ssd_scan as jssd
from repro.models import model as jlm
from repro_torch.config import get_config, smoke_config
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import model as lm
from repro_torch.roofline import kernel_cost
from repro_torch.tree import tree_leaves, tree_unflatten

F32_ATTN_TOL = 2e-6     # tests/test_kernels_attention.py, fp32
BF16_TOL = 2e-2         # tests/test_kernels_attention.py, bf16
SSD_TOL = 2e-4          # tests/test_kernels_ssd.py
GRAD_TOL = 1e-5         # tests/test_torch_backward.py, of max(1, max-abs)
MODEL_TOL = 1e-4        # tests/test_models_smoke.py, fp32 logits
LOSS_TOL = 1e-5         # tests/test_torch_training.py
MODEL_GRAD_TOL = 1e-4   # tests/test_torch_training.py, of each leaf's max-abs

# (hq, hkv, d): phi-3-mini's 32/32 at d 96, phi-2's at d 80, gemma-2b's 8/1
# at d 256, and d 100 (no 16-byte chunks in bf16): the flash shapes of the
# smoke's contract phase, with the heads cut to keep the CPU quick.
# Above 256, the column-tile kernels: d 257 (no 16-byte rows, two tiles),
# 288 with a group of 4, and 512 (two whole tiles).
FLASH_HEADS = [(4, 4, 96), (4, 4, 80), (8, 1, 256), (4, 4, 100),
               (4, 4, 257), (4, 1, 288), (2, 2, 512)]
FLASH_IDS = ["phi3-d96", "phi2-d80", "gemma-d256", "d100", "d257",
             "g4-d288", "d512"]
# decode: falcon-7b's group of 71 on one kv head at d 64, gemma-2b's 8/1
# at d 256.
DECODE_HEADS = [(71, 1, 64), (8, 1, 256)]
DECODE_IDS = ["falcon-g71", "gemma-d256"]
# decode above 256: a group of 16 at d 512, and DeepSeek-V2/V3's absorbed
# MLA decode, 128 q heads on one latent head of 512 + 64 (eight slices of
# 16 q heads, three column tiles).
DECODE_WIDE = [(16, 1, 512), (128, 1, 576)]
DECODE_WIDE_IDS = ["g16-d512", "mla-g128-d576"]
WIDE_DIMS = [257, 264, 288, 300, 512, 576]
# bf16 head dims above 256 on the tensor-core column tiles over the
# caller's rows (multiples of 8 up to tflash.TC_WIDE_MAX_HEAD_DIM); the rest
# of WIDE_DIMS (257, 300) takes the same tiles over staged rows.
WGMMA_WIDE_DIMS = {264, 288, 512, 576}
# The models of the contract phase: internlm2-1.8b's smoke config with
# gemma-2b's attention, a group of 32, and phi-3-mini's heads, each cut
# (heads and d_model) to smoke width.
MODEL_OVERRIDES = {
    "gemma-d256": dict(num_heads=8, num_kv_heads=1, head_dim=256),
    "group32-d64": dict(num_heads=32, num_kv_heads=1, head_dim=64),
    "phi3-d96": dict(num_heads=32, num_kv_heads=32, head_dim=96),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# Flash attention, forward and backward.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv,d", FLASH_HEADS, ids=FLASH_IDS)
def test_flash_plain_matches_pallas_at_new_head_dims(causal, hq, hkv, d,
                                                     rng):
    b, s = 1, 128
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    out = tflash.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    pallas = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, block_q=64, block_k=64, interpret=True)
    oracle = jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal)
    for want in (pallas, oracle):
        _close(out, want, F32_ATTN_TOL)


@pytest.mark.parametrize("hq,hkv,d", FLASH_HEADS, ids=FLASH_IDS)
def test_flash_plain_matches_pallas_at_new_head_dims_bf16(hq, hkv, d, rng):
    b, s = 1, 128
    q, k, v = (jnp.asarray(rng.standard_normal(sh), jnp.bfloat16) for sh in
               ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    tq, tk, tv = (_t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
                  for a in (q, k, v))
    out = tflash.flash_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    pallas = jflash(q, k, v, causal=True, block_q=64, block_k=64,
                    interpret=True)
    _close(out, pallas.astype(jnp.float32), BF16_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv,d", FLASH_HEADS, ids=FLASH_IDS)
def test_flash_backward_matches_jax_grad_at_new_head_dims(causal, hq, hkv,
                                                          d, rng):
    """The closed-form backward (the CPU's) and autograd through the
    wrapper against ``jax.vjp`` of the oracle; lengths past one 64-row
    tile with a ragged edge."""
    b, s = 1, 77
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)) for sh in ((b, s, hq, d), (b, s, hkv, d),
                                (b, s, hkv, d), (b, s, hq, d)))
    _, vjp = jax.vjp(lambda a, b_, c: jref.attention_ref(a, b_, c,
                                                         causal=causal),
                     *(jnp.asarray(_np(t)) for t in (q, k, v)))
    want = vjp(jnp.asarray(_np(dout)))
    out = tref.attention_ref(q, k, v, causal=causal)
    lse = tref.attention_lse_ref(q, k, causal=causal)
    closed = tflash.plain_bwd(q, k, v, out, dout, lse, causal=causal)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    auto = torch.autograd.grad(
        tflash.flash_attention(*leaves, causal=causal), leaves, dout)
    for got in (closed, auto):
        for g, w in zip(got, want):
            w = np.asarray(w)
            err = np.abs(_np(g) - w).max()
            assert err <= GRAD_TOL * max(1.0, np.abs(w).max()), err


COPY_PER = 3    # chunks a lane of flash_stage_rows_kernel holds in a pass


def _copy_lanes(d: int) -> list:
    """(lane, chunk) of each 16-byte chunk a staged row's copy stores, in
    the kernel's order. Up to 256 (``flash_stage_rows_group_kernel``) a row
    takes a group of p lanes, p the least power of two at or above its
    ``staged_ld(d) / 8`` chunks, lane j chunk j; above 256
    (``flash_stage_rows_kernel``) one warp, lane j its chunks j, j + 32, j
    + 64 in a pass of ``COPY_PER`` a lane."""
    chunks = tflash.staged_ld(d) // 8
    if d <= tflash.MAX_HEAD_DIM:
        p = 1 << (chunks - 1).bit_length()
        assert p <= 32
        return [(j, j) for j in range(p) if j < chunks]
    return [(lane, c) for base in range(0, chunks, 32 * COPY_PER)
            for i in range(COPY_PER) for lane in range(32)
            if (c := base + 32 * i + lane) < chunks]


def _stage_rows(x: torch.Tensor) -> torch.Tensor:
    """The staged routes' copy of a (b, rows, heads, d) tensor, as the
    kernels build it (``_copy_lanes``' mapping): rows of ``staged_ld(d)``
    elements, each 16-byte chunk (stored whole, by one lane) gathered from
    W-element loads of the source rows (8 bytes where d % 4 == 0, 4 where
    d is even, 2 where odd), zeros past d. Asserts that each load lies
    wholly below d and is aligned to its width (its element offset a
    multiple of W, the tensor itself 16-byte aligned), that each chunk
    starts on 16 bytes of the staged row and is stored exactly once, and,
    above 256, that no lane stores more than ceil(ld / 256) chunks."""
    d = x.shape[-1]
    ld, w = tflash.staged_ld(d), 4 if d % 4 == 0 else 2 if d % 2 == 0 else 1
    flat = x.reshape(-1)
    rows = torch.arange(flat.numel() // d)[:, None]
    out = torch.zeros(rows.numel(), ld, dtype=x.dtype)
    lanes = _copy_lanes(d)
    assert sorted(c for _, c in lanes) == list(range(ld // 8))
    if d > tflash.MAX_HEAD_DIM:
        per_lane = [sum(1 for j, _ in lanes if j == lane)
                    for lane in range(32)]
        assert max(per_lane) == -(-ld // 256)
    for _, chunk in lanes:
        for c in range(8 * chunk, 8 * chunk + 8, w):
            assert not ((rows * ld + c - c % 8) % 8).any()
            if c >= d:
                continue            # the kernel stores zeros there
            assert c + w <= d
            at = rows * d + c
            assert not (at % w).any()
            out[:, c:c + w] = flat[at + torch.arange(w)]
    return out.reshape(*x.shape[:-1], ld)


@pytest.mark.parametrize("d", [257, 260, 263, 300, 767, 100, 99])
def test_stage_rows_copies_each_row_whole(d, rng):
    """The copy's emulation (``_stage_rows``: every load below d and
    aligned to its width, every chunk stored once and whole; above 256 one
    warp a row, at most ceil(ld / 256) chunks a lane) gives the rows
    themselves followed by zeros, bit for bit, at odd, even and 4-aligned
    d from 257 to 767, and below 256 at d 100 and 99."""
    x = torch.from_numpy(rng.standard_normal((2, 3, 5, d)).astype(
        np.float32)).to(torch.bfloat16)
    got = _stage_rows(x)
    assert got.shape == (2, 3, 5, tflash.staged_ld(d))
    assert torch.equal(got[..., :d], x)
    assert not got[..., d:].any()


STAGED_HEADS = [(4, 4, 100), (4, 2, 99), (2, 1, 250), (2, 2, 36),
                (4, 4, 257), (4, 2, 263)]
STAGED_IDS = ["d100", "g2-d99", "g2-d250", "d36", "d257", "g2-d263"]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv,d", STAGED_HEADS, ids=STAGED_IDS)
def test_flash_staged_backward_arithmetic(causal, hq, hkv, d, rng):
    """The staged backward (``"wgmma_staged"``, and above 256
    ``"wgmma_wide_staged"``) in fp32: q, k, v and dout staged to
    rows of ``staged_ld(d)`` (o too, for delta, which the kernel sums over
    the real d), the closed form at that width equals ``attention_bwd_ref``
    at d bit for bit in its first d columns (the zero columns add exact
    zeros) and is zero past them; and it matches ``jax.vjp`` of
    ``repro.kernels.ref.attention_ref`` within GRAD_TOL of max(1,
    max-abs)."""
    b, s = 1, 77
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)) for sh in ((b, s, hq, d), (b, s, hkv, d),
                                (b, s, hkv, d), (b, s, hq, d)))
    scale = 1.0 / np.sqrt(d)
    out = tref.attention_ref(q, k, v, causal=causal)
    lse = tref.attention_lse_ref(q, k, causal=causal)
    want = tref.attention_bwd_ref(q, k, v, out, dout, lse, causal=causal,
                                  scale=scale)
    staged = tref.attention_bwd_ref(
        *(_stage_rows(t) for t in (q, k, v, out, dout)), lse, causal=causal,
        scale=scale)
    for g, w in zip(staged, want):
        assert g.shape[-1] == tflash.staged_ld(d) > d
        assert torch.equal(g[..., :d], w)
        assert not g[..., d:].any()
    _, vjp = jax.vjp(lambda a, b_, c: jref.attention_ref(a, b_, c,
                                                         causal=causal),
                     *(jnp.asarray(_np(t)) for t in (q, k, v)))
    for g, w in zip(staged, vjp(jnp.asarray(_np(dout)))):
        w = np.asarray(w)
        err = np.abs(_np(g[..., :d]) - w).max()
        assert err <= GRAD_TOL * max(1.0, np.abs(w).max()), err


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 257), (4, 2, 263), (2, 1, 300),
                                      (4, 4, 100)],
                         ids=["d257", "g2-d263", "g2-d300", "d100"])
def test_flash_staged_forward_arithmetic(causal, hq, hkv, d, rng):
    """The staged forward (``"wgmma_wide_staged"``; at d 100
    ``"wgmma_staged"``) in fp32: q, k and v staged to rows
    of ``staged_ld(d)`` as the copy builds them, ``attention_ref`` at that
    width with the real d's scale (1 / sqrt(d), not 1 / sqrt(ld)) equals
    the result at d bit for bit in its first d columns (the zero columns
    add exact zeros to every score, and their output columns are zero),
    and matches the Pallas kernel in interpret mode and
    ``repro.kernels.ref.attention_ref`` within GRAD_TOL of max(1,
    max-abs); two 64-row tiles, as the Pallas kernel takes them."""
    b, s = 1, 128
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    scale = 1.0 / np.sqrt(d)
    want = tref.attention_ref(q, k, v, causal=causal, scale=scale)
    staged = tref.attention_ref(*(_stage_rows(t) for t in (q, k, v)),
                                causal=causal, scale=scale)
    assert staged.shape[-1] == tflash.staged_ld(d) > d
    assert torch.equal(staged[..., :d], want)
    assert not staged[..., d:].any()
    jq, jk, jv = (jnp.asarray(_np(t)) for t in (q, k, v))
    oracle = jref.attention_ref(jq, jk, jv, causal=causal)
    pallas = jflash(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                    interpret=True)
    for w in (oracle, pallas):
        w = np.asarray(w)
        err = np.abs(_np(staged[..., :d]) - w).max()
        assert err <= GRAD_TOL * max(1.0, np.abs(w).max()), err


LOG2E = 1.4426950408889634


def _staged_wgmma_forward(q, k, v, causal, scale):
    """The bf16 forward of route ``"wgmma_staged"`` (``flash_fwd_wgmma_kernel``
    in its ``kStaged`` instantiation) tile for tile: q, k and v staged to
    rows of ``staged_ld(d)`` as the copy builds them (zeros past d); per q
    tile of 64 rows the kv tiles of 64 up to the diagonal, S = Q K^T in
    fp32, the online softmax in log2 units (scale times log2 e; masked
    scores -1e30), P rounded to bf16 as the P.V operand, fp32 sums; the
    output divided by l (1 where l is 0), rounded to bf16 and cut at d."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qs, ks, vs = (_stage_rows(t).float() for t in (q, k, v))
    bf = lambda t: t.to(torch.bfloat16).float()
    out = torch.zeros(b, sq, hq, qs.shape[-1])
    c = scale * LOG2E
    for h in range(hq):
        for q0 in range(0, sq, 64):
            Q = qs[:, q0:q0 + 64, h]
            rows = torch.arange(q0, q0 + Q.shape[1])[:, None]
            m = torch.full((b, Q.shape[1]), -1e30)
            l = torch.zeros(b, Q.shape[1])
            acc = torch.zeros(b, Q.shape[1], qs.shape[-1])
            kv_end = min(skv, q0 + 64) if causal else skv
            for k0 in range(0, kv_end, 64):
                K = ks[:, k0:k0 + 64, h // g]
                V = vs[:, k0:k0 + 64, h // g]
                cols = torch.arange(k0, k0 + K.shape[1])[None, :]
                x = Q @ K.transpose(1, 2) * c
                if causal:
                    x = torch.where(cols > rows, torch.tensor(-1e30), x)
                mn = torch.maximum(m, x.max(-1).values)
                p = torch.exp2(x - mn[..., None])
                alpha = torch.exp2(m - mn)
                l = l * alpha + p.sum(-1)
                m = mn
                acc = acc * alpha[..., None] + bf(p) @ V
            out[:, q0:q0 + 64, h] = acc / torch.where(l == 0, 1.0,
                                                      l)[..., None]
    assert not out[..., d:].any()
    return out[..., :d].to(torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 100), (4, 2, 99), (2, 1, 250)],
                         ids=["d100", "g2-d99", "g2-d250"])
def test_flash_staged_wgmma_forward_emulation_matches_pallas(causal, hq, hkv,
                                                             d, rng):
    """The bf16 staged forward (``_staged_wgmma_forward``: rows staged past
    d as zeros, P rounded to bf16) on bf16 inputs against the Pallas kernel
    in interpret mode on the same values, at the card's bf16 tolerance
    (KERNEL_TOL, 2e-2), at two 64-row q and kv tiles."""
    b, s = 1, 128
    q, k, v = (jnp.asarray(rng.standard_normal(sh), jnp.bfloat16) for sh in
               ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    tq, tk, tv = (_t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
                  for a in (q, k, v))
    assert tflash.fwd_design(torch.bfloat16, d) == "wgmma_staged"
    got = _staged_wgmma_forward(tq, tk, tv, causal, 1.0 / np.sqrt(d))
    pallas = jflash(q, k, v, causal=causal, block_q=64, block_k=64,
                    interpret=True)
    _close(got, pallas.astype(jnp.float32), BF16_TOL)


def _wide_parts_dkdv(q, k, v, out, dout, lse, causal, scale):
    """dK and dV of route ``"wide"`` at one tile, as its dK/dV blocks and
    ``flash_bwd_parts_sum_kernel`` compute them in fp32: the group's q
    heads in ``simt_wide_kv_parts`` parts, each part's block summing its
    heads' q tiles of 64 rows in walk order (head, then q tile), the parts'
    sums added in part order, dK times the scale after the sum."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    parts = tflash.simt_wide_kv_parts(b, skv, hq, hkv, d)
    qh, oh, dh = (_heads_first(t) for t in (q, out, dout))
    kh, vh = _heads_first(k), _heads_first(v)
    delta = (dh * oh).sum(-1)
    ok = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        ok = torch.arange(skv)[None, :] <= torch.arange(sq)[:, None]
    dk_parts, dv_parts = [], []
    for part in range(parts):
        dk = torch.zeros_like(kh)
        dv = torch.zeros_like(vh)
        for kvh in range(hkv):
            for gi in range(part * g // parts, (part + 1) * g // parts):
                h = kvh * g + gi
                for q0 in range(0, sq, 64):
                    Q, dO = qh[:, h, q0:q0 + 64], dh[:, h, q0:q0 + 64]
                    okt = ok[q0:q0 + 64].T
                    pt = torch.where(okt, torch.exp(
                        kh[:, kvh] @ Q.transpose(1, 2) * scale -
                        lse[:, h, None, q0:q0 + 64]), 0.0)
                    dst = pt * (vh[:, kvh] @ dO.transpose(1, 2) -
                                delta[:, h, None, q0:q0 + 64])
                    dv[:, kvh] += pt @ dO
                    dk[:, kvh] += dst @ Q
        dk_parts.append(dk)
        dv_parts.append(dv)
    dk, dv = dk_parts[0], dv_parts[0]
    for a, c in zip(dk_parts[1:], dv_parts[1:]):
        dk, dv = dk + a, dv + c
    return parts, (dk * scale).permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv,d", [(8, 1, 100), (8, 2, 64), (6, 1, 256)],
                         ids=["g8-d100", "g4-d64", "g6-d256"])
def test_wide_dkdv_parts_arithmetic(causal, hq, hkv, d, rng):
    """Route ``"wide"``'s dK and dV in parts (``_wide_parts_dkdv``: the
    group's q heads split as the plan splits them, each part's fp32 sums
    added in part order) match ``jax.vjp`` of
    ``repro.kernels.ref.attention_ref`` within GRAD_TOL of max(1,
    max-abs), on the plain forward's output and lse; the plan takes more
    than one part at these shapes, uneven where it does not divide the
    group."""
    b, s = 1, 96
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)) for sh in ((b, s, hq, d), (b, s, hkv, d),
                                (b, s, hkv, d), (b, s, hq, d)))
    scale = d ** -0.5
    out = tref.attention_ref(q, k, v, causal=causal)
    lse = tref.attention_lse_ref(q, k, causal=causal)
    parts, dk, dv = _wide_parts_dkdv(q, k, v, out, dout, lse, causal, scale)
    assert parts > 1
    _, vjp = jax.vjp(lambda a, b_, c: jref.attention_ref(a, b_, c,
                                                         causal=causal),
                     *(jnp.asarray(_np(t)) for t in (q, k, v)))
    for g, w in zip((dk, dv), vjp(jnp.asarray(_np(dout)))[1:]):
        w = np.asarray(w)
        assert g.shape == w.shape
        err = np.abs(_np(g) - w).max()
        assert err <= GRAD_TOL * max(1.0, np.abs(w).max()), err


@pytest.mark.parametrize("d,dtype,design", [
    (96, torch.bfloat16, "wgmma"), (80, torch.bfloat16, "wgmma"),
    (256, torch.bfloat16, "wgmma"), (136, torch.bfloat16, "wgmma"),
    (40, torch.bfloat16, "wgmma"), (100, torch.bfloat16, "wgmma_staged"),
    (250, torch.bfloat16, "wgmma_staged"), (24, torch.bfloat16, "simt"),
    (8, torch.bfloat16, "simt"), (256, torch.float32, "wide"),
    (96, torch.float32, "wide"), (1, torch.float32, "simt")])
def test_flash_designs_name_the_route_at_new_head_dims(d, dtype, design):
    """bf16 above 32 on the wgmma kernels, on the caller's rows where d is
    a multiple of 8 (the TMA maps need rows of whole 16-byte chunks) and
    through staged rows at the other d (100, 250); fp32 above 32 on the
    CUDA-core tiles of route "wide" (one tile up to 256); both dtypes at
    32 and below on the CUDA-core kernels at the padded head dim; forward
    and backward alike."""
    assert tflash.fwd_design(dtype, d) == tflash.bwd_design(dtype, d) == \
        design
    padded = tflash.padded_head_dim(d)
    assert padded in tflash.HEAD_DIMS and padded >= d
    assert all(p < d for p in tflash.HEAD_DIMS if p < padded)


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_flash_and_decode_designs_name_the_route_above_256(d):
    """Above 256 every dtype takes a column-tile route, forward and
    backward, at the real d: bf16 the tensor-core one, over the caller's
    rows at a multiple of 8 (``"wgmma_wide"``) and over rows staged to
    ``staged_ld(d)`` at the other d (``"wgmma_wide_staged"``), fp32 the
    CUDA-core one (``"wide"``: ceil(d / 256) tiles of equal width rounded
    up to 16, covering d, the last cut at d); decode's route is its
    column-tile kernel at any group, in slices of 16 q heads."""
    assert tflash.fwd_design(torch.float32, d) == \
        tflash.bwd_design(torch.float32, d) == "wide"
    want = "wgmma_wide" if d in WGMMA_WIDE_DIMS else "wgmma_wide_staged"
    assert tflash.fwd_design(torch.bfloat16, d) == \
        tflash.bwd_design(torch.bfloat16, d) == want
    assert tflash.padded_head_dim(d) == d
    n, tw = tflash.col_tiles(d)
    assert n == -(-d // 256) and tw % 16 == 0 and tw <= 256
    assert (n - 1) * tw < d <= n * tw
    for g, slices in ((1, 1), (16, 1), (128, 8), (71, 5)):
        assert tdecode.group_bucket(g, d) == 16
        for es in (2, 4):
            lay = tdecode.pv_layout(es, d, g)
            assert lay["route"] == "wide" and lay["D"] == d
            assert (lay["col_tiles"], lay["tile"]) == (n, tw)
            assert lay["slices"] == slices
            assert lay["smem"] <= tdecode.MAX_SMEM
            assert lay["cols_per_thread"] * tdecode.THREADS >= tw
    # at D 256: bf16 d 256 on the tensor cores, fp32 and bf16 d 250 (not
    # whole 16-byte chunks) on decode_split_kernel
    assert tdecode.pv_layout(2, 256, 8)["route"] == "mma"
    assert tdecode.pv_layout(4, 256, 8)["route"] == "split"
    assert tdecode.pv_layout(2, 250, 8)["route"] == "split"


CSRC = Path(tflash.__file__).resolve().parents[1] / "csrc"


def _c_int_fn(src: str, name: str):
    """A one-statement ``__host__ __device__ inline`` int function of
    ``src`` (int arguments; C's / on ints >= 0 is //, one ?: at the top
    level, calls of the other such functions of ``src``) as a Python
    function of the same arguments."""
    m = re.search(rf"inline \w+ {name}\(((?:int \w+(?:, )?)+)\) \{{\s*"
                  rf"return ([^;]+);\s*\}}", src)
    args = re.findall(r"int (\w+)", m.group(1))
    body = " ".join(m.group(2).split())
    body = body.replace("&&", " and ").replace("/", "//")
    fns = {n: _c_int_fn(src, n) for n in re.findall(r"(\w+)\(", body)
           if n != name and re.search(rf"inline \w+ {n}\(", src)}
    body = re.sub(r"^(.+) \? (.+) : (.+)$", r"(\2 if \1 else \3)", body)
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    return lambda *vals: eval(body, {**fns, **{k: int(v) for k, v in
                                               const.items()},
                                     **dict(zip(args, vals))})


@pytest.mark.parametrize("d", [264, 288, 320, 384, 392, 512, 520, 576, 640,
                               704, 712, 768])
def test_wgmma_wide_tile_plan_covers_d_at_instantiated_widths(d):
    """The tensor-core column tiles (``wgmma_col_tiles``, the backward's
    and the forward's plan): they cover d, none is empty, each is at most
    256 wide and an N the C dispatch instantiates (its ``case`` labels,
    forward and backward); the plans are ``csrc/common.cuh``'s
    ``tc_wide_col_tiles`` / ``tc_wide_tile_width`` and
    ``tc_wide_fwd_col_tiles`` / ``tc_wide_fwd_tile_width`` evaluated from
    the source, and the route is ``tc_wide_route``'s."""
    common = (CSRC / "common.cuh").read_text()
    for forward, fn in ((False, ""), (True, "fwd_")):
        n, width = tflash.wgmma_col_tiles(d, forward=forward)
        assert (n - 1) * width < d <= n * width
        assert width <= 256 and width % 64 == 0
        assert width in tflash.TC_WIDE_WIDTHS
        assert (_c_int_fn(common, f"tc_wide_{fn}col_tiles")(d),
                _c_int_fn(common, f"tc_wide_{fn}tile_width")(d)) == \
            (n, width)
    assert tflash.wgmma_col_tiles(d, forward=True)[1] == (
        192 if d <= tflash.TC_WIDE_FWD_192_MAX else
        tflash.wgmma_col_tiles(d)[1])
    assert bool(_c_int_fn(common, "tc_wide_route")(d)) == \
        (tflash.fwd_design(torch.bfloat16, d) == "wgmma_wide")
    wide = (CSRC / "flash_attention_wide.cu").read_text()
    for launch in ("fwd_as", "bwd_as"):
        cases = {int(x) for x in re.findall(
            rf"case (\d+): return tcw::{launch}<\1>", wide)}
        assert cases == set(tflash.TC_WIDE_WIDTHS)
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", common))
    assert int(const["kTcWideMaxDim"]) == tflash.TC_WIDE_MAX_HEAD_DIM
    assert int(const["kTcWideFwd192MaxDim"]) == tflash.TC_WIDE_FWD_192_MAX


def test_wide_staged_route_follows_the_c_source():
    """``csrc/common.cuh``'s ``tc_wide_staged_route`` and ``staged_ld``,
    evaluated from the source, equal their Python twins at every d from
    257 to 800: the route is where ``fwd_design`` and ``bwd_design`` name
    ``"wgmma_wide_staged"`` for bf16 (never for fp32), disjoint from
    ``tc_wide_route``, the two together every d up to 768; its rows are
    whole 16-byte chunks, under 8 elements past d. Both entry points of
    ``flash_attention.cu`` try it after ``tc_wide_route`` and before the
    CUDA-core column tiles, and ``flash_attention_wide.cu`` instantiates
    its kernels (``kStaged``) at both widths, forward and backward."""
    common = (CSRC / "common.cuh").read_text()
    route = _c_int_fn(common, "tc_wide_staged_route")
    aligned = _c_int_fn(common, "tc_wide_route")
    staged_ld = _c_int_fn(common, "staged_ld")
    bf16 = torch.bfloat16
    for d in range(257, 801):
        staged = tflash.fwd_design(bf16, d) == "wgmma_wide_staged"
        assert bool(route(d)) == staged == (
            tflash.bwd_design(bf16, d) == "wgmma_wide_staged")
        assert tflash.fwd_design(torch.float32, d) == "wide"
        assert not (route(d) and aligned(d))
        assert bool(route(d) or aligned(d)) == (
            d <= tflash.TC_WIDE_MAX_HEAD_DIM)
        assert staged_ld(d) == tflash.staged_ld(d)
        assert staged_ld(d) % 8 == 0 and 0 <= staged_ld(d) - d < 8
        assert (staged_ld(d) > d) == (d % 8 != 0)
    src = (CSRC / "flash_attention.cu").read_text()
    for entry in ('extern "C" int repro_flash_attention(',
                  'extern "C" int repro_flash_attention_bwd('):
        body = src[src.index(entry):]
        assert body.index("tc_wide_route(d)") < \
            body.index("tc_wide_staged_route(d)") < \
            body.index("return wide::launch_")
    wide = (CSRC / "flash_attention_wide.cu").read_text()
    for launch in ("fwd_as", "bwd_as"):
        cases = {int(x) for x in re.findall(
            rf"case (\d+): return tcw::{launch}<\1, true>", wide)}
        assert cases == set(tflash.TC_WIDE_WIDTHS)


SIMT_WIDE_FNS = {"tiles": "simt_wide_col_tiles",
                 "width": "simt_wide_tile_width",
                 "cluster": "simt_wide_cluster",
                 "clusters": "simt_wide_clusters",
                 "slice": "simt_wide_slice_width",
                 "resident": "simt_wide_resident"}
MODES = {"kStreamed": tflash.STREAMED, "kResident": tflash.RESIDENT,
         "kOneTile": tflash.ONE_TILE}


def _check_simt_wide_plan(d, plan):
    """The plan covers d: tiles of ``width`` (64-256, one tile up to 256;
    an instantiated width) none empty, the last holding column d - 1;
    clusters of at most 8 that hold every tile; slices of whole 32-column
    pieces, none empty, that cover d; X resident at one tile, and above it
    exactly where the copies are element copies (d % 4 != 0) and a slice
    is no wider than a tile, which holds up to 8 tiles (d 2048)."""
    n, w, c, sw = plan["tiles"], plan["width"], plan["cluster"], \
        plan["slice"]
    assert (n - 1) * w < d <= n * w and w % 64 == 0 and w <= 256
    assert w in tflash.SIMT_WIDE_WIDTHS
    assert (n == 1) == (d <= tflash.MAX_HEAD_DIM)
    assert 1 <= c <= tflash.SIMT_WIDE_MAX_CLUSTER and c <= n
    assert (plan["clusters"] - 1) * c < n <= plan["clusters"] * c
    assert sw % tflash.SIMT_WIDE_PIECE == 0
    assert (c - 1) * sw < d <= c * sw
    assert bool(plan["resident"]) == (n == 1 or (d % 4 != 0 and sw <= w))
    if d <= 2048:
        assert sw <= w


def _simt_wide_instantiations():
    """(dtype, copy width, tile width, mode) of every route "wide" kernel
    the sources instantiate: the one-tile cases of
    ``flash_attention_simt_tile.cu`` and the column tiles' of
    ``flash_attention_simt_wide.cu``, forward and backward alike (the
    column tiles' template takes width 192 only under ``if constexpr
    (f32)``: bf16 is always 256 wide there)."""
    fwd, bwd = set(), set()
    for name in ("flash_attention_simt_tile.cu",
                 "flash_attention_simt_wide.cu"):
        src = (CSRC / name).read_text()
        for launch, got in (("fwd_as", fwd), ("bwd_as", bwd)):
            for t, vec, w, m in re.findall(
                    rf"{launch}<(\w+), (\d), (\d+), (\w+)>", src):
                for dt in ((torch.float32,) if t == "float" or w == "192"
                           else (torch.float32, torch.bfloat16)):
                    got.add((dt, int(vec), int(w), MODES[m]))
    src = (CSRC / "flash_attention_simt_wide.cu").read_text()
    assert src.count("if constexpr (f32)") == 4
    assert fwd == bwd and fwd
    return fwd


@pytest.mark.parametrize("lo", [1] + list(range(257, 4201, 493)))
def test_simt_wide_plan_follows_the_c_source(lo):
    """``csrc/common.cuh``'s plan of the CUDA-core tiles (route ``"wide"``:
    ``simt_wide_col_tiles``, ``simt_wide_tile_width``,
    ``simt_wide_cluster``, ``simt_wide_clusters``,
    ``simt_wide_slice_width``, ``simt_wide_resident``,
    ``simt_wide_kv_tiles``), evaluated from the source, equals its Python
    twin (``simt_wide_plan``, ``simt_wide_kv_tiles``) at every d from 1 to
    256 (case 1, with ``simt_wide_route`` against ``fwd_design`` in both
    dtypes: fp32 from 33, never bf16) and from 257 to 4200 (this case's 493
    of them) and covers d (``_check_simt_wide_plan``); every d the route
    takes maps to an instantiation of the sources at its copy width, tile
    width and mode (``SIMT_WIDE_KERNELS``: fp32 at one tile of 64-256,
    clusters of 192 and 256); decode's plan (``col_tiles``) is not this
    one's and stays as it was."""
    common = (CSRC / "common.cuh").read_text()
    fns = {k: _c_int_fn(common, name) for k, name in SIMT_WIDE_FNS.items()}
    route = _c_int_fn(common, "simt_wide_route")
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", common))
    assert (int(const["kSimtWideCols"]), int(const["kSimtWideMaxCluster"]),
            int(const["kSimtWidePiece"]), int(const["kSimtWideKvRows"]),
            int(const["kSimtMaxDim"])) == (
        tflash.SIMT_WIDE_COLS, tflash.SIMT_WIDE_MAX_CLUSTER,
        tflash.SIMT_WIDE_PIECE, tflash.SIMT_WIDE_KV_ROWS,
        tflash.SIMT_MAX_HEAD_DIM)
    kernels = _simt_wide_instantiations()
    assert kernels == set(tflash.SIMT_WIDE_KERNELS)
    assert len(kernels) == len(tflash.SIMT_WIDE_KERNELS) == 16
    hi = tflash.MAX_HEAD_DIM + 1 if lo == 1 else min(lo + 493, 4201)
    for d in range(lo, hi):
        plan = tflash.simt_wide_plan(d)
        assert {k: fn(d) for k, fn in fns.items()} == plan
        _check_simt_wide_plan(d, plan)
        for dtype, f32 in ((torch.float32, 1), (torch.bfloat16, 0)):
            wide = tflash.fwd_design(dtype, d) == "wide"
            assert bool(route(f32, d)) == wide == \
                (tflash.bwd_design(dtype, d) == "wide")
            if wide:
                assert (dtype, 4 if d % 4 == 0 else 1, plan["width"],
                        tflash.simt_wide_mode(d)) in kernels, d
        if d <= tflash.MAX_HEAD_DIM:
            assert tflash.fwd_design(torch.float32, d) == (
                "wide" if d > 32 else "simt")
            assert tflash.simt_wide_mode(d) == tflash.ONE_TILE
        else:
            assert tflash.col_tiles(d) == (
                -(-d // 256), -(-(-(-d // -(-d // 256))) // 16) * 16)
    kv = _c_int_fn(common, "simt_wide_kv_tiles")
    for skv in (1, 31, 32, 33, 256, 333, 4096):
        assert kv(skv) == tflash.simt_wide_kv_tiles(skv) == -(-skv // 32)


def test_simt_wide_shared_memory_fits_every_instantiation():
    """Each route "wide" kernel's shared memory (``simt_wide_smem``, the
    twin of ``Tiles::smem`` in ``flash_attention_simt_wide.cuh``: X
    resident but with kStreamed, three staging buffers, W, two partials
    with a cluster) at every instantiated width and mode is at most a
    block's 227 KB (the header's ``kMaxSmem``, which its kernels'
    static_asserts hold); dQ with Q and dO resident at width 256 needs K
    in chunks of 16 rows (with 32 it would not fit); at one tile nothing
    goes to the partials (the 32 KB of a cluster's)."""
    hdr = (CSRC / "flash_attention_simt_wide.cuh").read_text()
    max_smem = int(re.search(r"kMaxSmem = (\d+);", hdr).group(1))
    assert max_smem == 232448
    assert int(re.search(r"constexpr int kStages = (\d+);", hdr).group(1)) \
        == 3
    assert "TW == 256 && MODE != kStreamed ? 16 : 32" in hdr
    assert hdr.count("static_assert(P::smem() <= kMaxSmem") == 3
    for _, _, w, mode in tflash.SIMT_WIDE_KERNELS:
        for kernel in ("fwd", "dkdv", "dq"):
            assert tflash.simt_wide_smem(kernel, w, mode) <= max_smem, \
                (kernel, w, mode)
    # dQ at 256 with 32-row chunks of K: 240,640 bytes, past a block's
    lp, x = 68, 2 * 64 * 260
    assert 4 * (x + 3 * max(2 * 32 * lp, 32 * 256) + 64 * 36) > max_smem
    for kernel in ("fwd", "dkdv", "dq"):
        assert tflash.simt_wide_smem(kernel, 256, tflash.RESIDENT) - \
            tflash.simt_wide_smem(kernel, 256, tflash.ONE_TILE) == 32768


@pytest.mark.parametrize("b,skv,hq,hkv,d,parts", [
    (8, 256, 8, 1, 256, 5), (8, 256, 32, 8, 160, 1), (8, 256, 8, 2, 99, 3),
    (8, 256, 32, 32, 96, 1), (8, 256, 8, 8, 100, 1), (8, 256, 8, 1, 576, 1),
    (8, 256, 8, 2, 288, 1), (1, 77, 4, 1, 64, 4), (2, 64, 8, 2, 257, 4)])
def test_wide_dkdv_parts_follow_the_c_source(b, skv, hq, hkv, d, parts):
    """Route "wide"'s dK/dV walk in parts (``simt_wide_kv_parts``, the C
    function of the blocks one part takes and the group, evaluated from
    ``common.cuh``): one where the blocks fill a wave of the H100 (132;
    at 8/1 d 576 and 8/2 d 288 the 192 and 256 blocks), else enough parts
    for ``SIMT_WIDE_FILL_BLOCKS`` blocks, at most the group's q heads; the
    wrapper's scratch holds each part's fp32 dK and dV (none with one
    part). At gemma-2b's 8/1 d 256, b 8, s 256 the 64 blocks of 32 kv rows
    become 320, at least one an SM of the H100."""
    common = (CSRC / "common.cuh").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", common))
    assert int(const["kSimtWideFillBlocks"]) == tflash.SIMT_WIDE_FILL_BLOCKS
    assert int(const["kSimtWideWave"]) == tflash.SIMT_WIDE_WAVE
    c_parts = _c_int_fn(common, "simt_wide_kv_parts")
    plan = tflash.simt_wide_plan(d)
    blocks = plan["cluster"] * plan["clusters"] * hkv * b * \
        tflash.simt_wide_kv_tiles(skv)
    got = tflash.simt_wide_kv_parts(b, skv, hq, hkv, d)
    assert got == c_parts(blocks, hq // hkv) == parts
    assert 1 <= got <= hq // hkv
    if blocks >= tflash.SIMT_WIDE_WAVE:
        assert got == 1
    else:
        assert got == hq // hkv or \
            blocks * got >= tflash.SIMT_WIDE_FILL_BLOCKS
    assert tflash.wide_parts_numel(b, skv, hq, hkv, d) == (
        0 if got == 1 else 2 * got * b * skv * hkv * d)
    if (hq, hkv, d) == (8, 1, 256):
        assert blocks == 64 and blocks * got >= 132


@pytest.mark.parametrize("d", WIDE_DIMS + [800, 2100, 4200])
def test_flash_wide_plan_covers_d(d):
    """Route ``"wide"`` (fp32 above 256, bf16 above 768) plans its column
    tiles, clusters and slices of d as ``_check_simt_wide_plan`` holds;
    at 8/1 d 576, b 8, s 256 its dK/dV kernel launches at least one block
    an SM of the H100 (132), where PR 33's launched 96."""
    assert tflash.fwd_design(torch.float32, d) == "wide"
    if d > tflash.TC_WIDE_MAX_HEAD_DIM:
        assert tflash.fwd_design(torch.bfloat16, d) == \
            tflash.bwd_design(torch.bfloat16, d) == "wide"
    plan = tflash.simt_wide_plan(d)
    _check_simt_wide_plan(d, plan)
    if d == 576:
        blocks = tflash.simt_wide_kv_tiles(256) * 1 * 8 * \
            plan["cluster"] * plan["clusters"]
        assert blocks >= 132


def _wide_slices(d):
    plan = tflash.simt_wide_plan(d)
    return plan, [(r * plan["slice"], min(d, (r + 1) * plan["slice"]))
                  for r in range(plan["cluster"])]


def _rank_sum(x, y, slices):
    """x (..., m, d) y (..., n, d)^T as the cluster computes it: each rank
    the product over its slice of d, every block summing them in rank
    order."""
    tot = None
    for s0, s1 in slices:
        part = torch.einsum("...md,...nd->...mn", x[..., s0:s1],
                            y[..., s0:s1])
        tot = part if tot is None else tot + part
    return tot


def _heads_first(t, g=1):
    """(b, s, h, d) -> (b, h g, s, d), each head repeated g times."""
    return t.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)


def _wide_cluster_forward(q, k, v, causal, scale):
    """The forward of route ``"wide"`` in fp32, block by block: every
    column tile of every cluster sums the partial scores of the plan's
    slices in rank order, runs the online softmax over 64-row kv tiles
    and accumulates P V over its own columns. Returns out (b, s, hq, d),
    lse (b, hq, s), and each tile's m and l."""
    b, sq, hq, d = q.shape
    skv, g = k.shape[1], hq // k.shape[2]
    qh, kh, vh = _heads_first(q), _heads_first(k, g), _heads_first(v, g)
    plan, slices = _wide_slices(d)
    out = torch.zeros(b, hq, sq, d)
    rows = torch.arange(sq)[:, None]
    ms, ls = [], []
    for ct in range(plan["cluster"] * plan["clusters"]):
        c0, c1 = ct * plan["width"], min(d, (ct + 1) * plan["width"])
        m = torch.full((b, hq, sq), -1e30)
        l = torch.zeros(b, hq, sq)
        acc = torch.zeros(b, hq, sq, max(c1 - c0, 0))
        for k0 in range(0, skv, 64):
            s = _rank_sum(qh, kh[:, :, k0:k0 + 64], slices) * scale
            cols = torch.arange(k0, min(skv, k0 + 64))[None, :]
            if causal:
                s = torch.where(cols > rows, torch.tensor(-1e30), s)
            m_new = torch.maximum(m, s.max(-1).values)
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            m = m_new
            acc = alpha[..., None] * acc + p @ vh[:, :, k0:k0 + 64, c0:c1]
        ms.append(m)
        ls.append(l)
        if c0 < d:
            out[..., c0:c1] = acc / torch.where(l == 0, 1.0, l)[..., None]
    lse = ms[0] + torch.log(torch.where(ls[0] == 0, 1.0, ls[0]))
    return out.permute(0, 2, 1, 3), lse, ms, ls


WIDE_CLUSTER_HEADS = [(4, 4, 257), (4, 2, 288), (2, 1, 576), (2, 2, 2100)]
WIDE_CLUSTER_IDS = ["d257", "g2-d288", "g2-d576", "two-clusters-d2100"]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv,d", WIDE_CLUSTER_HEADS, ids=WIDE_CLUSTER_IDS)
def test_wide_cluster_forward_arithmetic(causal, hq, hkv, d, rng):
    """The cluster's arithmetic (``_wide_cluster_forward``) in fp32: every
    column tile, in every cluster (two at d 2100), holds m and l bitwise
    equal to every other's, so every column is normalised alike; the
    result matches ``repro.kernels.ref.attention_ref`` and the Pallas
    kernel in interpret mode within GRAD_TOL of max(1, max-abs), at two
    64-row q and kv tiles."""
    b, s = 1, 128
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    out, lse, ms, ls = _wide_cluster_forward(q, k, v, causal, d ** -0.5)
    assert len(ms) == len(ls) > 1
    assert all(torch.equal(m, ms[0]) and torch.equal(l, ls[0])
               for m, l in zip(ms, ls))
    jq, jk, jv = (jnp.asarray(_np(t)) for t in (q, k, v))
    oracle = jref.attention_ref(jq, jk, jv, causal=causal)
    pallas = jflash(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                    interpret=True)
    for w in (oracle, pallas):
        w = np.asarray(w)
        err = np.abs(_np(out) - w).max()
        assert err <= GRAD_TOL * max(1.0, np.abs(w).max()), err
    torch.testing.assert_close(lse, tref.attention_lse_ref(
        q, k, causal=causal), rtol=GRAD_TOL, atol=GRAD_TOL)


def _wide_cluster_backward(q, k, v, out, dout, lse, causal, scale):
    """The backward of route ``"wide"`` in fp32, as its two kernels
    compute it: the dK/dV blocks sum the partial S^T = K Q^T and dP^T = V
    dO^T of the plan's slices in rank order, the dQ blocks S = Q K^T and
    dP = dO V^T likewise; P from the forward's lse, dS = P (dP - delta)
    with delta over the real d; dV = P^T dO, dK = dS^T Q scale, dQ = dS K
    scale, each column tile over its own columns."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qh, oh, dh = (_heads_first(t) for t in (q, out, dout))
    kh, vh = _heads_first(k, g), _heads_first(v, g)
    plan, slices = _wide_slices(d)
    delta = (dh * oh).sum(-1)
    ok = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        ok = torch.arange(skv)[None, :] <= torch.arange(sq)[:, None]
    st = _rank_sum(kh, qh, slices)                     # S^T (dK/dV blocks)
    dpt = _rank_sum(vh, dh, slices)
    pt = torch.where(ok.T, torch.exp(st * scale - lse[..., None, :]), 0.0)
    dst = pt * (dpt - delta[..., None, :])
    s = _rank_sum(qh, kh, slices)                      # S (dQ blocks)
    dp = _rank_sum(dh, vh, slices)
    p = torch.where(ok, torch.exp(s * scale - lse[..., None]), 0.0)
    ds = p * (dp - delta[..., None])
    dq, dk, dv = torch.zeros_like(qh), torch.zeros_like(kh), \
        torch.zeros_like(vh)
    for ct in range(plan["tiles"]):
        c0, c1 = ct * plan["width"], min(d, (ct + 1) * plan["width"])
        dv[..., c0:c1] = pt @ dh[..., c0:c1]
        dk[..., c0:c1] = dst @ qh[..., c0:c1] * scale
        dq[..., c0:c1] = ds @ kh[..., c0:c1] * scale

    def back(t, heads):
        t = t.reshape(b, heads, -1, *t.shape[2:]).sum(2)
        return t.permute(0, 2, 1, 3)
    return dq.permute(0, 2, 1, 3), back(dk, hkv), back(dv, hkv)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv,d", WIDE_CLUSTER_HEADS, ids=WIDE_CLUSTER_IDS)
def test_wide_cluster_backward_arithmetic(causal, hq, hkv, d, rng):
    """The backward twin (``_wide_cluster_backward``: partial S^T and dP^T,
    S and dP, over the plan's slices summed in rank order) on the
    emulated forward's output and lse matches ``jax.vjp`` of
    ``repro.kernels.ref.attention_ref`` within GRAD_TOL of max(1,
    max-abs)."""
    b, s = 1, 96
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)) for sh in ((b, s, hq, d), (b, s, hkv, d),
                                (b, s, hkv, d), (b, s, hq, d)))
    scale = d ** -0.5
    out, lse, _, _ = _wide_cluster_forward(q, k, v, causal, scale)
    got = _wide_cluster_backward(q, k, v, out, dout, lse, causal, scale)
    _, vjp = jax.vjp(lambda a, b_, c: jref.attention_ref(a, b_, c,
                                                         causal=causal),
                     *(jnp.asarray(_np(t)) for t in (q, k, v)))
    for g, w in zip(got, vjp(jnp.asarray(_np(dout)))):
        w = np.asarray(w)
        assert g.shape == w.shape
        err = np.abs(_np(g) - w).max()
        assert err <= GRAD_TOL * max(1.0, np.abs(w).max()), err


@pytest.mark.parametrize("skv", [1, 31, 32, 33, 256, 740, 1024, 1025, 4096,
                                 32768])
def test_staged_rows_and_decode_split_plan_follow_the_c_source(skv):
    """The Python twins of ``csrc/common.cuh``, evaluated from the source:
    the staged flash backward's route and row length (``staged_route``,
    ``staged_ld``), and the tensor-core decode's route and split plan
    (``decode_mma_route``, ``decode_mma_splits``,
    ``decode_mma_split_rows``) at several unit counts (b x hkv x slices).
    The plan covers skv in whole tiles, at most 32 splits (the combine's
    lanes), at least ``MMA_MIN_ROWS`` rows a split, and otherwise fills
    about ``MMA_BLOCKS`` blocks."""
    common = (CSRC / "common.cuh").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", common))
    assert int(const["kDecodeMmaTile"]) == tdecode.MMA_TILE
    assert int(const["kDecodeMmaBlocks"]) == tdecode.MMA_BLOCKS
    assert int(const["kDecodeMmaMinRows"]) == tdecode.MMA_MIN_ROWS
    staged_route = _c_int_fn(common, "staged_route")
    staged_ld = _c_int_fn(common, "staged_ld")
    mma_route = _c_int_fn(common, "decode_mma_route")
    for d in range(1, 600):
        assert staged_ld(d) == tflash.staged_ld(d)
        assert bool(staged_route(d)) == (
            tflash.bwd_design(torch.bfloat16, d) == "wgmma_staged")
        assert bool(mma_route(d)) == tdecode.mma_route(torch.bfloat16, d)
        assert not tdecode.mma_route(torch.float32, d)
    splits = _c_int_fn(common, "decode_mma_splits")
    rows = _c_int_fn(common, "decode_mma_split_rows")
    for units in (1, 2, 3, 4, 8, 32, 64, 71, 132, 264, 265, 1024):
        assert splits(units) == tdecode.mma_splits(units)
        sr = tdecode.mma_split_rows(skv, units)
        assert rows(skv, units) == sr
        n = -(-skv // sr)
        assert sr % tdecode.MMA_TILE == 0 and sr >= tdecode.MMA_MIN_ROWS
        assert n <= tdecode.mma_splits(units) <= tdecode.MMA_MAX_SPLITS
        # the least whole tiles that keep to the plan's splits
        assert sr == tdecode.MMA_MIN_ROWS or \
            -(-skv // (sr - tdecode.MMA_TILE)) > tdecode.mma_splits(units)
    # 4 slots on one kv head at the serve cache: 12 splits of 64 rows; at a
    # cache of 4096, 32 splits of 128
    assert tdecode.mma_split_rows(740, 4) == 64
    assert tdecode.mma_split_rows(4096, 4) == 128


@pytest.mark.parametrize("d", [0, -1])
def test_flash_and_decode_refuse_head_dims_no_kernel_takes(d):
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match=f"head_dim {d}"):
            tflash.fwd_design(dtype, d)
        with pytest.raises(ValueError, match=f"head_dim {d}"):
            tflash.bwd_design(dtype, d)
    with pytest.raises(ValueError, match=f"head_dim {d}"):
        tdecode.pv_layout(2, d, 1)


# ---------------------------------------------------------------------------
# Decode attention.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hq,hkv,d", DECODE_HEADS, ids=DECODE_IDS)
def test_decode_plain_matches_pallas_at_new_shapes(hq, hkv, d, rng):
    b, skv = 4, 256
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    length = np.array([1, skv, 100, 37], np.int32)
    out = tdecode.decode_attention(_t(q), _t(k), _t(v), _t(length))
    pallas = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(length), block_k=128, interpret=True)
    oracle = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(length))
    for want in (pallas, oracle):
        _close(out, want, F32_ATTN_TOL)
    # partial mode: the same out, and the log-sum-exp of the scaled scores
    out2, lse = tdecode.decode_attention(_t(q), _t(k), _t(v), _t(length),
                                         return_lse=True)
    _close(out2, oracle, F32_ATTN_TOL)
    s = np.einsum("bhd,bshd->bhs", q,
                  np.repeat(k, hq // hkv, axis=2)) / np.sqrt(d)
    s = np.where(np.arange(skv)[None, None] < length[:, None, None], s,
                 -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + \
        s.max(-1)
    np.testing.assert_allclose(_np(lse), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("hq,hkv,d", DECODE_WIDE, ids=DECODE_WIDE_IDS)
def test_decode_plain_matches_pallas_above_256(hq, hkv, d, lse, rng):
    """The Pallas decode kernel (interpret mode) computes at any d: the
    plain version matches it and the oracle, in out-only and partial mode
    (the out the same, the lse that of the scaled scores)."""
    b, skv = 2, 128
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    length = np.array([skv, 37], np.int32)
    got = tdecode.decode_attention(_t(q), _t(k), _t(v), _t(length),
                                   return_lse=lse)
    out = got[0] if lse else got
    pallas = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(length), block_k=64, interpret=True)
    oracle = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(length))
    for want in (pallas, oracle):
        _close(out, want, F32_ATTN_TOL)
    if lse:
        s = np.einsum("bhd,bshd->bhs", q.astype(np.float64),
                      np.repeat(k, hq // hkv, axis=2)) / np.sqrt(d)
        s = np.where(np.arange(skv)[None, None] < length[:, None, None], s,
                     -np.inf)
        m = s.max(-1)
        want = np.log(np.exp(s - m[..., None]).sum(-1)) + m
        np.testing.assert_allclose(_np(got[1]), want, rtol=1e-5, atol=1e-5)


def test_decode_bf16_plain_matches_pallas_at_mla_width(rng):
    """bf16 at the absorbed MLA shape, against the Pallas kernel at
    BF16_TOL."""
    b, skv, hq, d = 2, 128, 128, 576
    q, k, v = (jnp.asarray(rng.standard_normal(sh), jnp.bfloat16) for sh in
               ((b, hq, d), (b, skv, 1, d), (b, skv, 1, d)))
    length = jnp.asarray([100, skv], jnp.int32)
    tq, tk, tv = (_t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
                  for a in (q, k, v))
    out = tdecode.decode_attention(tq, tk, tv, _t(np.asarray(length)))
    assert out.dtype == torch.bfloat16
    pallas = jdecode(q, k, v, length, block_k=64, interpret=True)
    _close(out, pallas.astype(jnp.float32), BF16_TOL)


def _decode_mma_emulation(q, k, v, length):
    """``decode_mma_kernel``'s arithmetic (route ``"mma"``) on fp32 tensors
    holding bf16 values: the splits of ``mma_split_rows`` (at most 32),
    tiles of ``MMA_TILE`` rows, S in fp32 (the bf16 products are exact),
    the running max (log2 units) and sum over tiles in fp32, P rounded to
    bf16 for P.V with fp32 sums, then the combine of the splits that hold
    rows by exp2 weights. Returns out (rounded to bf16) and the lse (-inf
    at length 0)."""
    b, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    rows = tdecode.mma_split_rows(skv, b * hkv * tdecode.group_slices(g))
    splits = -(-skv // rows)
    assert splits <= tdecode.MMA_MAX_SPLITS
    c = np.float32(np.log2(np.e) / np.sqrt(d))
    out = torch.zeros(b, hq, d)
    lse = torch.full((b, hq), -np.inf)
    for bb in range(b):
        n = min(max(int(length[bb]), 0), skv)
        for h in range(hkv):
            qh = q[bb, h * g:(h + 1) * g]
            parts = []
            for r0 in range(0, n, rows):        # the splits below length
                r1 = min(n, r0 + rows)
                m = torch.full((g,), -1e30)
                l, acc = torch.zeros(g), torch.zeros(g, d)
                for t0 in range(r0, r1, tdecode.MMA_TILE):
                    t1 = min(r1, t0 + tdecode.MMA_TILE)
                    st = (qh @ k[bb, t0:t1, h].T) * c
                    mn = torch.maximum(m, st.max(-1).values)
                    p = torch.exp2(st - mn[:, None])
                    a = torch.exp2(m - mn)
                    l = l * a + p.sum(-1)
                    acc = acc * a[:, None] + \
                        p.bfloat16().float() @ v[bb, t0:t1, h]
                    m = mn
                parts.append((m, l, acc))
            if not parts:
                continue
            ms = torch.stack([p_[0] for p_ in parts])
            mx = ms.max(0).values
            w = torch.exp2(ms - mx)
            tot = (w * torch.stack([p_[1] for p_ in parts])).sum(0)
            o = sum((w[i] / tot)[:, None] * p_[2] for i, p_ in
                    enumerate(parts))
            out[bb, h * g:(h + 1) * g] = o
            lse[bb, h * g:(h + 1) * g] = (mx + torch.log2(tot)) * np.log(2)
    return out.bfloat16().float(), lse


@pytest.mark.parametrize("hq", [1, 5, 8, 16, 71],
                         ids=["g1", "g5", "gemma-g8", "g16", "falcon-g71"])
def test_decode_mma_emulation_matches_pallas_at_d256(hq, rng):
    """Route ``"mma"`` (bf16, d 256) emulated (``_decode_mma_emulation``),
    against the Pallas decode kernel in interpret mode on the same bf16
    inputs within BF16_TOL, at groups 1, 5, 8 (gemma-2b's 8/1), 16 and 71
    (five slices of q heads), lengths 0, 1, 129 and 731 of a cache of 768
    (12 splits of one 64-row tile; at 71 heads, five slices, 6 splits of
    two tiles); partial mode's lse against the
    log-sum-exp of the scaled scores in float64 within 1e-5 (rtol and
    atol: fp32 sums in another order), -inf at length 0."""
    assert tdecode.mma_split_rows(768, 4 * tdecode.group_slices(hq)) == (
        128 if hq > 16 else 64)
    b, skv, d = 4, 768, 256
    q, k, v = (jnp.asarray(rng.standard_normal(sh), jnp.bfloat16) for sh in
               ((b, hq, d), (b, skv, 1, d), (b, skv, 1, d)))
    lens = np.array([0, 1, 129, 731], np.int32)
    tq, tk, tv = (_t(np.asarray(a.astype(jnp.float32))) for a in (q, k, v))
    assert tdecode.pv_layout(2, d, hq)["route"] == "mma"
    out, lse = _decode_mma_emulation(tq, tk, tv, lens)
    pallas = jdecode(q, k, v, jnp.asarray(lens), block_k=256,
                     interpret=True)
    _close(out, pallas.astype(jnp.float32), BF16_TOL)
    assert not out[0].any()
    s = np.einsum("bhd,bsd->bhs", _np(tq).astype(np.float64),
                  _np(tk)[:, :, 0].astype(np.float64)) / np.sqrt(d)
    s = np.where(np.arange(skv)[None, None] < lens[:, None, None], s,
                 -np.inf)
    m = s[1:].max(-1, keepdims=True)        # slot 0 has no row
    want = np.log(np.exp(s[1:] - m).sum(-1)) + m[..., 0]
    assert np.isneginf(_np(lse)[0]).all()
    np.testing.assert_allclose(_np(lse)[1:], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("g,bucket,slices", [
    (1, 1, 1), (5, 8, 1), (16, 16, 1), (17, 16, 2), (32, 16, 2),
    (71, 16, 5)])
def test_decode_group_bucket_and_slices_follow_the_kernel(g, bucket, slices):
    """A group above 16 runs the run-time bucket 16 in ceil(g / 16) slices
    of q heads; every (head of a slice, 16 bytes of d, cache row) has one
    owner in its block's P.V layout, at d 64 and 256 and at d 100 (a
    partial last chunk: the chunks past it idle)."""
    assert tdecode.group_bucket(g) == bucket
    assert tdecode.group_slices(g) == slices
    mma = tdecode.pv_layout(2, 256, g)      # bf16 d 256: route "mma"
    assert mma["route"] == "mma" and mma["slices"] == slices
    assert mma["heads"] == tdecode.MAX_GROUP >= min(g, 16)
    for es in (2, 4):
        for d in (64, 100, 250 if es == 2 else 256):
            lay = tdecode.pv_layout(es, d, g)
            assert lay["route"] == "split"
            assert lay["slices"] == slices
            assert lay["D"] == tflash.padded_head_dim(d)
            assert lay["ch"] * lay["ve"] == lay["D"]
            assert lay["chunks"] == -(-d // lay["ve"])
            assert lay["vec"] == (d % lay["ve"] == 0)
            gb = min(g, 16)
            for first in range(0, g, 16):       # each slice's block
                heads = min(16, g - first)
                hg = lay["hg"]
                r = hg // heads if heads < hg else 1
                owners = np.zeros((heads, lay["ch"], tdecode.TILE), int)
                active = min(hg, r * heads)
                for tid in range(tdecode.THREADS):
                    pc, grp = tid % lay["ch"], tid // lay["ch"]
                    if grp >= active or pc >= lay["chunks"]:
                        continue
                    for i in range(lay["hpt"]):
                        h = grp % heads + hg * i
                        if h < heads:
                            owners[h, pc, grp // heads::r] += 1
                assert (owners[:, :lay["chunks"]] == 1).all(), (es, d, g)
                assert (owners[:, lay["chunks"]:] == 0).all()
                if first == 0:
                    assert lay["active"] == active and heads == gb


def test_decode_fp32_at_d256_keeps_one_tile_in_flight():
    """Two fp32 tiles of 64 x 260 words for K and V would take 266 KB;
    bf16 keeps two, on decode_split_kernel at d 250 and on the tensor-core
    kernel at d 256 (two tiles of 64 rows, 144 KB)."""
    assert tdecode.pv_layout(4, 256, 8)["stages"] == 1
    assert tdecode.pv_layout(4, 256, 8)["route"] == "split"
    assert tdecode.pv_layout(2, 250, 8)["stages"] == 2
    lay = tdecode.pv_layout(2, 256, 8)
    assert (lay["route"], lay["stages"]) == ("mma", 2)
    assert lay["smem"] <= tdecode.MAX_SMEM
    assert tdecode.pv_layout(4, 160, 16)["stages"] == 2


# ---------------------------------------------------------------------------
# Mamba-2 SSD at d_state 512.
# ---------------------------------------------------------------------------
def _ssd_inputs(rng, b, s, h, p, n):
    """numpy inputs as tests/test_kernels_ssd.py draws them."""
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.3, (b, s, h)).astype(np.float32),
            -rng.uniform(0.3, 2.0, (h,)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((h,)).astype(np.float32))


@pytest.mark.parametrize("s,chunk", [(128, 64), (100, 128)])
def test_ssd_plain_matches_pallas_at_d_state_512(s, chunk, rng):
    args = _ssd_inputs(rng, 1, s, 2, 16, 512)
    y, st = tssd.ssd_scan(*map(_t, args), chunk=chunk)
    assert st.shape == (1, 2, 16, 512)
    jargs = [jnp.asarray(a) for a in args]
    for wy, ws in (jssd(*jargs, chunk=chunk, interpret=True),
                   jref.ssd_ref(*jargs)):
        _close(y, wy, SSD_TOL)
        _close(st, ws, SSD_TOL)


@pytest.mark.parametrize("dstate", [False, True])
def test_ssd_backward_matches_jax_grad_at_d_state_512(dstate, rng):
    """The closed-form backward against ``jax.grad`` of
    ``repro.kernels.ref.ssd_chunked`` at 1e-5 of each gradient's max-abs
    (tests/test_torch_ssd_backward.py)."""
    b, s, h, p, n, chunk = 1, 96, 2, 16, 512, 32
    args = _ssd_inputs(rng, b, s, h, p, n)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    ds = rng.standard_normal((b, h, p, n)).astype(np.float32) \
        if dstate else None

    def loss(*a):
        y, st = jref.ssd_chunked(*a, chunk=chunk)
        out = jnp.sum(y * dy)
        return out if ds is None else out + jnp.sum(st * ds)
    want = jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in args))
    got = tssd.plain_bwd(*map(_t, args), _t(dy),
                         None if ds is None else _t(ds), chunk=chunk)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(_np(g) - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("dtype,n,p,fwd,bwd", [
    (torch.bfloat16, 512, 64, tssd.SIMT, tssd.SIMT),
    (torch.bfloat16, 256, 64, tssd.TENSOR_CORES, tssd.SIMT),
    (torch.bfloat16, 128, 64, tssd.TENSOR_CORES, tssd.TENSOR_CORES),
    (torch.bfloat16, 272, 32, tssd.SIMT, tssd.SIMT),
    (torch.float32, 512, 64, tssd.SIMT, tssd.SIMT),
    (torch.float32, 1000, 7, tssd.SIMT, tssd.SIMT)])
def test_ssd_designs_take_any_d_state(dtype, n, p, fwd, bwd):
    """Past 256 both CUDA-core designs take any d_state in tiles of
    ``SIMT_STATE_TILE``; the tensor-core designs keep their limits (n <=
    256 forward, 128 backward)."""
    assert tssd.plan(dtype, n, p) == fwd
    assert tssd.bwd_design(dtype, n, p) == bwd
    assert tssd.bwd_plan(dtype, 1, 100, 2, p, n) > 0
    with pytest.raises(ValueError):
        tssd.plan(dtype, 0, p)


# ---------------------------------------------------------------------------
# kernel_cost: the function's work at the real d, group and d_state.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [80, 96, 100, 256, 257, 288, 512, 576])
def test_kernel_cost_counts_the_real_head_dim(d):
    """The bound of a call is the work the Pallas kernel does at its d:
    linear in d, whatever D the card pads it to."""
    bf16 = torch.bfloat16
    for fn in (kernel_cost.flash, kernel_cost.flash_bwd):
        one = fn(8, 256, 256, 32, 32, 1, bf16)
        c = fn(8, 256, 256, 32, 32, d, bf16)
        assert c.ops == d * one.ops
        lse = 4 * 8 * 32 * 256 if fn is kernel_cost.flash_bwd else 0
        assert c.bytes - lse == d * (one.bytes - lse)
    dec = kernel_cost.decode(4, 8, 1, d, 1711, bf16)
    assert dec.ops == 4 * 1711 * 8 * d
    assert dec.bytes == 2 * (2 * 4 * 8 * d + 2 * 1711 * d) + 16


def test_kernel_cost_counts_kv_rows_once_at_any_group():
    """falcon-7b's 71/1: the kv rows are counted once, as the function
    reads them, though the card's five slices of q heads read them five
    times."""
    one = kernel_cost.decode(4, 1, 1, 64, 1711, torch.bfloat16)
    g71 = kernel_cost.decode(4, 71, 1, 64, 1711, torch.bfloat16)
    assert g71.ops == 71 * one.ops
    assert g71.bytes - one.bytes == 2 * 2 * 4 * 70 * 64


def test_kernel_cost_counts_the_real_d_state():
    a = kernel_cost.ssd(1, 512, 8, 64, 512, torch.bfloat16, 256)
    b = kernel_cost.ssd(1, 512, 8, 64, 256, torch.bfloat16, 256)
    q, nc = 256, 2
    pairs = q * (q + 1) // 2
    assert a.ops - b.ops == nc * 256 * (2 * pairs + 8 * 4 * q * 64)
    bw = kernel_cost.ssd_bwd(1, 512, 8, 64, 512, torch.bfloat16, 256, False)
    assert bw.bytes == 2 * (3 * 512 * 8 * 64 + 4 * 512 * 512) + \
        8 * 512 * 8 + 16 * 8


@pytest.mark.parametrize("d,dtype", [
    (100, torch.bfloat16), (99, torch.bfloat16), (104, torch.bfloat16),
    (257, torch.bfloat16), (264, torch.bfloat16), (257, torch.float32),
    (100, torch.float32), (32, torch.float32)],
    ids=["100", "99", "104", "257", "264", "257-f32", "100-f32", "32-f32"])
def test_fake_staged_backward_holds_its_scratch(d, dtype):
    """On fake CUDA tensors (the dry run) the forward and the backward at
    bf16 d 100 and 99 (route ``"wgmma_staged"``) and 257
    (``"wgmma_wide_staged"``) allocate the staged copies of q, k and v (and
    dout in the backward), and in fp32 at 257 and 100 (route ``"wide"``,
    whose 8 dK/dV blocks here split the group of 4 into 4 parts) the
    backward allocates the parts' fp32 partial dK and dV, so the dry run's
    memory peak holds them; each counts one call at ``kernel_cost``'s real
    d (the copy's bytes are the design's, not the function's). At d 104
    and 264 (``"wgmma"``, ``"wgmma_wide"``) and at fp32 d 32 (``"simt"``)
    there is no scratch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.roofline.counter import Recorder
    with FakeTensorMode():
        q = torch.empty(2, 64, 8, d, dtype=dtype, device="cuda")
        kv = torch.empty(2, 64, 2, d, dtype=dtype, device="cuda")
        lse = torch.empty(2, 8, 64, device="cuda")
        with Recorder() as fwd:
            out, lse2 = tflash._kernel_forward(q, kv, kv, True, d ** -0.5,
                                               with_lse=True)
        _, live_fwd = fwd.peak_storages((out, lse2))
        with Recorder() as rec:
            grads = tflash._kernel_backward(q, kv, kv, q, q, lse, True,
                                            d ** -0.5)
        _, live = rec.peak_storages(grads)
    bf16 = dtype == torch.bfloat16
    design = tflash.bwd_design(dtype, d)
    assert design == tflash.fwd_design(dtype, d)
    staged = design in tflash.STAGED_DESIGNS
    assert staged == (bf16 and d in (100, 99, 257))
    ld = tflash.staged_ld(d)
    scratch = 2 * tflash.staged_scratch_numel(2, 64, 64, 8, 2, d)
    assert scratch == 2 * (2 * 2 * 64 * 8 + 2 * 2 * 64 * 2) * ld
    scratch_fwd = 2 * tflash.staged_scratch_numel(2, 64, 64, 8, 2, d,
                                                  forward=True)
    assert scratch_fwd == 2 * (2 * 64 * 8 + 2 * 2 * 64 * 2) * ld
    parts = (design == "wide") * 4 * tflash.wide_parts_numel(2, 64, 8, 2, d)
    assert (parts > 0) == (not bf16 and d > 32)
    if parts:
        assert tflash.simt_wide_kv_parts(2, 64, 8, 2, d) == 4
        assert parts == 4 * 2 * 4 * 2 * 64 * 2 * d
    def alloc(n, dt):
        return [(n, "aten.empty.memory_format", (n // dt.itemsize,), dt)]
    want = alloc(scratch, dtype) if staged else \
        alloc(parts, torch.float32) if parts else []
    want_fwd = alloc(scratch_fwd, dtype) if staged else []
    for got, w in ((live, want), (live_fwd, want_fwd)):
        assert [x for x in got if x[0] >= 1024] == w  # beside the outputs
    assert fwd.kernel_calls() == {"flash_attention": 1}
    assert rec.kernel_calls() == {"flash_attention_bwd": 1}
    assert fwd.kernel_flops == kernel_cost.flash(2, 64, 64, 8, 2, d, dtype,
                                                 True, True).ops
    assert rec.kernel_flops == kernel_cost.flash_bwd(2, 64, 64, 8, 2, d,
                                                     dtype, True).ops


@pytest.mark.parametrize("d", [257, 512, 576])
def test_fake_paths_above_256_count_the_real_head_dim(d):
    """On fake CUDA tensors (the dry run) flash forward, its backward and
    decode at d above 256 check their operands, allocate their outputs and
    count one call each at ``kernel_cost``'s real d, launching nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import ops
    from repro_torch.roofline.counter import Recorder
    bf16 = torch.bfloat16
    before = ops.launch_counts()
    with FakeTensorMode():
        q = torch.empty(2, 64, 8, d, dtype=bf16, device="cuda")
        kv = torch.empty(2, 64, 2, d, dtype=bf16, device="cuda")
        lse = torch.empty(2, 8, 64, device="cuda")
        qd = torch.empty(2, 8, d, dtype=bf16, device="cuda")
        ln = torch.empty(2, dtype=torch.int32, device="cuda")
        with Recorder() as rec:
            out, lse2 = tflash._kernel_forward(q, kv, kv, True, d ** -0.5,
                                               with_lse=True)
            grads = tflash._kernel_backward(q, kv, kv, out, q, lse, True,
                                            d ** -0.5)
            dec, dlse = tdecode.decode_attention(qd, kv, kv, ln,
                                                 return_lse=True)
        with pytest.raises(ValueError, match="do not fit"):
            tdecode.decode_attention(
                torch.empty(2, 8, d - 1, dtype=bf16, device="cuda"), kv, kv,
                ln)
    assert tuple(out.shape) == tuple(q.shape) and tuple(lse2.shape) == \
        (2, 8, 64)
    assert [tuple(g.shape) for g in grads] == [tuple(q.shape),
                                               tuple(kv.shape),
                                               tuple(kv.shape)]
    assert tuple(dec.shape) == (2, 8, d) and tuple(dlse.shape) == (2, 8)
    assert rec.kernel_calls() == {"flash_attention": 1,
                                  "flash_attention_bwd": 1,
                                  "decode_attention": 1}
    assert rec.kernel_flops == (
        kernel_cost.flash(2, 64, 64, 8, 2, d, bf16, True, True).ops +
        kernel_cost.flash_bwd(2, 64, 64, 8, 2, d, bf16, True).ops +
        kernel_cost.decode(2, 8, 2, d, 2 * 64, bf16, True).ops)
    assert ops.launch_counts() == before


# ---------------------------------------------------------------------------
# Smoke-size models with the contract phase's attention, against repro.
# ---------------------------------------------------------------------------
def _override_pair(name):
    over = dict(MODEL_OVERRIDES[name])
    jcfg = jsmoke_config(jget_config("internlm2-1.8b")).replace(
        dtype="float32", num_layers=2, **over)
    cfg = smoke_config(get_config("internlm2-1.8b")).replace(
        dtype="float32", num_layers=2, **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jlm.init_params(jcfg, jax.random.key(1))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module", params=list(MODEL_OVERRIDES))
def override_pair(request):
    return _override_pair(request.param)


def test_override_models_keep_the_overridden_heads(override_pair):
    _, cfg, _, params = override_pair
    wq = params["layers"][0]["mixer"]["wq"]
    assert wq.shape == (cfg.d_model, cfg.num_heads, cfg.resolved_head_dim)
    assert cfg.resolved_head_dim in (64, 96, 256)


def test_override_models_prefill_and_decode_match_jax(override_pair):
    jcfg, cfg, jparams, params = override_pair
    b, s, max_len = 2, 9, 16
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, s + 2)).astype(np.int32)
    jlg, jcaches = jlm.prefill(jparams, jcfg,
                               {"tokens": jnp.asarray(toks[:, :s])},
                               max_len=max_len)
    lg, caches = lm.prefill(params, cfg,
                            {"tokens": torch.as_tensor(toks[:, :s])},
                            max_len=max_len)
    _close(lg, jlg, MODEL_TOL)
    pos = np.array([s, s - 3], np.int32)
    for t in range(2):
        new = toks[:, s + t:s + t + 1]
        jlg, jcaches = jlm.decode_step(jparams, jcfg, jnp.asarray(new),
                                       jcaches, pos=jnp.asarray(pos + t))
        lg, caches = lm.decode_step(params, cfg, torch.as_tensor(new),
                                    caches, pos=torch.as_tensor(pos + t))
        _close(lg, jlg, MODEL_TOL)


def test_override_models_loss_and_grads_match_jax(override_pair):
    jcfg, cfg, jparams, params = override_pair
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 25)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": (rng.random((2, 24)) < 0.85).astype(np.float32)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, batch, remat="full"),
        has_aux=True)(jparams)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(params)]
    loss, _ = lm.loss_fn(tree_unflatten(params, leaves), cfg,
                         {k: torch.from_numpy(v) for k, v in batch.items()},
                         remat="full")
    grads = tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), to_jax_params(grads, cfg)))[0]
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= MODEL_GRAD_TOL * np.abs(w).max(), path
