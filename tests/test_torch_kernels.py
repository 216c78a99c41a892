"""The port's kernels against the JAX package's, on the same inputs.

CPU tests hold each plain PyTorch version (what a kernel wrapper runs for
a CPU tensor) against the JAX package's Pallas kernel in interpret mode and
its jnp oracle, at the tolerances of ``tests/test_kernels_*.py``. The CUDA
kernels themselves are held against their plain versions on the card by
``tests/test_torch_cuda_kernels.py``.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jdecode
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.int8_matmul import int8_matmul as jint8
from repro.kernels.rmsnorm import rmsnorm as jrmsnorm
from repro.kernels.ssd_scan import ssd_scan as jssd
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import int8_matmul as tint8
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trmsnorm
from repro_torch.kernels import ssd_scan as tssd

F32_ATTN_TOL = 2e-6     # tests/test_kernels_attention.py, fp32
NORM_TOL = 1e-5         # tests/test_kernels_quant_norm.py
SSD_TOL = 2e-4          # tests/test_kernels_ssd.py, fp32
INT8_RTOL, INT8_ATOL = 1e-6, 1e-4   # tests/test_kernels_quant_norm.py


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 37, 128), (5, 64), (1, 1, 64)])
@pytest.mark.parametrize("lowp", [False, True])
def test_rmsnorm_plain_matches_jax(shape, lowp, rng):
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    out = trmsnorm.rmsnorm(_t(x), _t(w), 1e-5, lowp=lowp)
    jfn = jref.rmsnorm_lowp if lowp else jref.rmsnorm_ref
    oracle = jfn(jnp.asarray(x), jnp.asarray(w), 1e-5)
    np.testing.assert_allclose(_np(out), _np(oracle), rtol=NORM_TOL,
                               atol=NORM_TOL)
    # the Pallas kernel computes fp32 statistics and drops lowp, which is
    # the same function in fp32
    pallas = jrmsnorm(jnp.asarray(x), jnp.asarray(w), eps=1e-5,
                      block_rows=16, interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), rtol=NORM_TOL,
                               atol=NORM_TOL)


def test_rmsnorm_lowp_bf16_matches_jax(rng):
    """bf16 lowp rounds inv and both products to bf16 in both packages."""
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    oracle = jref.rmsnorm_lowp(xb, jnp.asarray(w))
    out = tref.rmsnorm_lowp(_t(np.asarray(xb.astype(jnp.float32))).to(
        torch.bfloat16), _t(w))
    np.testing.assert_allclose(_np(out), _np(oracle.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def _rmsnorm_warp_emulation(x, w, eps, lowp, aligned):
    """csrc/rmsnorm.cu's order of the fp32 sum of squares, for the launch
    plan ``trmsnorm.plan`` gives: lane t of a row's WPR * 32 lanes sums the
    squares of its chunks (16 bytes, or one element where the row is not
    aligned) in order, a 5-step xor butterfly sums each warp's lanes, the
    warps' sums add in order; then y = (x * inv) * w, and with lowp each
    product rounded to x's dtype."""
    rows, d = x.shape
    vec, nv, wpr, _ = trmsnorm.plan(rows, d, x.element_size(), aligned)
    v = 16 // x.element_size() if vec else 1
    lanes = wpr * 32
    chunks = x.float().reshape(rows, d // v, v)
    out = torch.empty_like(x)
    for r in range(rows):
        part = torch.zeros(lanes)
        for t in range(lanes):
            for c in range(t, d // v, lanes):   # registers, then the stream
                for e in range(v):
                    part[t] = part[t] + chunks[r, c, e] * chunks[r, c, e]
        for off in (16, 8, 4, 2, 1):
            part = part + part[torch.arange(lanes) ^ off]
        ss = torch.zeros(())
        for j in range(wpr):
            ss = ss + part[32 * j]
        inv = torch.rsqrt(ss / d + eps)
        xr = x[r].float()
        if lowp:
            inv_t = inv.to(x.dtype).float()
            y = (xr * inv_t).to(x.dtype).float() * w.to(x.dtype).float()
        else:
            y = xr * inv * w
        out[r] = y.to(x.dtype)
    return out


@pytest.mark.parametrize("d", [64, 100, 768])
@pytest.mark.parametrize("lowp", [False, True])
@pytest.mark.parametrize("aligned", [True, False])
def test_rmsnorm_warp_reduction_emulation_matches_jax(d, lowp, aligned, rng):
    """The kernel's reduction order in fp32, on both load routines (d 100
    in fp32 fills 16-byte chunks; misaligned rows take single elements),
    against ref.rmsnorm_ref / rmsnorm_lowp and the Pallas kernel."""
    x = rng.standard_normal((5, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    out = _rmsnorm_warp_emulation(_t(x), _t(w), 1e-5, lowp, aligned)
    jfn = jref.rmsnorm_lowp if lowp else jref.rmsnorm_ref
    pallas = jrmsnorm(jnp.asarray(x), jnp.asarray(w), eps=1e-5,
                      block_rows=8, interpret=True)
    want = trmsnorm.plain(_t(x), _t(w), 1e-5, lowp)
    for ref in (want, jfn(jnp.asarray(x), jnp.asarray(w), 1e-5), pallas):
        np.testing.assert_allclose(_np(out), _np(ref), rtol=NORM_TOL,
                                   atol=NORM_TOL)


@pytest.mark.parametrize("d", [64, 100, 768])
def test_rmsnorm_lowp_bf16_emulation_matches_ref(d, rng):
    """bf16 lowp on bf16 pairs (each product of two bf16 values rounded
    once) is rmsnorm_lowp's rounding: equal up to inv's last fp32 bits."""
    x = _t(rng.standard_normal((4, d)).astype(np.float32)).to(torch.bfloat16)
    w = _t(rng.standard_normal(d).astype(np.float32))
    out = _rmsnorm_warp_emulation(x, w, 1e-5, True, d % 8 == 0)
    np.testing.assert_allclose(_np(out), _np(tref.rmsnorm_lowp(x, w)),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("element_size", [2, 4])
@pytest.mark.parametrize("aligned", [True, False])
def test_rmsnorm_plan_fits_the_kernel(element_size, aligned):
    """Every plan is a (V, NV, WPR) that csrc/rmsnorm.cu's dispatch
    instantiates (V for 16-byte chunks, 1 for single elements), holds its
    row in registers unless the row is wider than 8 warps x 8 chunks, and
    stays within 256 threads a block; the serve widths hold 3 and 8 chunks
    a lane."""
    src = (Path(trmsnorm.__file__).parents[1] / "csrc" /
           "rmsnorm.cu").read_text()
    instances = set(re.findall(r"launch<T, (V|1), (\d), (\d)>", src))
    assert len(instances) == 15
    for d in list(range(1, 300)) + [768, 1000, 2048, 4096, 8192, 16384,
                                    20000, 65536]:
        for rows in (1, 4, 127, 128, 333, 512, 4096):
            vec, nv, wpr, rpb = trmsnorm.plan(rows, d, element_size,
                                              aligned)
            v = 16 // element_size if vec else 1
            assert vec == (aligned and (d * element_size) % 16 == 0)
            assert ("V" if vec else "1", str(nv), str(wpr)) in instances
            assert nv * wpr * 32 * v >= d or wpr == trmsnorm.MAX_WPR
            assert rpb * wpr * 32 <= 256 and rpb >= 1
            if rows <= 4:
                assert rpb == 1             # the decode tick: a row an SM
    assert trmsnorm.plan(4, 768, 2, True) == (True, 3, 1, 1)
    assert trmsnorm.plan(333, 2048, 2, True)[:3] == (True, 8, 1)


# ---------------------------------------------------------------------------
# Flash (prefill) attention
# ---------------------------------------------------------------------------
# The new archs' heads: internvl2-1b (group 7), stablelm-12b (d 160) and
# llama4-maverick-400b-a17b (group 5), each at its own head_dim.
REAL_HEADS = [(14, 2, 64), (32, 8, 160), (40, 8, 128)]
REAL_IDS = ["internvl2", "stablelm", "llama4"]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 32), (4, 2, 32), *REAL_HEADS],
                         ids=["4-4", "4-2", *REAL_IDS])
def test_flash_plain_matches_jax(causal, hq, hkv, d, rng):
    b, s = 2, 128
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    out = tflash.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    pallas = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, block_q=64, block_k=64, interpret=True)
    oracle = jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(out), _np(want), rtol=F32_ATTN_TOL,
                                   atol=F32_ATTN_TOL)


def test_attention_ref_offset_and_kv_len_match_jax(rng):
    b, sq, skv, hq, hkv, d = 2, 8, 24, 4, 2, 16
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    kv_len = np.array([20, 13], np.int32)
    out = ops.attention(_t(q), _t(k), _t(v), causal=True, q_offset=12,
                        kv_len=_t(kv_len))
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, q_offset=12,
                              kv_len=jnp.asarray(kv_len))
    np.testing.assert_allclose(_np(out), _np(want), rtol=F32_ATTN_TOL,
                               atol=F32_ATTN_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_chunked_matches_jax(causal, dtype, rng):
    b, s, hq, hkv, d = 1, 64, 4, 2, 16
    q = jnp.asarray(rng.standard_normal((b, s, hq, d)), dtype)
    k = jnp.asarray(rng.standard_normal((b, s, hkv, d)), dtype)
    v = jnp.asarray(rng.standard_normal((b, s, hkv, d)), dtype)
    want = jref.attention_chunked(q, k, v, causal=causal, chunk=16)
    tt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    out = tref.attention_chunked(
        *(_t(np.asarray(a.astype(jnp.float32))).to(tt) for a in (q, k, v)),
        causal=causal, chunk=16)
    tol = F32_ATTN_TOL if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(out), _np(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_ops_attention_chunked_impls_match_ref(rng):
    b, s, hq, hkv, d = 1, 32, 4, 2, 16
    q, k, v = (_t(rng.standard_normal(sh).astype(np.float32)) for sh in
               ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    base = ops.attention(q, k, v)
    for impl in ("chunked", "chunked_kvrep"):
        out = ops.attention(q, k, v, impl=impl, chunk=8)
        np.testing.assert_allclose(out.numpy(), base.numpy(), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# Decode attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("skv,hq,hkv,d", [
    (256, 4, 4, 64), (256, 4, 2, 32), *((256, *h) for h in REAL_HEADS)])
def test_decode_plain_matches_jax(skv, hq, hkv, d, rng):
    b = 4
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
        np.testing.assert_allclose(_np(out), _np(want), rtol=F32_ATTN_TOL,
                                   atol=F32_ATTN_TOL)


def test_decode_plain_ignores_rows_past_length(rng):
    b, skv, hkv, hq, d = 2, 64, 2, 4, 16
    q, k, v = (_t(rng.standard_normal(sh).astype(np.float32)) for sh in
               ((b, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    length = torch.tensor([20, 40], dtype=torch.int32)
    out1 = tdecode.decode_attention(q, k, v, length)
    k2, v2 = k.clone(), v.clone()
    k2[:, 40:] = 999.0
    v2[:, 40:] = -999.0
    np.testing.assert_array_equal(
        out1.numpy(), tdecode.decode_attention(q, k2, v2, length).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_lowcast_matches_jax(dtype, rng):
    b, skv, hq, hkv, d = 3, 48, 4, 2, 16
    q = jnp.asarray(rng.standard_normal((b, hq, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((b, skv, hkv, d)), dtype)
    v = jnp.asarray(rng.standard_normal((b, skv, hkv, d)), dtype)
    length = np.array([5, 48, 17], np.int32)
    want = jref.decode_attention_lowcast(q, k, v, jnp.asarray(length))
    tt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    out = ops.decode_attention(
        _t(np.asarray(q)), _t(np.asarray(k.astype(jnp.float32))).to(tt),
        _t(np.asarray(v.astype(jnp.float32))).to(tt), _t(length),
        impl="chunked")
    np.testing.assert_allclose(_np(out), _np(want), rtol=F32_ATTN_TOL,
                               atol=F32_ATTN_TOL)


# ---------------------------------------------------------------------------
# The CUDA kernels' algorithms, emulated in plain PyTorch on the CPU
# ---------------------------------------------------------------------------
LOG2E = 1.4426950408889634
BF16_TOL = 2e-2     # chip_smoke.py KERNEL_TOL[bf16]: a bf16 ulp, P in bf16


def _split_kv_decode(q, k, v, length, split_rows, scale=None):
    """csrc/decode_attention.cu's split-KV algorithm in fp32: per split of
    ``split_rows`` cache rows (tiles of 64) that starts below ``length``,
    an unnormalised partial (m, l, acc) in log2 units; splits at or past
    ``length`` hold nothing; then the combine over the splits below
    ceil(length / split_rows)."""
    b, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    qs = q.float().reshape(b, hkv, g, d) * (scale * LOG2E)
    out = torch.zeros((b, hkv, g, d))
    for bi in range(b):
        n = int(min(max(int(length[bi]), 0), skv))
        nvalid = -(-n // split_rows)
        if nvalid == 0:
            continue                        # length 0: zeros
        parts = []
        for s in range(nvalid):
            r0 = s * split_rows
            m = torch.full((hkv, g), tref.NEG_INF)
            l = torch.zeros((hkv, g))
            acc = torch.zeros((hkv, g, d))
            for t0 in range(r0, min(n, r0 + split_rows), 64):
                t1 = min(n, t0 + 64)        # rows past length never read
                kt = k[bi, t0:t1].float().permute(1, 0, 2)    # (hkv, r, d)
                vt = v[bi, t0:t1].float().permute(1, 0, 2)
                x = torch.einsum("hgd,hrd->hgr", qs[bi], kt)
                m_new = torch.maximum(m, x.amax(-1))
                p = torch.exp2(x - m_new[..., None])
                alpha = torch.exp2(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "hgr,hrd->hgd", p, vt)
                m = m_new
            parts.append((m, l, acc))
        ms, ls, accs = (torch.stack(x) for x in zip(*parts))
        w = torch.exp2(ms - ms.amax(0))
        lsum = (ls * w).sum(0)
        out[bi] = (accs * w[..., None]).sum(0) / torch.where(
            lsum == 0, 1.0, lsum)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


@pytest.mark.parametrize("split_rows", [64, 128, 192])
@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 64), (8, 2, 32), *REAL_HEADS])
def test_split_kv_decode_emulation_matches_ref_and_jax(split_rows, hq, hkv,
                                                       d, rng):
    """Lengths 37 and 130 cut a split mid-way, 0 leaves every split empty,
    256 fills them; whole splits past length hold nothing."""
    b, skv = 4, 256
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    length = np.array([37, 0, 130, 256], np.int32)
    out = _split_kv_decode(_t(q), _t(k), _t(v), _t(length), split_rows)
    ref = tref.decode_attention_ref(_t(q), _t(k), _t(v), _t(length))
    # decode_attention_ref softmaxes an all-masked row (length 0) to the
    # mean of V; the kernels (Pallas and CUDA) give zeros, l == 0 -> 1.
    ref = torch.where(_t(length)[:, None, None] == 0, 0.0, ref)
    pallas = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(length), block_k=128, interpret=True)
    for want in (ref, pallas):
        np.testing.assert_allclose(_np(out), _np(want), rtol=F32_ATTN_TOL,
                                   atol=F32_ATTN_TOL)


def _decode_c_layout():
    """From csrc/decode_attention.cu: the block size, the groups
    ``dispatch_g`` instantiates with the group a constant (``case N:
    return launch<T, D, N, true>``), the buckets it instantiates with the
    group read at run time (``if (g <= N) return launch<T, D, N,
    false>``), and the head dims ``dispatch_d`` instantiates."""
    src = (Path(tdecode.__file__).parents[1] / "csrc" /
           "decode_attention.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src)[1])
    exact = [int(a) for a, b in re.findall(
        r"case (\d+): return launch<T, D, (\d+), true>", src) if a == b]
    run_time = [int(a) for a, b in re.findall(
        r"if \(g <= (\d+)\) return launch<T, D, (\d+), false>", src)
        if a == b]
    dims = [int(x) for x in re.findall(
        r"case (\d+): return dispatch_g<T, \d+>", src)]
    return threads, exact, run_time, dims


@pytest.mark.parametrize("element_size", [2, 4])
def test_decode_layout_owns_every_head_and_row_once(element_size):
    """For every head dim the kernel is instantiated at and every group
    1..16, the P.V ownership of ``pv_layout`` (the arithmetic of the C
    ``Layout`` and the kernel's pc, grp, R, pg, rs) puts each (q head, 16
    bytes of d, cache row of a 64-row tile) under exactly one thread,
    within the heads a thread has registers for (``hpt``, sized for the
    group's bucket), and the bucket's shared memory at its tiles in flight
    (``stages``: two where they fit) fits the 227 KB a block may have.
    Groups 1, 2, 4, 8 and 16 run instantiations where the group is a
    constant, the others one of the buckets 4, 8, 16 that read it at run
    time; a group above 16 the bucket 16. In bf16 at D 256 the split
    instantiation serves the head dims that are not whole 16-byte chunks
    (d 256 takes route ``"mma"``), so it is read there at d 250."""
    threads, exact, run_time, dims = _decode_c_layout()
    assert threads == tdecode.THREADS
    assert exact == [1, 2, 4, 8, 16] and run_time == [4, 8, 16]
    assert max(run_time) == tdecode.MAX_GROUP
    assert tuple(dims) == tdecode.HEAD_DIMS
    for g in range(1, tdecode.MAX_GROUP + 1):   # the bucket that serves g
        assert tdecode.group_bucket(g) == (
            g if g in exact else min(b for b in run_time if b >= g))
    for d in dims:
        for g in range(1, tdecode.MAX_GROUP + 1):
            mma = element_size == 2 and d == tdecode.MAX_HEAD_DIM
            assert (tdecode.pv_layout(element_size, d, g)["route"] ==
                    "mma") == mma
            lay = tdecode.pv_layout(element_size, d - 6 if mma else d, g)
            assert lay["route"] == "split"
            ve, ch, hg, r = (lay[k] for k in ("ve", "ch", "hg", "r_slices"))
            assert ch * ve == lay["D"] == d and hg * ch <= threads
            owners = np.zeros((g, ch, tdecode.TILE), np.int64)
            for tid in range(threads):
                pc, grp = tid % ch, tid // ch
                if grp >= lay["active"]:
                    continue
                for i in range(lay["hpt"]):
                    h = grp % g + hg * i
                    if h < g:
                        owners[h, pc, grp // g::r] += 1
            assert (owners == 1).all(), (element_size, d, g)
            gm = tdecode.group_bucket(g, d)
            stage = element_size * 2 * tdecode.TILE * (d + ve)
            fixed = 4 * (gm * d + gm * tdecode.TILE + threads * ve + 3 * gm)
            assert lay["stages"] * stage + fixed <= 232448
            assert (lay["stages"] == 2) == (2 * stage + fixed <= 232448)
    assert tdecode.group_bucket(17) == tdecode.group_bucket(71) == 16
    with pytest.raises(ValueError):
        tdecode.group_bucket(0)


def test_decode_split_count_depends_on_capacity_alone():
    """The grid is fixed by skv (a CUDA graph can hold the launch): the
    split count takes skv and nothing else, cuts the cache into whole
    64-row tiles with no split wholly past skv, and stays within the
    combine's one split per lane."""
    import inspect
    for fn in (tdecode.split_rows, tdecode.num_splits):
        assert list(inspect.signature(fn).parameters) == ["skv"]
    for skv in list(range(1, 300)) + [740, 1024, 2048, 2049, 4096, 4097,
                                      32768, 65536]:
        rows, n = tdecode.split_rows(skv), tdecode.num_splits(skv)
        assert rows % tdecode.TILE == 0
        assert (n - 1) * rows < skv <= n * rows
        assert 1 <= n <= tdecode.MAX_SPLITS
    # 4 slots x 8 kv heads at the serve run's cache of 740 rows
    assert tdecode.num_splits(740) * 8 * 4 == 384


def _flash_wgmma_emulation(q, k, v, *, causal=True):
    """csrc/flash_attention.cu's bf16 tensor-core algorithm: 64 x 64 tiles,
    fp32 scores from bf16 operands, online softmax in log2 units, P rounded
    to bf16 before P.V (fp32 sums), l from the unrounded P, output rounded
    to bf16 once."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    c = LOG2E / np.sqrt(d)
    qf = q.float().permute(0, 2, 1, 3)                       # (b, hq, sq, d)
    kf = k.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    out = torch.empty((b, hq, sq, d))
    for q0 in range(0, sq, 64):
        qt = qf[:, :, q0:q0 + 64]
        rows = torch.arange(q0, q0 + qt.shape[2])[:, None]
        m = torch.full(qt.shape[:3], tref.NEG_INF)
        l = torch.zeros(qt.shape[:3])
        acc = torch.zeros(qt.shape)
        kv_end = min(skv, q0 + 64) if causal else skv
        for k0 in range(0, kv_end, 64):
            cols = torch.arange(k0, min(k0 + 64, skv))[None, :]
            x = qt @ kf[:, :, k0:k0 + 64].transpose(-1, -2) * c
            if causal:
                x = torch.where(cols > rows, tref.NEG_INF, x)
            m_new = torch.maximum(m, x.amax(-1))
            p = torch.exp2(x - m_new[..., None])
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + \
                p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + 64]
            m = m_new
        out[:, :, q0:q0 + 64] = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def _flash_wgmma_boxes(q, k, v, *, causal=True, round_p=False):
    """csrc/flash_attention.cu's wgmma tiling of a head_dim that is not a
    multiple of 64 (stablelm-12b's 160): each 64-row tile of Q, K and V
    comes in as ceil(d / 64) boxes of 64 columns, the last zero past d (as
    TMA fills what lies past the tensor map); S = Q.K^T in k steps of 16
    up to d; P.V at N = 64 x boxes, whose columns past d must stay zero
    and are never stored. fp32 products; ``round_p`` rounds P to bf16 as
    the P.V operand, as the kernel does."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    n = 64 * -(-d // 64)
    c = LOG2E / np.sqrt(d)

    def boxes(x, rows):                     # (b, h, rows, n), zero past d
        out = torch.zeros((b, x.shape[2], rows, n))
        out[..., :x.shape[1], :d] = x.float().permute(0, 2, 1, 3)
        return out
    qb = boxes(q, -(-sq // 64) * 64)
    kb = boxes(k, -(-skv // 64) * 64).repeat_interleave(g, dim=1)
    vb = boxes(v, -(-skv // 64) * 64).repeat_interleave(g, dim=1)
    out = torch.empty((b, hq, sq, d))
    for q0 in range(0, sq, 64):
        qt = qb[:, :, q0:q0 + 64]
        rows = torch.arange(q0, q0 + 64)[:, None]
        m = torch.full(qt.shape[:3], tref.NEG_INF)
        l = torch.zeros(qt.shape[:3])
        acc = torch.zeros((b, hq, 64, n))
        kv_end = min(skv, q0 + 64) if causal else skv
        for k0 in range(0, kv_end, 64):
            kt, vt = kb[:, :, k0:k0 + 64], vb[:, :, k0:k0 + 64]
            x = torch.zeros((b, hq, 64, 64))
            for kk in range(d // 16):       # box kk // 4, 16 columns each
                col = 64 * (kk // 4) + 16 * (kk % 4)
                x += qt[..., col:col + 16] @ kt[..., col:col + 16].transpose(
                    -1, -2)
            x = x * c
            cols = torch.arange(k0, k0 + 64)[None, :]
            x = torch.where((cols >= skv) | (causal & (cols > rows)),
                            tref.NEG_INF, x)
            m_new = torch.maximum(m, x.amax(-1))
            p = torch.exp2(x - m_new[..., None])
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(-1)
            if round_p:
                p = p.to(torch.bfloat16).float()
            acc = acc * alpha[..., None] + p @ vt
            m = m_new
        assert (acc[..., d:] == 0).all()    # the padded columns, never stored
        rows_here = min(64, sq - q0)
        out[:, :, q0:q0 + rows_here] = (
            acc / torch.where(l == 0, 1.0, l)[..., None])[:, :, :rows_here,
                                                          :d]
    return out.permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq", [64, 100])
def test_flash_d160_box_emulation_matches_ref_and_jax(causal, sq, rng):
    """At stablelm-12b's heads (32/8, d 160), in fp32: three 64-column
    boxes, zero past 160, give attention_ref's and the Pallas kernel's
    result (interpret mode) at the file's fp32 tolerance."""
    b, hq, hkv, d = 1, 32, 8, 160
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sq, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sq, hkv, d)).astype(np.float32)
    out = _flash_wgmma_boxes(_t(q), _t(k), _t(v), causal=causal)
    ref = tref.attention_ref(_t(q), _t(k), _t(v), causal=causal)
    want = [ref]
    if sq % 64 == 0:        # the Pallas kernel asserts whole blocks
        want.append(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, block_q=64, block_k=64,
                           interpret=True))
    for w in want:
        np.testing.assert_allclose(_np(out), _np(w), rtol=F32_ATTN_TOL,
                                   atol=F32_ATTN_TOL)


def test_flash_d160_bf16_emulation_at_serve_shape_within_tolerance(rng):
    """The d 160 tiling with P rounded to bf16, at stablelm-12b's serve
    prefill (sq 333, 32/8 heads), stays within the card's bf16 tolerance
    of attention_ref."""
    b, sq, hq, hkv, d = 1, 333, 32, 8, 160
    q, k, v = (_t(rng.standard_normal(sh).astype(np.float32)).to(
        torch.bfloat16) for sh in ((b, sq, hq, d), (b, sq, hkv, d),
                                   (b, sq, hkv, d)))
    out = _flash_wgmma_boxes(q, k, v, round_p=True)
    want = tref.attention_ref(q, k, v, causal=True)
    np.testing.assert_allclose(_np(out), _np(want), rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_flash_bf16_p_emulation_at_serve_shape_within_tolerance(rng):
    """Rounding P to bf16 (the wgmma kernel's P.V operand) at the serve
    shape, sq 333, 16/8 heads, d 128, stays within the card's bf16
    tolerance of attention_ref."""
    b, sq, hq, hkv, d = 1, 333, 16, 8, 128
    q, k, v = (_t(rng.standard_normal(sh).astype(np.float32)).to(
        torch.bfloat16) for sh in ((b, sq, hq, d), (b, sq, hkv, d),
                                   (b, sq, hkv, d)))
    out = _flash_wgmma_emulation(q, k, v)
    want = tref.attention_ref(q, k, v, causal=True)
    np.testing.assert_allclose(_np(out), _np(want), rtol=BF16_TOL,
                               atol=BF16_TOL)


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------
def _ssd_inputs(rng, b, s, h, p, n):
    """numpy inputs as tests/test_kernels_ssd.py draws them."""
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.3, (b, s, h)).astype(np.float32),
            -rng.uniform(0.3, 2.0, (h,)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((h,)).astype(np.float32))


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 64, 2, 16, 16, 16),
    (2, 128, 3, 32, 64, 32),
    (1, 256, 4, 64, 128, 128),
])
def test_ssd_plain_matches_jax(b, s, h, p, n, chunk, rng):
    """Port's ssd_chunked (the wrapper's CPU path) and ssd_ref against the
    Pallas kernel in interpret mode and the JAX sequential oracle."""
    args = _ssd_inputs(rng, b, s, h, p, n)
    jargs = [jnp.asarray(a) for a in args]
    targs = [_t(a) for a in args]
    y, st = tssd.ssd_scan(*targs, chunk=chunk)
    assert y.dtype == torch.float32 and st.shape == (b, h, p, n)
    y_seq, st_seq = tref.ssd_ref(*targs)
    pallas = jssd(*jargs, chunk=chunk, interpret=True)
    oracle = jref.ssd_ref(*jargs)
    for (wy, ws) in (pallas, oracle):
        for got in ((y, st), (y_seq, st_seq)):
            np.testing.assert_allclose(_np(got[0]), _np(wy), rtol=SSD_TOL,
                                       atol=SSD_TOL)
            np.testing.assert_allclose(_np(got[1]), _np(ws), rtol=SSD_TOL,
                                       atol=SSD_TOL)


def test_ssd_chunked_matches_jax_chunked_bf16(rng):
    """bf16 x, B, C: the same fp32 math and one rounding of y in both
    packages' ssd_chunked (D skip in fp32 before the rounding)."""
    x, dt, A, B, C, D = _ssd_inputs(rng, 2, 96, 3, 16, 32)
    xb, Bb, Cb = (jnp.asarray(a, jnp.bfloat16) for a in (x, B, C))
    wy, ws = jref.ssd_chunked(xb, jnp.asarray(dt), jnp.asarray(A), Bb, Cb,
                              jnp.asarray(D), chunk=32)
    tb = [_t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
          for a in (xb, Bb, Cb)]
    y, st = ops.ssd(tb[0], _t(dt), _t(A), tb[1], tb[2], _t(D), chunk=32)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y), _np(wy.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(st), _np(ws), rtol=SSD_TOL, atol=SSD_TOL)


def test_ssd_chunk_invariance(rng):
    """tests/test_kernels_ssd.py::test_ssd_chunk_invariance on the port."""
    args = [_t(a) for a in _ssd_inputs(rng, 1, 128, 2, 16, 32)]
    y32, st32 = ops.ssd(*args, chunk=32)
    y64, st64 = ops.ssd(*args, chunk=64)
    y128, st128 = ops.ssd(*args, chunk=256)     # one chunk of s
    for y, st in ((y64, st64), (y128, st128)):
        np.testing.assert_allclose(y.numpy(), y32.numpy(), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(st.numpy(), st32.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_ssd_decode_continues_prefill(rng):
    """Prefill state + one ssd_decode_ref step == the full sequence at s,
    in the port, and the step equals the JAX package's."""
    b, s, h, p, n = 1, 64, 2, 16, 16
    x, dt, A, B, C, D = _ssd_inputs(rng, b, s + 1, h, p, n)
    y_full, _ = tref.ssd_ref(*(_t(a) for a in (x, dt, A, B, C, D)))
    _, state = ops.ssd(_t(x[:, :s]), _t(dt[:, :s]), _t(A), _t(B[:, :s]),
                       _t(C[:, :s]), _t(D), chunk=32)
    step = (x[:, s], dt[:, s], A, B[:, s], C[:, s], D)
    y1, st1 = tref.ssd_decode_ref(*(_t(a) for a in step), state)
    np.testing.assert_allclose(y1.numpy(), y_full[:, s].numpy(),
                               rtol=SSD_TOL, atol=SSD_TOL)
    jy1, jst1 = jref.ssd_decode_ref(*(jnp.asarray(a) for a in step),
                                    jnp.asarray(state.numpy()))
    np.testing.assert_allclose(y1.numpy(), _np(jy1), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(st1.numpy(), _np(jst1), rtol=1e-6, atol=1e-6)


def _bf16_pair(v):
    """csrc/ssd_scan.cu's split2: v as hi = bf16(v) and lo = bf16(v - hi),
    both back in fp32."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _bf16_single(v):
    """One bf16 rounding of v, as a pair with a zero lo."""
    return v.to(torch.bfloat16).float(), torch.zeros_like(v)


def _ssd_tc_emulation(x, dt, A, B, C, D, tile=64, split=_bf16_pair):
    """csrc/ssd_scan.cu's tensor-core design: tiles of ``tile`` steps (the
    last padded with dt = 0 and x = B = C = 0), x, B and C in bf16, fp32
    sums of exact products;
    1. per tile, G_c^T = (w x)^T B with w_j = exp(L_last - L_j) dt_j and
       w x as a bf16 hi/lo pair, and a_c = exp(L_last);
    2. H_c = a_c H_{c-1} + G_c, keeping the state entering each tile;
    3. CB = C B^T, M = CB exp(L_t - L_j) dt_j for j <= t as a hi/lo pair,
       y = M x + exp(L_t) C H_{c-1} (H as a hi/lo pair) + D x, rounded
       once to x's dtype.
    ``split`` rounds the operands that carry an fp32 factor."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nt = -(-s // tile)

    def steps(t):       # bf16 operands (dt stays fp32), padded to nt tiles
        t = t.float() if t is dt else t.to(torch.bfloat16).float()
        pad = t.new_zeros((b, nt * tile - s, *t.shape[2:]))
        return torch.cat([t, pad], 1).reshape(b, nt, tile, *t.shape[2:])
    xr, dtr, Br, Cr = steps(x), steps(dt), steps(B), steps(C)
    L = torch.cumsum(dtr * A.float(), dim=2)                  # (b,nt,T,h)
    w = torch.exp(L[:, :, -1:] - L) * dtr
    wx = split(w[..., None] * xr)                        # (b,nt,T,h,p)
    G = sum(torch.einsum("bcjhp,bcjn->bchpn", v, Br) for v in wx)
    a = torch.exp(L[:, :, -1])                                # (b,nt,h)
    H = torch.zeros((b, h, p, n))
    h_in = []
    for c in range(nt):
        h_in.append(H)
        H = H * a[:, c, :, None, None] + G[:, c]
    h_in = torch.stack(h_in, 1)                               # (b,nt,h,p,n)
    tri = torch.tril(torch.ones((tile, tile), dtype=torch.bool))
    tri = tri[None, None, :, :, None]
    cb = torch.einsum("bctn,bcjn->bctj", Cr, Br)
    logdec = torch.where(tri, L[:, :, :, None] - L[:, :, None], 0.0)
    M = torch.where(tri, cb[..., None] * torch.exp(logdec)
                    * dtr[:, :, None], 0.0)                  # (b,nt,t,j,h)
    y_intra = sum(torch.einsum("bctjh,bcjhp->bcthp", m, xr)
                  for m in split(M))
    y_inter = sum(torch.einsum("bctn,bchpn->bcthp", Cr, hh)
                  for hh in split(h_in))
    y = (y_intra + torch.exp(L)[..., None] * y_inter) + \
        xr * D.float()[:, None]
    return y.reshape(b, nt * tile, h, p)[:, :s].to(x.dtype), H


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 64, 2, 16, 16, 16),
    (2, 128, 3, 32, 64, 32),
    (1, 256, 4, 64, 128, 128),
])
def test_ssd_tc_emulation_matches_ref_and_jax(b, s, h, p, n, chunk, rng):
    """The tensor-core decomposition with its operand roundings, on fp32
    inputs whose x, B and C are bf16 values (the design's operands),
    against both packages' ssd_ref, the port's ssd_chunked and the Pallas
    kernel in interpret mode, at tests/test_kernels_ssd.py's 2e-4."""
    x, dt, A, B, C, D = _ssd_inputs(rng, b, s, h, p, n)
    x, B, C = (_np(_t(a).to(torch.bfloat16)) for a in (x, B, C))
    args = (x, dt, A, B, C, D)
    targs = [_t(a) for a in args]
    jargs = [jnp.asarray(a) for a in args]
    y, st = _ssd_tc_emulation(*targs)
    assert y.dtype == torch.float32 and st.shape == (b, h, p, n)
    for wy, ws in (tref.ssd_ref(*targs),
                   tref.ssd_chunked(*targs, chunk=chunk),
                   jssd(*jargs, chunk=chunk, interpret=True),
                   jref.ssd_ref(*jargs)):
        np.testing.assert_allclose(_np(y), _np(wy), rtol=SSD_TOL,
                                   atol=SSD_TOL)
        np.testing.assert_allclose(_np(st), _np(ws), rtol=SSD_TOL,
                                   atol=SSD_TOL)


@pytest.mark.parametrize("s", [101, 512, 1024])
def test_ssd_tc_emulation_bf16_at_serve_shape(s, rng):
    """mamba2-130m's SSD layer (b 1, h 24, p 64, n 128) in bf16, at the
    serve run's ragged and multi-chunk lengths: y within the card's bf16
    tolerance of ssd_chunked (chunk 256), the fp32 state within 2e-4."""
    args = [_t(a) for a in _ssd_inputs(rng, 1, s, 24, 64, 128)]
    for i in (0, 3, 4):                                 # x, B, C
        args[i] = args[i].to(torch.bfloat16)
    y, st = _ssd_tc_emulation(*args)
    wy, ws = tref.ssd_chunked(*args, chunk=256)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y), _np(wy), rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(_np(st), _np(ws), rtol=SSD_TOL, atol=SSD_TOL)


def test_ssd_one_bf16_rounding_would_break_the_state_tolerance(rng):
    """Why the design splits w x, M and H_{c-1} into hi/lo pairs: rounded
    once to bf16 instead, the state at the serve shape leaves 2e-4."""
    args = [_t(a) for a in _ssd_inputs(rng, 1, 512, 24, 64, 128)]
    for i in (0, 3, 4):
        args[i] = args[i].to(torch.bfloat16)
    _, st = _ssd_tc_emulation(*args, split=_bf16_single)
    _, ws = tref.ssd_chunked(*args, chunk=256)
    assert ((st - ws).abs() > SSD_TOL + SSD_TOL * ws.abs()).any()


@pytest.mark.parametrize("dtype,n,p,design", [
    (torch.bfloat16, 128, 64, tssd.TENSOR_CORES),     # mamba2-130m
    (torch.bfloat16, 16, 16, tssd.TENSOR_CORES),      # mamba2 smoke
    (torch.bfloat16, 256, 64, tssd.TENSOR_CORES),     # the largest it takes
    (torch.bfloat16, 64, 32, tssd.TENSOR_CORES),
    (torch.bfloat16, 24, 64, tssd.SIMT),              # n not a multiple of 16
    (torch.bfloat16, 128, 24, tssd.SIMT),             # p not a multiple of 16
    (torch.bfloat16, 128, 128, tssd.SIMT),            # p past 64
    (torch.bfloat16, 1, 8, tssd.SIMT),
    (torch.float32, 128, 64, tssd.SIMT),
    (torch.float32, 16, 16, tssd.SIMT),
    (torch.float32, 256, 200, tssd.SIMT),
])
def test_ssd_plan_routes_by_dtype_and_shape(dtype, n, p, design):
    assert tssd.plan(dtype, n, p) == design


@pytest.mark.parametrize("dtype,n,p,exc", [
    (torch.bfloat16, 0, 64, ValueError),
    (torch.float32, 0, 64, ValueError),
    (torch.float32, -1, 16, ValueError),
    (torch.float16, 128, 64, TypeError),
])
def test_ssd_plan_raises_where_no_design_fits(dtype, n, p, exc):
    """A call no design takes raises before any launch; there is no
    fallback to the plain version for a CUDA tensor."""
    with pytest.raises(exc):
        tssd.plan(dtype, n, p)


def test_ssd_tc_limits_match_the_kernel():
    """The wrapper's limits and tile are the tensor-core kernels' own."""
    src = (Path(tssd.__file__).parents[1] / "csrc" /
           "ssd_scan.cu").read_text()
    tc = src[src.index("namespace tc {"):]
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", tc)}
    assert (consts["kT"], consts["kMaxN"], consts["kMaxP"]) == \
        (tssd.TILE, tssd.TC_MAX_STATE, tssd.TC_MAX_HEADDIM)
    assert "design == 1 && dtype == kBF16" in src
    assert tssd.TENSOR_CORES == 1 and tssd.SIMT == 0


@pytest.mark.parametrize("s,chunk", [(40, 32), (0, 32)])
def test_ops_ssd_refuses_what_jax_refuses(s, chunk, rng):
    """s = 40 at chunk 32 is neither <= chunk nor a multiple of it: the
    JAX wrappers assert, the port raises ValueError."""
    args = _ssd_inputs(rng, 1, s, 2, 16, 16)
    with pytest.raises(ValueError):
        ops.ssd(*(_t(a) for a in args), chunk=chunk)
    if s:
        with pytest.raises(AssertionError):
            jref.ssd_chunked(*(jnp.asarray(a) for a in args), chunk=chunk)


# ---------------------------------------------------------------------------
# int8 W8A8 matmul
# ---------------------------------------------------------------------------
def _int8_inputs(rng, m, k, n):
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    xq, sx = jref.quantize_int8(jnp.asarray(x), axis=1)
    wq, sw = jref.quantize_int8(jnp.asarray(w), axis=0)
    return xq, sx, wq, sw


@pytest.mark.parametrize("m,k,n", [(64, 128, 64), (128, 512, 256),
                                   (256, 256, 128)])
def test_int8_matmul_plain_matches_jax(m, k, n, rng):
    jargs = _int8_inputs(rng, m, k, n)
    out = ops.int8_matmul(*(_t(a) for a in jargs))
    assert out.dtype == torch.float32 and out.shape == (m, n)
    pallas = jint8(*jargs, block_m=64, block_n=64, block_k=128,
                   interpret=True)
    oracle = jref.int8_matmul_ref(*jargs)
    for want in (pallas, oracle):
        np.testing.assert_allclose(out.numpy(), _np(want), rtol=INT8_RTOL,
                                   atol=INT8_ATOL)
    # float64 holds the int32 sums exactly: the same bits as int32 -> fp32
    np.testing.assert_array_equal(out.numpy(), np.asarray(oracle))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_ragged_shape_and_dtype(out_dtype, rng):
    """Any (m, k, n), as the reference takes; bf16 is the fp32 result
    rounded once."""
    jargs = _int8_inputs(rng, 7, 13, 5)
    out = tint8.int8_matmul(*(_t(a) for a in jargs), out_dtype=out_dtype)
    want = np.asarray(jref.int8_matmul_ref(*jargs))
    assert out.dtype == out_dtype
    np.testing.assert_array_equal(
        out.float().numpy(), _t(want).to(out_dtype).float()
        .numpy())


def _byte_perm(x, y, sel):
    """PTX prmt (CUDA __byte_perm) on uint32 arrays: byte i of the result
    is byte (sel >> 4 i) & 7 of the 8 bytes y:x."""
    pool = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint32)
    for i in range(4):
        b = (sel >> (4 * i)) & 7
        byte = (pool >> np.uint64(8 * b)) & np.uint64(0xFF)
        out |= (byte.astype(np.uint32) << np.uint32(8 * i))
    return out


def _transpose4x4(r0, r1, r2, r3):
    """csrc/int8_matmul.cu::transpose4x4."""
    t0, t1 = _byte_perm(r0, r1, 0x5140), _byte_perm(r0, r1, 0x7362)
    t2, t3 = _byte_perm(r2, r3, 0x5140), _byte_perm(r2, r3, 0x7362)
    return (_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632))


@pytest.mark.parametrize("k,n", [(4, 4), (8, 16), (128, 128), (12, 36)])
def test_int8_byte_perm_transpose_equals_w_t(k, n, rng):
    """Words of 4 columns from 4 consecutive k rows, turned by the 8 byte
    permutes, are the words of 4 k of each column: w.T, bit for bit."""
    w = rng.integers(-128, 128, (k, n), dtype=np.int8)
    words = w.view(np.uint32).reshape(k // 4, 4, n // 4)   # [kw, row, nq]
    cols = _transpose4x4(*(words[:, q] for q in range(4)))  # [j][kw, nq]
    wt = np.empty((n, k), np.int8)
    for j in range(4):
        wt[j::4] = cols[j].T.copy().view(np.int8).reshape(n // 4, k)
    np.testing.assert_array_equal(wt, w.T)


def _int8_tiled_emulation(x_q, sx, w_q, sw, bm, bn, out_dtype, order=1):
    """csrc/int8_matmul.cu's sums: (bm x bn) tiles of x_q.w_q, zero-padded
    to the tile and to k steps of 128, each step's products summed in int32
    as the tensor cores do (k 32 at a time), the steps in ``order``; then
    the fp32 epilogue (acc * sx) * sw, rounded once to out_dtype."""
    m, k = x_q.shape
    n = w_q.shape[1]
    kp = -(-k // 128) * 128
    mp, np_ = -(-m // bm) * bm, -(-n // bn) * bn
    xp = np.zeros((mp, kp), np.int32)
    wp = np.zeros((kp, np_), np.int32)
    xp[:m, :k], wp[:k, :n] = x_q, w_q
    acc = np.zeros((mp, np_), np.int32)
    for m0 in range(0, mp, bm):
        for n0 in range(0, np_, bn):
            tile = np.zeros((bm, bn), np.int32)
            for k0 in list(range(0, kp, 128))[::order]:
                for kk in range(k0, k0 + 128, 32):
                    tile += xp[m0:m0 + bm, kk:kk + 32] @ \
                        wp[kk:kk + 32, n0:n0 + bn]
            acc[m0:m0 + bm, n0:n0 + bn] = tile
    out = (acc[:m, :n].astype(np.float32) * sx[:, None]) * sw[None, :]
    return torch.from_numpy(out).to(out_dtype)


@pytest.mark.parametrize("tile", range(len(tint8.TILES)))
@pytest.mark.parametrize("m,k,n", [(7, 13, 5), (65, 100, 130),
                                   (33, 300, 17), (70, 256, 144)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_tiled_int32_sums_match_ref_bit_for_bit(tile, m, k, n,
                                                     out_dtype, rng):
    """Every tile, at ragged k and n, the k steps summed forwards or
    backwards (as a split of k would): int32 sums are exact, so the result
    is ref.int8_matmul_ref's bit for bit."""
    x_q = rng.integers(-128, 128, (m, k), dtype=np.int8)
    w_q = rng.integers(-128, 128, (k, n), dtype=np.int8)
    sx = rng.uniform(0, 1 / 127, m).astype(np.float32)
    sw = rng.uniform(0, 1 / 127, n).astype(np.float32)
    want = tint8.plain(*(_t(a) for a in (x_q, sx, w_q, sw)), out_dtype)
    bm, bn = tint8.TILES[tile]
    for order in (1, -1):
        out = _int8_tiled_emulation(x_q, sx, w_q, sw, bm, bn, out_dtype,
                                    order)
        torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_int8_int32_sums_exact_at_extremes():
    """All -128 operands at k 8192: sums of 2^27, exact in int32 and in
    the float64 of the plain version alike."""
    k = 8192
    x_q = np.full((3, k), -128, np.int8)
    w_q = np.full((k, 2), -128, np.int8)
    w_q[:, 1] = 127
    sx, sw = np.ones(3, np.float32), np.ones(2, np.float32)
    out = _int8_tiled_emulation(x_q, sx, w_q, sw, 64, 64, torch.float32)
    assert out[0, 0] == 2 ** 27 and out[0, 1] == -128 * 127 * k
    torch.testing.assert_close(out, tint8.plain(
        *(_t(a) for a in (x_q, sx, w_q, sw))), rtol=0, atol=0)


def test_int8_tiles_match_the_kernel_dispatch():
    """TILES, the wrapper's tile codes, are the kernel's: case i launches
    64 * WGS rows x BN columns."""
    src = (Path(tint8.__file__).parents[1] / "csrc" /
           "int8_matmul.cu").read_text()
    cases = re.findall(r"case (\d+): return launch<(\d+), (\d+), \d+, T>",
                       src)
    assert [(64 * int(wgs), int(bn)) for _, wgs, bn in cases] == \
        list(tint8.TILES)
    assert [int(c) for c, _, _ in cases] == list(range(len(tint8.TILES)))


def test_int8_plan_covers_every_tile_and_route():
    """On 132 SMs the card's test shapes reach every tile; 16-byte loads
    need k and n multiples of 16 and both operands aligned."""
    sms, seen = 132, set()
    for (m, k, n), vec in [((512, 1024, 512), True), ((333, 2048, 8192), True),
                           ((4, 2048, 8192), True), ((1, 64, 16), True),
                           ((129, 48, 80), True), ((333, 2048, 512), True),
                           ((150, 1024, 5120), True),
                           ((100, 1024, 5120), True), ((7, 13, 5), False),
                           ((65, 100, 130), False), ((300, 1000, 300), False),
                           ((333, 1000, 8200), False),
                           ((150, 1000, 5128), False),
                           ((100, 1000, 5128), False)]:
        got_vec, tile = tint8.plan(m, k, n, 0, 0, sms)
        assert got_vec == vec
        seen.add(tile)
        assert not tint8.plan(m, k, n, 1, 0, sms)[0]     # x_q one byte off
        assert not tint8.plan(m, k, n, 0, 17, sms)[0]    # w_q off
    assert seen == set(range(len(tint8.TILES)))
    # The serve-size shapes of chip_smoke.py: one wave of the largest tile,
    # and the smallest tile where no tile fills half the card.
    assert tint8.plan(333, 2048, 8192, 0, 0, sms)[1] == 0
    assert tint8.plan(512, 1024, 512, 0, 0, sms)[1] == len(tint8.TILES) - 1


# ---------------------------------------------------------------------------
# int8 quantization
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axis", [-1, -2, 0])
def test_quantize_int8_matches_jax(axis, rng):
    x = rng.standard_normal((6, 5, 8)).astype(np.float32)
    x[1] = 0.0   # an all-zero slab takes scale 1
    q, s = ops.quantize_int8(_t(x), axis=axis)
    jq, js = jref.quantize_int8(jnp.asarray(x), axis=axis)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)


# ---------------------------------------------------------------------------
# Dispatch: no quiet fallback.
# ---------------------------------------------------------------------------
def test_cpu_calls_launch_no_kernel(rng):
    ops.reset_launches()
    x = _t(rng.standard_normal((3, 64)).astype(np.float32))
    ops.rmsnorm(x, torch.ones(64))
    ops.ssd(*(_t(a) for a in _ssd_inputs(rng, 1, 8, 2, 16, 16)), chunk=8)
    ops.int8_matmul(*(_t(a) for a in _int8_inputs(rng, 4, 8, 4)))
    assert ops.launch_counts() == {"rmsnorm": 0, "rmsnorm_bwd": 0,
                                   "flash_attention": 0,
                                   "flash_attention_bwd": 0,
                                   "decode_attention": 0, "ssd_scan": 0,
                                   "ssd_scan_bwd": 0, "int8_matmul": 0}


def test_wrappers_refuse_other_devices():
    x = torch.zeros((2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        trmsnorm.rmsnorm(x, torch.ones(16, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tssd.ssd_scan(torch.zeros((1, 4, 2, 16), device="meta"), *(
            torch.zeros(sh, device="meta") for sh in
            ((1, 4, 2), (2,), (1, 4, 16), (1, 4, 16), (2,))))
    with pytest.raises(ValueError, match="unsupported device"):
        tint8.int8_matmul(*(torch.zeros(sh, dtype=dt, device="meta") for
                            sh, dt in (((2, 4), torch.int8),
                                       ((2,), torch.float32),
                                       ((4, 3), torch.int8),
                                       ((3,), torch.float32))))
