"""The SSD backward on the CPU, against ``jax.grad`` of the JAX package.

The JAX package has no backward kernel for the SSD scan: it trains through
``jax.grad`` of ``repro.kernels.ref.ssd_chunked``. The port's closed-form
plain backward (``ref.ssd_chunked_bwd_ref``) and tile-for-tile emulations
of both designs of ``csrc/ssd_scan_bwd.cu`` are held here to that
gradient, in fp32 on the same numpy inputs, leaf by leaf at 1e-5 of the
gradient's max-abs, and to float64 autograd of the port's ``ssd_chunked``
at the same tolerance: the CUDA-core design (its four launches, its 64-step
tiles, its chunks of p and n and the order of its partial sums over them,
over the heads, batches and tiles) and the tensor-core design (its state
path as bf16 hi/lo pairs, the hi/lo splits of its operands with an fp32
factor, dy x^T scaled by dt, W and the state terms of dB and dC summed over
each block's group of heads in order, then over the groups).
``SSDScanFunction`` is held in float64 by
``torch.autograd.gradcheck``, and the wiring of the card path (the
Function runs the forward kernel, then the backward kernel) is checked
with the device test monkeypatched, as the kernels cannot run here.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd

TOL = 1e-5
CU = Path(tssd.__file__).resolve().parents[1] / "csrc" / "ssd_scan_bwd.cu"
NAMES = ("x", "dt", "A", "B", "C", "D")


def _inputs(b, s, h, p, n, seed=0, dstate=True):
    rng = np.random.default_rng(seed)
    ins = (rng.standard_normal((b, s, h, p)),
           0.01 + 0.29 * rng.random((b, s, h)),
           -(0.3 + 1.7 * rng.random(h)),
           rng.standard_normal((b, s, n)),
           rng.standard_normal((b, s, n)),
           rng.standard_normal(h),
           rng.standard_normal((b, s, h, p)),
           rng.standard_normal((b, h, p, n)) if dstate else None)
    return [None if a is None else a.astype(np.float32) for a in ins]


def _jax_grads(ins, chunk):
    *args, dy, ds = ins

    def loss(*a):
        y, st = jref.ssd_chunked(*a, chunk=chunk)
        out = jnp.sum(y * dy)
        return out if ds is None else out + jnp.sum(st * ds)
    return [np.asarray(g) for g in
            jax.grad(loss, argnums=tuple(range(6)))(*args)]


def _f64_grads(ins, chunk):
    """float64 autograd through the port's plain forward."""
    *args, dy, ds = ins
    leaves = [torch.from_numpy(a).double().requires_grad_(True)
              for a in args]
    y, st = tref.ssd_chunked(*leaves, chunk=chunk)
    loss = (y * torch.from_numpy(dy).double()).sum()
    if ds is not None:
        loss = loss + (st * torch.from_numpy(ds).double()).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _torch(ins):
    return [None if a is None else torch.from_numpy(a) for a in ins]


def _bf16_valued(ins):
    """x, B, C and dy rounded to bf16 values (kept in fp32): the operands
    the tensor-core design takes, whose products it takes exactly."""
    return [torch.from_numpy(a).to(torch.bfloat16).float().numpy()
            if i in (0, 3, 4, 6) else a for i, a in enumerate(ins)]


def _check(got, ins, chunk):
    want = _jax_grads(ins, chunk)
    truth = _f64_grads(ins, chunk)
    for name, g, w, t in zip(NAMES, got, want, truth):
        g = g.detach().double().numpy()
        assert g.shape == w.shape, name
        err = np.abs(g - w).max()
        assert err <= TOL * np.abs(w).max(), (name, "jax.grad", err)
        err = np.abs(g - t).max()
        assert err <= TOL * np.abs(t).max(), (name, "float64", err)


# (b, s, h, p, n, chunk): s <= chunk; s a multiple of the chunk; neither s
# nor p nor n a multiple of the kernel's tile or chunks.
CASES = [(2, 40, 3, 16, 32, 64), (2, 96, 3, 16, 32, 32),
         (1, 128, 2, 20, 40, 64), (2, 101, 2, 8, 16, 128),
         (1, 192, 2, 24, 33, 192)]


@pytest.mark.parametrize("dstate", [False, True], ids=["dstate0", "dstate"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", CASES)
def test_ssd_bwd_ref_matches_jax_grad(b, s, h, p, n, chunk, dstate):
    ins = _inputs(b, s, h, p, n, seed=s, dstate=dstate)
    got = tref.ssd_chunked_bwd_ref(*_torch(ins), chunk=chunk)
    _check(got, ins, chunk)


# ---------------------------------------------------------------------------
# csrc/ssd_scan_bwd.cu, launch for launch.
# ---------------------------------------------------------------------------
KT, KPC, KNC = tssd.BWD_TILE, 16, 32     # the tile, chunks of p and of n
KNT = tssd.SIMT_STATE_TILE              # columns of n a B, C tile


def ssd_bwd_emulated(x, dt, A, B, C, D, dy, dstate):
    """The four launches of ``repro_ssd_scan_bwd`` in fp32, vectorized over
    (batch, tile, head) where the kernels run blocks in parallel and in
    loops where a block walks chunks: (1) the tile states G, Gd and decays;
    (2) the pass over the tiles; (3) the local gradients of each tile and
    head, p in chunks of KPC and n in chunks of KNC, each sum over chunks
    taken in the kernel's order, and past KNT columns of n the sums over n
    (K = C B^T, B dS) taken tile by tile of KNT, as the kernel walks B and
    C; (4) dB, dC over the heads and dA, dD over batches and tiles, in
    order."""
    f = lambda t: t.detach().to(torch.float32)
    b, s, h, p = x.shape
    n = B.shape[-1]
    nt = -(-s // KT)
    pad = nt * KT - s

    def tiles(t):           # zero past s, then (b, nt, KT, ...)
        t = torch.nn.functional.pad(f(t), [0, 0] * (t.dim() - 2) + [0, pad])
        return t.reshape(b, nt, KT, *t.shape[2:])
    xr, yr, dtr, Br, Cr = map(tiles, (x, dy, dt, B, C))
    Af, Df = f(A), f(D)
    L = torch.cumsum(dtr * Af, dim=2)                       # (b, nt, KT, h)
    last = L[:, :, -1]
    eL = torch.exp(L).permute(0, 1, 3, 2)                   # (b, nt, h, KT)
    wl = torch.exp(last[:, :, None] - L).permute(0, 1, 3, 2)
    decay = torch.exp(last)                                 # (b, nt, h)
    dts = dtr.permute(0, 1, 3, 2)
    u = dtr[..., None] * xr                                 # (b, nt, KT, h, p)

    # 1. G, Gd (b, nt, h, p, n)
    G = torch.einsum("bcjhq,bcjn->bchqn", (wl * dts).permute(0, 1, 3, 2)
                     [..., None] * xr, Br)
    Gd = torch.einsum("bcthq,bctn->bchqn", eL.permute(0, 1, 3, 2)
                      [..., None] * yr, Cr)
    # 2. the pass, in place
    hv = torch.zeros((b, h, p, n))
    dv = torch.zeros_like(hv) if dstate is None else f(dstate)
    for c in range(nt):
        g = G[:, c].clone()
        G[:, c] = hv
        hv = hv * decay[:, c, :, None, None] + g
    for c in reversed(range(nt)):
        g = Gd[:, c].clone()
        Gd[:, c] = dv
        dv = dv * decay[:, c, :, None, None] + g
    Hin, dSo = G, Gd

    # 3. the local kernel
    ntiles = [slice(n0, n0 + KNT) for n0 in range(0, n, KNT)]
    K = sum(torch.einsum("bctn,bcjn->bctj", Cr[..., m], Br[..., m])
            for m in ntiles)[:, :, None]                    # (b,nt,1,t,j)
    P = torch.zeros((b, nt, h, KT, KT))
    ddp = torch.zeros((b, nt, h))
    for p0 in range(0, p, KPC):
        q = slice(p0, p0 + KPC)
        P = P + torch.einsum("bcthq,bcjhq->bchtj", yr[..., q], u[..., q])
        ddp = ddp + torch.einsum("bcthq,bcthq->bch", yr[..., q], xr[..., q])
    tri = torch.tril(torch.ones((KT, KT), dtype=torch.bool))
    Lh = L.permute(0, 1, 3, 2)
    E = torch.where(tri, torch.exp(torch.where(
        tri, Lh[..., :, None] - Lh[..., None, :], 0.0)), 0.0)
    KE, EP = K * E, E * P
    Q = KE * P
    dli = ((torch.cumsum(Q, -1) - Q) * tri).sum(-2)         # (b,nt,h,k)

    dx = torch.zeros_like(xr)
    xdu = torch.zeros((b, nt, h, KT))
    for p0 in range(0, p, KPC):
        q = slice(p0, p0 + KPC)
        a1 = torch.einsum("bchtj,bcthq->bchjq", KE, yr[..., q])
        a2 = sum(torch.einsum("bcjn,bchqn->bchjq", Br[..., m],
                              dSo[:, :, :, q, m]) for m in ntiles)
        du = a1 + wl[..., None] * a2                        # (b,nt,h,j,q)
        dx[..., q] = (dts[..., None] * du + Df[:, None, None] *
                      yr[..., q].permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)
        xdu = xdu + (xr[..., q].permute(0, 1, 3, 2, 4) * du).sum(-1)

    dCh = torch.zeros((b, nt, h, KT, n))
    dBh = torch.zeros_like(dCh)
    iy = torch.zeros((b, nt, h, KT))
    rr = torch.zeros_like(iy)
    hds = torch.zeros((b, nt, h))
    for n0 in range(0, n, KNC):
        m = slice(n0, n0 + KNC)
        aC = torch.einsum("bchtj,bcjm->bchtm", EP, Br[..., m])
        aB = torch.einsum("bchtj,bctm->bchjm", EP, Cr[..., m])
        hy = torch.zeros_like(aC)
        su = torch.zeros_like(aB)
        for p0 in range(0, p, KPC):
            q = slice(p0, p0 + KPC)
            hy = hy + torch.einsum("bcthq,bchqm->bchtm", yr[..., q],
                                   Hin[:, :, :, q, m])
            su = su + torch.einsum("bcjhq,bchqm->bchjm", u[..., q],
                                   dSo[:, :, :, q, m])
            hds = hds + (Hin[:, :, :, q, m] * dSo[:, :, :, q, m]).sum((-1, -2))
        dCh[..., m] = aC + eL[..., None] * hy
        dBh[..., m] = aB + wl[..., None] * su
        iy = iy + eL * (Cr[:, :, None, :, m] * hy).sum(-1)
        rr = rr + wl * (Br[:, :, None, :, m] * su).sum(-1)
    suffix = torch.flip(torch.cumsum(torch.flip(iy, (-1,)), -1), (-1,))
    dl = dli + suffix + (decay * hds)[..., None] + torch.cumsum(rr, -1) - rr
    ddt = (xdu + Af[:, None] * dl).permute(0, 1, 3, 2)      # (b,nt,KT,h)
    partA = (dts * dl).sum(-1)                              # (b, nt, h)

    # 4. the reduction
    dB = torch.zeros((b, nt, KT, n))
    dC = torch.zeros_like(dB)
    for hh in range(h):
        dB = dB + dBh[:, :, hh]
        dC = dC + dCh[:, :, hh]
    dA = torch.zeros(h)
    dD = torch.zeros(h)
    for bi in range(b):
        for c in range(nt):
            dA = dA + partA[bi, c]
            dD = dD + ddp[bi, c]
    cut = lambda t: t.reshape(b, nt * KT, *t.shape[3:])[:, :s]
    return (cut(dx).to(x.dtype), cut(ddt), dA, cut(dB).to(B.dtype),
            cut(dC).to(C.dtype), dD)


@pytest.mark.parametrize("dstate", [False, True], ids=["dstate0", "dstate"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", CASES)
def test_ssd_bwd_emulation_matches_jax_grad(b, s, h, p, n, chunk, dstate):
    ins = _inputs(b, s, h, p, n, seed=s, dstate=dstate)
    got = ssd_bwd_emulated(*_torch(ins))
    _check(got, ins, chunk)


def test_ssd_bwd_emulation_at_the_training_heads():
    """mamba2-130m's head dim and d_state (p 64, n 128: four chunks of p,
    four of n) over two tiles and a ragged third, against the plain
    backward."""
    ins = _inputs(1, 150, 2, 64, 128, seed=7)
    t = _torch(ins)
    got = ssd_bwd_emulated(*t)
    want = tref.ssd_chunked_bwd_ref(*t, chunk=150)
    for name, g, w in zip(NAMES, got, want):
        err = (g - w).abs().max().item()
        assert err <= TOL * w.abs().max().item(), (name, err)


@pytest.mark.parametrize("n", [300, 512])
def test_ssd_bwd_emulation_walks_d_state_in_tiles(n):
    """d_state past one tile of B and C (300: a ragged second tile; 512:
    two whole ones), the final state's gradient nonzero, against jax.grad
    and float64 autograd."""
    ins = _inputs(1, 70, 2, 16, n, seed=n)
    _check(ssd_bwd_emulated(*_torch(ins)), ins, 128)


def test_ssd_bwd_emulation_constants_match_the_kernel():
    src = CU.read_text()
    for name, value in (("kT", KT), ("kPC", KPC), ("kNC", KNC),
                        ("kNT", tssd.SIMT_STATE_TILE)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name


def test_ssd_bwd_ref_rounds_once_in_bf16():
    """bf16 inputs: the plain backward sums in fp32 from the bf16 values
    and rounds dx, dB and dC once; ddt, dA and dD stay fp32."""
    ins = _torch(_inputs(1, 40, 2, 16, 32, seed=3))
    low = [a.to(torch.bfloat16) if i in (0, 3, 4, 6) else a
           for i, a in enumerate(ins)]
    got = tref.ssd_chunked_bwd_ref(*low, chunk=64)
    up = [a.float() for a in low]
    want = tref.ssd_chunked_bwd_ref(*up, chunk=64)
    for g, w, dtype in zip(got, want, (torch.bfloat16, torch.float32,
                                       torch.float32, torch.bfloat16,
                                       torch.bfloat16, torch.float32)):
        assert g.dtype == dtype
        assert torch.equal(g, w.to(dtype))


def test_ssd_function_gradcheck_float64():
    g = torch.Generator().manual_seed(0)
    b, s, h, p, n = 1, 24, 2, 3, 5
    args = (torch.randn((b, s, h, p), generator=g, dtype=torch.float64),
            0.01 + 0.29 * torch.rand((b, s, h), generator=g,
                                     dtype=torch.float64),
            -(0.3 + torch.rand((h,), generator=g, dtype=torch.float64)),
            torch.randn((b, s, n), generator=g, dtype=torch.float64),
            torch.randn((b, s, n), generator=g, dtype=torch.float64),
            torch.randn((h,), generator=g, dtype=torch.float64))
    args = tuple(a.requires_grad_(True) for a in args)
    assert torch.autograd.gradcheck(
        lambda *a: tssd.SSDScanFunction.apply(*a, 8), args)
    assert torch.autograd.gradcheck(
        lambda *a: tssd.SSDScanFunction.apply(*a, 8)[0], args)


def test_cpu_grad_runs_through_the_function():
    x = torch.randn(1, 8, 2, 4, requires_grad=True)
    y, st = ops.ssd(x, torch.rand(1, 8, 2) + 0.01, -torch.rand(2) - 0.1,
                    torch.randn(1, 8, 4), torch.randn(1, 8, 4),
                    torch.randn(2), chunk=8)
    assert type(y.grad_fn).__name__ == "SSDScanFunctionBackward"


@pytest.mark.parametrize("with_state", [False, True])
def test_card_ssd_under_grad_runs_the_forward_then_the_backward_kernel(
        monkeypatch, with_state):
    """On the card, ssd under grad goes through SSDScanFunction: the
    forward kernel, then the backward kernel (handed the final state's
    gradient, or None where only y is used), never an autograd trace of
    the plain version. Under no_grad only the forward kernel runs."""
    calls = []

    def fwd(x, dt, A, B, C, D, chunk):
        calls.append("ssd_scan")
        return tref.ssd_chunked(x, dt, A, B, C, D, chunk=chunk)

    def bwd(x, dt, A, B, C, D, dy, dstate, chunk):
        assert chunk == 8           # the forward's, for a fake call's count
        calls.append(("ssd_scan_bwd", dstate is not None))
        return tref.ssd_chunked_bwd_ref(x, dt, A, B, C, D, dy, dstate,
                                        chunk=8)

    monkeypatch.setattr(tssd, "on_card", lambda t, name: True)
    monkeypatch.setattr(tssd, "_kernel_forward", fwd)
    monkeypatch.setattr(tssd, "_kernel_backward", bwd)
    ins = _torch(_inputs(1, 16, 2, 4, 8, seed=1))
    args = [a.clone().requires_grad_(True) for a in ins[:6]]
    y, st = ops.ssd(*args, chunk=8)
    loss = (y * ins[6]).sum() + ((st * ins[7]).sum() if with_state else 0)
    loss.backward()
    assert calls == ["ssd_scan", ("ssd_scan_bwd", with_state)]
    want = tref.ssd_chunked_bwd_ref(*ins[:7], ins[7] if with_state else None,
                                    chunk=8)
    for a, w in zip(args, want):
        torch.testing.assert_close(a.grad, w, rtol=0, atol=0)
    with torch.no_grad():
        calls.clear()
        ops.ssd(*args, chunk=8)
    assert calls == ["ssd_scan"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
def test_ssd_bwd_plan_accepts_the_forwards_shapes(dtype):
    """The backward takes every dtype, d_state and head dim the forward
    takes, and sizes its scratch from the shape, by the design
    ``bwd_design`` picks."""
    for n in (0, 1, 7, 16, 33, 128, 255, 256, 257):
        for p in (1, 8, 20, 64, 128, 200):
            try:
                tssd.plan(dtype, n, p)
                fwd = True
            except (TypeError, ValueError):
                fwd = False
            try:
                work = tssd.bwd_plan(dtype, 2, 100, 3, p, n)
                design = tssd.bwd_design(dtype, n, p)
                bwd = True
            except (TypeError, ValueError):
                bwd = False
            assert fwd == bwd, (n, p)
            if bwd and design == tssd.SIMT:
                assert work == 2 * 2 * 3 * 2 * p * n + 3 * 2 * 3 * 2 + \
                    2 * 2 * 3 * 100 * n
            elif bwd:       # H and dS as bf16 pairs, the three groups' dB
                # and dC sums, the dA and dD partials
                assert work == 2 * 2 * 3 * 2 * p * n + 2 * 2 * 3 * 100 * n + \
                    2 * 2 * 3 * 2


# ---------------------------------------------------------------------------
# csrc/ssd_scan_bwd.cu's tensor-core design, launch for launch.
# ---------------------------------------------------------------------------
TC_SRC = CU.read_text()
TC_SRC = TC_SRC[TC_SRC.index("namespace ssd_bwd_tc {"):]
TC_CONSTS = {k: int(v) for k, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", TC_SRC)}
TC_GROUPS = 4           # blocks a (tile, batch), each a group of heads


def _pair(v):
    """csrc/ssd_common.cuh's split2: hi = bf16(v), lo = bf16(v - hi), both
    back in fp32; an operand so split goes into two mma."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _mm(spec, pair, other):
    """An mma of a hi/lo pair against an exact operand: hi, then lo, into
    one fp32 accumulator."""
    return torch.einsum(spec, pair[0], other) + torch.einsum(spec, pair[1],
                                                             other)


def ssd_bwd_tc_emulated(x, dt, A, B, C, D, dy, dstate, groups=TC_GROUPS):
    """The three launches of the tensor-core ``repro_ssd_scan_bwd`` in
    fp32, vectorized over (batch, tile) where blocks run in parallel:
    (1) the state path, forward from 0 and backward from dstate, acc <-
    exp(L_T) acc + (w x)^T B (or (e dy)^T C) with the fp32-factor operand
    as a hi/lo pair, each state stored as a hi/lo pair; (2) per block a
    group of heads in order: P' = dy x^T scaled by dt_j, KE as a pair,
    du = KE^T dy + exp(L_T - L_j) B dS^T, dy H into dC and x dS into dB
    scaled in the accumulator, W = sum of E P over the block's heads, then
    W B and W^T C from W as a pair, the group's sums of dB and dC; (3) dB
    and dC, the groups' sums in group order, and dA, dD over batches, then
    tiles."""
    f = lambda t: t.detach().to(torch.float32)
    b, s, h, p = x.shape
    n = B.shape[-1]
    nt = -(-s // KT)
    pad = nt * KT - s

    def tiles(t):           # zero past s, then (b, nt, KT, ...)
        t = torch.nn.functional.pad(f(t), [0, 0] * (t.dim() - 2) + [0, pad])
        return t.reshape(b, nt, KT, *t.shape[2:])
    xr, yr, dtr, Br, Cr = map(tiles, (x, dy, dt, B, C))
    Af, Df = f(A), f(D)
    L = torch.cumsum(dtr * Af, dim=2)                       # (b, nt, KT, h)
    decay = torch.exp(L[:, :, -1])                          # (b, nt, h)

    # 1. the state path: H entering tile c, dS leaving it, as pairs; None
    # where zero (the kernel skips those terms).
    zero = (torch.zeros((b, h, p, n)),) * 2
    Hp, dSp = [None] * nt, [None] * nt
    w = torch.exp(L[:, :, -1:] - L) * dtr
    acc = torch.zeros((b, h, p, n))
    for c in range(nt - 1):
        acc = acc * decay[:, c, :, None, None] + _mm(
            "bjhq,bjn->bhqn", _pair(w[:, c, ..., None] * xr[:, c]), Br[:, c])
        Hp[c + 1] = _pair(acc)
    acc = torch.zeros((b, h, p, n)) if dstate is None else f(dstate)
    if dstate is not None:
        dSp[nt - 1] = _pair(acc)
    for c in range(nt - 1, 0, -1):
        ey = torch.exp(L[:, c])[..., None] * yr[:, c]
        acc = acc * decay[:, c, :, None, None] + _mm(
            "bthq,btn->bhqn", _pair(ey), Cr[:, c])
        dSp[c - 1] = _pair(acc)
    has_h = torch.tensor([v is not None for v in Hp])
    has_s = torch.tensor([v is not None for v in dSp])
    Hh, Hl = (torch.stack([(v or zero)[i] for v in Hp], 1) for i in (0, 1))
    Sh, Sl = (torch.stack([(v or zero)[i] for v in dSp], 1) for i in (0, 1))

    # 2. the local kernel, group by group
    tri = torch.tril(torch.ones((KT, KT), dtype=torch.bool))
    K = torch.einsum("bctn,bcjn->bctj", Cr, Br)
    dx = torch.zeros_like(xr)
    ddt = torch.zeros_like(dtr)
    partA = torch.zeros((b, h, nt))
    partD = torch.zeros((b, h, nt))
    hpb = -(-h // min(groups, h))
    sums = []
    for h0 in range(0, h, hpb):
        W = torch.zeros((b, nt, KT, KT))
        dCa = torch.zeros((b, nt, KT, n))
        dBa = torch.zeros_like(dCa)
        for hh in range(h0, min(h, h0 + hpb)):
            xh, yh, dth, Lh = xr[..., hh, :], yr[..., hh, :], dtr[..., hh], \
                L[..., hh]
            eL = torch.exp(Lh)
            wl = torch.exp(Lh[..., -1:] - Lh)
            H = (Hh[:, :, hh], Hl[:, :, hh])
            S = (Sh[:, :, hh], Sl[:, :, hh])
            Pd = torch.einsum("bctq,bcjq->bctj", yh, xh)
            E = torch.where(tri, torch.exp(torch.where(
                tri, Lh[..., :, None] - Lh[..., None, :], 0.0)), 0.0)
            P = Pd * dth[:, :, None, :]
            KE = K * E
            W = W + E * P
            Q = KE * P
            dli = ((torch.cumsum(Q, -1) - Q) * tri).sum(-2)
            V = torch.einsum("bcjn,bcqn->bcjq", Br, S[0]) + \
                torch.einsum("bcjn,bcqn->bcjq", Br, S[1])
            du = _mm("bctj,bctq->bcjq", _pair(KE), yh) + wl[..., None] * V
            dx[..., hh, :] = dth[..., None] * du + Df[hh] * yh
            xdu = (xh * du).sum(-1)
            rr = wl * dth * (xh * V).sum(-1)
            Y = torch.einsum("bctq,bcqn->bctn", yh, H[0]) + \
                torch.einsum("bctq,bcqn->bctn", yh, H[1])
            iy = eL * (Cr * Y).sum(-1)
            dCa = dCa + eL[..., None] * Y
            Z = torch.einsum("bcjq,bcqn->bcjn", xh, S[0]) + \
                torch.einsum("bcjq,bcqn->bcjn", xh, S[1])
            dBa = dBa + (wl * dth)[..., None] * Z
            hds = ((H[0] + H[1]) * (S[0] + S[1])).sum((-1, -2))
            hds = torch.where(has_h & has_s, hds, 0.0)
            suffix = torch.flip(torch.cumsum(torch.flip(iy, (-1,)), -1),
                                (-1,))
            dl = (dli + eL[..., -1:] * hds[..., None]) + suffix + \
                (torch.cumsum(rr, -1) - rr)
            ddt[..., hh] = xdu + Af[hh] * dl
            partA[:, hh] = (dth * dl).sum(-1)
            partD[:, hh] = (yh * xh).sum((-1, -2))
        Wp = _pair(W)
        dCa = dCa + _mm("bctj,bcjn->bctn", Wp, Br)
        dBa = dBa + _mm("bctj,bctn->bcjn", Wp, Cr)
        sums.append((dCa, dBa))
    dC = torch.zeros((b, nt, KT, n))
    dB = torch.zeros_like(dC)
    for dCa, dBa in sums:           # group order
        dC = dC + dCa
        dB = dB + dBa

    # 3. dA, dD over batches, then tiles
    dA = torch.zeros(h)
    dD = torch.zeros(h)
    for bi in range(b):
        for c in range(nt):
            dA = dA + partA[bi, :, c]
            dD = dD + partD[bi, :, c]
    cut = lambda t: t.reshape(b, nt * KT, *t.shape[3:])[:, :s]
    return (cut(dx).to(x.dtype), cut(ddt), dA, cut(dB).to(B.dtype),
            cut(dC).to(C.dtype), dD)


@pytest.mark.parametrize("dstate", [False, True], ids=["dstate0", "dstate"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", CASES)
def test_ssd_bwd_tc_emulation_matches_jax_grad(b, s, h, p, n, chunk, dstate):
    """The tensor-core design's algorithm at every shape of CASES, on
    inputs whose x, B, C and dy are bf16 values (the operands the design
    takes exactly), against jax.grad and float64 autograd on the same
    inputs at 1e-5 of max-abs: the hi/lo pairs of KE, W, H, dS, w x and
    e dy leave about 2^-18 of each term, and the sums run in another order
    than either reference's."""
    ins = _bf16_valued(_inputs(b, s, h, p, n, seed=s, dstate=dstate))
    got = ssd_bwd_tc_emulated(*_torch(ins))
    _check(got, ins, chunk)


@pytest.mark.parametrize("dstate", [False, True], ids=["dstate0", "dstate"])
def test_ssd_bwd_tc_emulation_at_the_training_heads(dstate):
    """mamba2-130m's layer (24 heads, p 64, n 128: four groups of six
    heads) at b 1 and 192 steps (three tiles, two boundaries),
    against jax.grad and float64 autograd at the 1e-5 of max-abs above."""
    ins = _bf16_valued(_inputs(1, 192, 24, 64, 128, seed=11, dstate=dstate))
    got = ssd_bwd_tc_emulated(*_torch(ins))
    _check(got, ins, 192)


@pytest.mark.parametrize("h", [1, 3, 5, 24])
def test_ssd_bwd_tc_emulation_is_the_same_for_any_group_split(h):
    """The heads' split into groups changes only roundings: the order of
    the fp32 sums of dB and dC, and W's hi/lo pair taken per block (2^-18
    of each block's W): one block of all heads and the kernel's split
    agree to the 1e-5 of max-abs above."""
    ins = _torch(_bf16_valued(_inputs(1, 130, h, 16, 32, seed=h)))
    got = ssd_bwd_tc_emulated(*ins)
    one = ssd_bwd_tc_emulated(*ins, groups=1)
    for name, g, w in zip(NAMES, got, one):
        err = (g - w).abs().max().item()
        assert err <= TOL * w.abs().max().item(), (name, err)


def test_ssd_bwd_design_matches_the_kernel_dispatch():
    """bwd_design's tensor-core limits and tile are the kernel's own
    constants, its shapes are those of the kernel's fits() (evaluated from
    the source), and the C entry takes design 1 in bfloat16 only."""
    assert (TC_CONSTS["kT"], TC_CONSTS["kMaxN"], TC_CONSTS["kMaxP"],
            TC_CONSTS["kGroups"]) == (tssd.BWD_TILE, tssd.TC_BWD_MAX_STATE,
                                      tssd.TC_MAX_HEADDIM, TC_GROUPS)
    assert tssd.TC_BWD_GROUPS == TC_GROUPS
    fits = re.search(r"bool fits\(int p, int n\) \{\s*return ([^;]+);",
                     TC_SRC).group(1)
    expr = fits.replace("&&", "and").replace("\n", " ")
    for k in ("kMaxN", "kMaxP"):
        expr = expr.replace(k, str(TC_CONSTS[k]))
    for n in (*range(1, 257, 3), 128, 256):
        for p in (1, 8, 16, 20, 32, 48, 64, 80, 128):
            want = tssd.TENSOR_CORES if eval(expr, {"n": n, "p": p}) \
                else tssd.SIMT
            assert tssd.bwd_design(torch.bfloat16, n, p) == want, (n, p)
            assert tssd.bwd_design(torch.float32, n, p) == tssd.SIMT
    src = CU.read_text()
    assert "design == 1 && dtype == kBF16" in src
    assert "design == 0 && dtype == kF32" in src
    assert tssd.bwd_design(torch.bfloat16, 257, 64) == tssd.SIMT
    with pytest.raises(ValueError):
        tssd.bwd_design(torch.bfloat16, 0, 64)
    with pytest.raises(TypeError):
        tssd.bwd_design(torch.float16, 128, 64)
    with pytest.raises(ValueError):
        tssd.bwd_plan(torch.float32, 1, 64, 2, 64, 128, tssd.TENSOR_CORES)
