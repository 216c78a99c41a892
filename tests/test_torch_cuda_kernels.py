"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. Every test here is marked ``gpu`` and skips where there is no CUDA
device; the file imports no JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import int8_matmul as tint8
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as trmsnorm
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels.ref import attention_lse_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# bf16: kernel and plain version both compute in fp32 and round once, so
# they differ by about one bf16 ulp (2^-8 relative). fp32: the sums run in
# another order than the plain version's einsum.
GPU_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# ssd_scan: the kernels' 64-step tiles against the plain version's chunk
# of 256 (the math is chunk-invariant up to fp32 rounding; the bf16
# tensor-core design feeds operands with an fp32 factor as bf16 hi/lo
# pairs, about 2^-17 of each term); fp32 state and fp32 y held at
# tests/test_kernels_ssd.py's 2e-4, bf16 y at one ulp.
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


def _rmsnorm_check(x, w, lowp):
    out = trmsnorm.rmsnorm(x, w, 1e-5, lowp=lowp)
    torch.cuda.synchronize()
    want = trmsnorm.plain(x, w, 1e-5, lowp)
    assert out.dtype == x.dtype and out.shape == x.shape
    tol = GPU_TOL[x.dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lowp", [False, True])
@pytest.mark.parametrize("rows", [1, 4, 7, 333, 512])
@pytest.mark.parametrize("d", [8, 64, 100, 768, 2048, 4096, 8192])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, lowp, rows, d):
    """Every launch plan: one warp a row with 1..8 chunks a lane (d 8 to
    2048), 2, 4 and 8 warps a row (d 4096, 8192), single elements (d 100),
    one and several rows a block."""
    _rmsnorm_check(_randn((rows, d), dtype, cuda, 0),
                   _randn((d,), torch.float32, cuda, 1), lowp)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lowp", [False, True])
@pytest.mark.parametrize("d", [768, 2048, 8192])
@pytest.mark.parametrize("shifted", ["x", "w"])
def test_rmsnorm_kernel_misaligned_row_view(cuda, dtype, lowp, d, shifted):
    """A contiguous view one element past an aligned start takes the
    single-element loads, and agrees all the same."""
    rows = 333

    def view(n, dt, seed, shift):
        return _randn((n + 1,), dt, cuda, seed)[shift:shift + n]
    x = view(rows * d, dtype, 0, int(shifted == "x")).view(rows, d)
    w = view(d, torch.float32, 1, int(shifted == "w"))
    assert not trmsnorm.plan(rows, d, x.element_size(),
                             x.data_ptr() % 16 == 0 and
                             w.data_ptr() % 16 == 0)[0]
    _rmsnorm_check(x, w, lowp)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,hq,hkv,d", [
    (1, 333, 16, 8, 128), (2, 64, 4, 4, 64), (1, 77, 4, 2, 16),
    (2, 130, 4, 1, 32)])
def test_flash_kernel_matches_plain(cuda, dtype, causal, b, sq, hq, hkv, d):
    q = _randn((b, sq, hq, d), dtype, cuda, 0)
    k = _randn((b, sq, hkv, d), dtype, cuda, 1)
    v = _randn((b, sq, hkv, d), dtype, cuda, 2)
    out = tflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = tflash.plain(q, k, v, causal=causal)
    tol = GPU_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,skv,hq,hkv,d", [
    (4, 741, 16, 8, 128), (3, 256, 4, 4, 64), (2, 50, 4, 2, 16),
    (2, 300, 8, 1, 32)])
def test_decode_kernel_matches_plain(cuda, dtype, b, skv, hq, hkv, d):
    q = _randn((b, hq, d), dtype, cuda, 0)
    k = _randn((b, skv, hkv, d), dtype, cuda, 1)
    v = _randn((b, skv, hkv, d), dtype, cuda, 2)
    length = torch.tensor([1, skv, skv // 3, 0][:b], dtype=torch.int32,
                          device=cuda)
    out = tdecode.decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    want = tdecode.plain(q, k, v, length)
    want = torch.where(length[:, None, None] == 0, 0.0, want.float())
    tol = GPU_TOL[dtype]
    torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_decode_kernel_reads_no_row_past_length(cuda):
    q = _randn((2, 4, 64), torch.float32, cuda, 0)
    k = _randn((2, 128, 2, 64), torch.float32, cuda, 1)
    v = _randn((2, 128, 2, 64), torch.float32, cuda, 2)
    length = torch.tensor([50, 100], dtype=torch.int32, device=cuda)
    out1 = tdecode.decode_attention(q, k, v, length)
    k[:, 100:] = float("nan")
    v[:, 100:] = float("nan")
    out2 = tdecode.decode_attention(q, k, v, length)
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)


def _flash_check(cuda, dtype, b, sq, skv, hq, hkv, d, causal):
    q = _randn((b, sq, hq, d), dtype, cuda, 0)
    k = _randn((b, skv, hkv, d), dtype, cuda, 1)
    v = _randn((b, skv, hkv, d), dtype, cuda, 2)
    out = tflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = tflash.plain(q, k, v, causal=causal)
    tol = GPU_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("sq", [1, 63, 64, 65, 101, 700])
def test_flash_kernel_ragged_lengths_and_groups(cuda, dtype, causal, g, sq):
    """Lengths around the 64-row tile, the serve run's shortest and longest
    prompts, and GQA groups 1, 2, 8, at d 128 (bf16: the wgmma kernel)."""
    _flash_check(cuda, dtype, 1, sq, sq, 2 * g, 2, 128, causal)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv", [(65, 200), (200, 65), (1, 700),
                                    (333, 129)])
def test_flash_kernel_full_attention_skv_differs(cuda, dtype, d, sq, skv):
    _flash_check(cuda, dtype, 2, sq, skv, 4, 2, d, False)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 128), (torch.bfloat16, 64),    # flash_fwd_wgmma_kernel
    (torch.bfloat16, 160),
    (torch.bfloat16, 32), (torch.float32, 128),     # flash_fwd_simt_kernel
    (torch.float32, 160)])
def test_flash_both_routes_launch(cuda, dtype, d):
    """Each route is a kernel launch, counted under flash_attention."""
    q = _randn((1, 70, 4, d), dtype, cuda, 0)
    kv = _randn((1, 70, 2, d), dtype, cuda, 1)
    before = tflash.KERNEL.launches
    tflash.flash_attention(q, kv, kv)
    torch.cuda.synchronize()
    assert tflash.KERNEL.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,hq,hkv", [
    (1, 333, 32, 8), (1, 65, 32, 8), (2, 1, 4, 1), (1, 130, 14, 2),
    (1, 700, 8, 8)])
def test_flash_kernel_head_dim_160(cuda, dtype, causal, b, sq, hq, hkv):
    """stablelm-12b's d 160 (bf16: the wgmma kernel's three boxes, the
    third zero past 160, P.V at N 192; fp32: the CUDA-core kernel), at its
    32/8 heads and at groups 4, 7 and 1, ragged lengths."""
    _flash_check(cuda, dtype, b, sq, sq, hq, hkv, 160, causal)


@pytest.mark.gpu
def test_flash_d160_bf16_takes_the_wgmma_kernel(cuda):
    """By the profiler's kernel names: bf16 at d 160 runs
    flash_fwd_wgmma_kernel, never the CUDA-core kernel or a PyTorch
    attention (the plain version's matmuls and softmax)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    q = _randn((1, 333, 32, 160), torch.bfloat16, cuda, 0)
    kv = _randn((1, 333, 8, 160), torch.bfloat16, cuda, 1)
    tflash.flash_attention(q, kv, kv)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tflash.flash_attention(q, kv, kv)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert any("flash_fwd_wgmma_kernel" in n for n in names), names
    assert all("flash_fwd_wgmma_kernel" in n for n in names), names


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,causal", [
    (8, 256, 256, True), (8, 256, 256, False), (1, 130, 130, True),
    (1, 130, 130, False), (2, 65, 200, False), (2, 200, 65, False),
    (1, 1, 1, True)])
def test_flash_bwd_at_head_dim_160_matches_plain(cuda, dtype, b, sq, skv,
                                                 causal):
    """stablelm-12b's 32/8 heads at d 160 (bf16: the wgmma kernels, tiles
    in three boxes, dK/dV on two warpgroups; fp32: the CUDA-core ones),
    at its training shape and ragged lengths, against the plain backward
    at the tolerances of d 128; then through autograd, one forward and
    one backward launch."""
    q, k, v, dout = _attn_inputs(cuda, dtype, b, sq, skv, 32, 8, 160)
    scale = 160 ** -0.5
    out, lse = tflash._kernel_forward(q, k, v, causal, scale, with_lse=True)
    got = tflash._kernel_backward(q, k, v, out, dout, lse, causal, scale)
    torch.cuda.synchronize()
    want = tflash.plain_bwd(q, k, v, out, dout, lse, causal=causal,
                            scale=scale)
    for g, w_, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _rel_close(g, w_, 1e-5 if dtype == torch.float32 else 1e-2)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (tflash.KERNEL.launches, tflash.KERNEL_BWD.launches)
    grads = torch.autograd.grad(ops.attention(*leaves, causal=causal),
                                leaves, dout)
    torch.cuda.synchronize()
    assert (tflash.KERNEL.launches, tflash.KERNEL_BWD.launches) == \
        (before[0] + 1, before[1] + 1)
    for a, b_ in zip(grads, got):
        assert torch.equal(a, b_)


def _decode_lengths(skv):
    """0, skv, and lengths on and one past split boundaries."""
    sr = tdecode.split_rows(skv)
    return [0, skv, min(skv, sr), min(skv, 2 * sr + 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("skv", [1, 740, 4096])
def test_decode_kernel_split_boundaries(cuda, dtype, g, skv):
    hkv, d = 2, 128
    q = _randn((4, hkv * g, d), dtype, cuda, 0)
    k = _randn((4, skv, hkv, d), dtype, cuda, 1)
    v = _randn((4, skv, hkv, d), dtype, cuda, 2)
    length = torch.tensor(_decode_lengths(skv), dtype=torch.int32,
                          device=cuda)
    out = tdecode.decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    want = tdecode.plain(q, k, v, length)
    want = torch.where(length[:, None, None] == 0, 0.0, want.float())
    tol = GPU_TOL[dtype]
    torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [3, 5, 6, 7, 16])
@pytest.mark.parametrize("d", [64, 128, 160])
@pytest.mark.parametrize("skv", [1, 740, 4096])
def test_decode_kernel_any_group_and_head_dim_160(cuda, dtype, g, d, skv):
    """Groups that neither divide the P.V thread groups nor are divided by
    them (3, 5, 6, 7; 16 at the largest bucket), at d 64, 128 and 160 (20
    chunks a bf16 row, 40 an fp32 one), lengths on split boundaries."""
    hkv = 2
    q = _randn((4, hkv * g, d), dtype, cuda, 0)
    k = _randn((4, skv, hkv, d), dtype, cuda, 1)
    v = _randn((4, skv, hkv, d), dtype, cuda, 2)
    length = torch.tensor(_decode_lengths(skv), dtype=torch.int32,
                          device=cuda)
    out = tdecode.decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    want = tdecode.plain(q, k, v, length)
    want = torch.where(length[:, None, None] == 0, 0.0, want.float())
    tol = GPU_TOL[dtype]
    torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 160), (14, 2, 64),
                                      (40, 8, 128)])
def test_decode_kernel_at_the_new_archs_heads(cuda, hq, hkv, d):
    """stablelm-12b's, internvl2-1b's and llama4-maverick's heads at 4
    slots of the serve cache, bf16."""
    skv = 740
    q = _randn((4, hq, d), torch.bfloat16, cuda, 0)
    k = _randn((4, skv, hkv, d), torch.bfloat16, cuda, 1)
    v = _randn((4, skv, hkv, d), torch.bfloat16, cuda, 2)
    length = torch.tensor([129, 334, 517, 731], dtype=torch.int32,
                          device=cuda)
    out = tdecode.decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    tol = GPU_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(),
                               tdecode.plain(q, k, v, length).float(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d", [(71, 1, 64), (17, 1, 128),
                                      (40, 2, 72), (8, 1, 256),
                                      (32, 32, 96), (4, 1, 100),
                                      (33, 1, 250), (6, 2, 1)])
@pytest.mark.parametrize("skv", [740, 4096])
def test_decode_kernel_groups_above_16_and_padded_head_dims(cuda, dtype, hq,
                                                            hkv, d, skv):
    """falcon-7b's group of 71 (five slices of q heads), groups 17 and 20,
    head dims between the instantiated ones (whole 16-byte chunks or not)
    and 256, in both modes, lengths on split boundaries and 0."""
    q = _randn((4, hq, d), dtype, cuda, 0)
    k = _randn((4, skv, hkv, d), dtype, cuda, 1)
    v = _randn((4, skv, hkv, d), dtype, cuda, 2)
    length = torch.tensor(_decode_lengths(skv), dtype=torch.int32,
                          device=cuda)
    before = tdecode.KERNEL.launches
    out = tdecode.decode_attention(q, k, v, length)
    out2, lse = tdecode.decode_attention(q, k, v, length, return_lse=True)
    torch.cuda.synchronize()
    assert tdecode.KERNEL.launches == before + 2
    want, want_lse = tdecode.plain(q, k, v, length, return_lse=True)
    tol = GPU_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(out, out2)
    fin = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], want_lse[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_decode_kernel_refuses_head_dim_0(cuda):
    q = _randn((1, 2, 0), torch.bfloat16, cuda, 0)
    kv = _randn((1, 64, 1, 0), torch.bfloat16, cuda, 1)
    length = torch.tensor([10], dtype=torch.int32, device=cuda)
    before = tdecode.KERNEL.launches
    with pytest.raises(ValueError, match="head_dim 0"):
        tdecode.decode_attention(q, kv, kv, length)
    assert tdecode.KERNEL.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("hq,hkv,d", [(16, 1, 512), (128, 1, 576),
                                      (8, 2, 300), (5, 1, 257)])
def test_decode_kernel_above_256_matches_plain(cuda, dtype, lse, hq, hkv,
                                               d):
    """The column-tile kernel (decode_wide_kernel), both modes, at a group
    of 16, the absorbed MLA decode's 128 on one latent head of 576 (eight
    slices), and rows not whole 16-byte chunks; one launch a call; the
    same out in both modes; two calls bitwise equal."""
    b, skv = 4, 740
    q = _randn((b, hq, d), dtype, cuda, 0)
    k = _randn((b, skv, hkv, d), dtype, cuda, 1)
    v = _randn((b, skv, hkv, d), dtype, cuda, 2)
    length = torch.tensor([129, 334, 740, 1], dtype=torch.int32,
                          device=cuda)
    before = tdecode.KERNEL.launches
    got = tdecode.decode_attention(q, k, v, length, return_lse=lse)
    again = tdecode.decode_attention(q, k, v, length, return_lse=lse)
    torch.cuda.synchronize()
    assert tdecode.KERNEL.launches == before + 2
    want = tdecode.plain(q, k, v, length, return_lse=lse)
    out, want_out = (got[0], want[0]) if lse else (got, want)
    tol = GPU_TOL[dtype]
    torch.testing.assert_close(out.float(), want_out.float(), rtol=tol,
                               atol=tol)
    assert torch.equal(out, again[0] if lse else again)
    if lse:
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_decode_kernel_above_256_replays_in_a_cuda_graph(cuda):
    """The column-tile kernel captured once and replayed with ``length``
    changed in place: each replay matches the plain version and two back
    to back agree (its combine counters left at 0)."""
    b, skv, hq, hkv, d = 4, 740, 32, 1, 576
    q = _randn((b, hq, d), torch.bfloat16, cuda, 0)
    k = _randn((b, skv, hkv, d), torch.bfloat16, cuda, 1)
    v = _randn((b, skv, hkv, d), torch.bfloat16, cuda, 2)
    length = torch.tensor([129, 334, 517, 731], dtype=torch.int32,
                          device=cuda)
    tdecode.decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tdecode.decode_attention(q, k, v, length)
    tol = GPU_TOL[torch.bfloat16]
    for lens in ([1, 2, 3, 4], [740, 64, 65, 700]):
        length.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        first = out.clone()
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, first, rtol=0, atol=0)
        want = tdecode.plain(q, k, v, length)
        torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.gpu
def test_decode_kernel_replays_in_a_cuda_graph(cuda):
    """Captured once, replayed with `length` changed in place: each replay
    matches the plain version, and two replays back to back agree, so the
    combine counter is back at 0 after every launch."""
    b, skv, hq, hkv, d = 4, 740, 16, 8, 128
    q = _randn((b, hq, d), torch.bfloat16, cuda, 0)
    k = _randn((b, skv, hkv, d), torch.bfloat16, cuda, 1)
    v = _randn((b, skv, hkv, d), torch.bfloat16, cuda, 2)
    length = torch.tensor([129, 334, 517, 731], dtype=torch.int32,
                          device=cuda)
    tdecode.decode_attention(q, k, v, length)      # warm-up: counter, build
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tdecode.decode_attention(q, k, v, length)
    tol = GPU_TOL[torch.bfloat16]
    for lens in ([1, 2, 3, 4], [740, 0, 64, 65], [700, 600, 500, 400]):
        length.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        first = out.clone()
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, first, rtol=0, atol=0)
        want = tdecode.plain(q, k, v, length)
        want = torch.where(length[:, None, None] == 0, 0.0, want.float())
        torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_cuda_attention_with_kv_len_raises(cuda):
    q = torch.zeros((1, 4, 2, 16), device=cuda)
    with pytest.raises(NotImplementedError):
        ops.attention(q, q, q, kv_len=torch.tensor([2], device=cuda))


def _ssd_inputs(b, s, h, p, n, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)

    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)
    x = torch.randn((b, s, h, p), generator=g, device=device).to(dtype)
    dt = u((b, s, h), 0.01, 0.3)
    A = -u((h,), 0.3, 2.0)
    B = torch.randn((b, s, n), generator=g, device=device).to(dtype)
    C = torch.randn((b, s, n), generator=g, device=device).to(dtype)
    D = torch.randn((h,), generator=g, device=device)
    return x, dt, A, B, C, D


def _ssd_check(args):
    """One call against the plain version: one launch counted, y at the
    dtype's tolerance, the fp32 state at 2e-4."""
    x = args[0]
    b, _, h, p = x.shape
    n = args[3].shape[-1]
    before = tssd.KERNEL.launches
    y, st = tssd.ssd_scan(*args, chunk=256)
    torch.cuda.synchronize()
    assert tssd.KERNEL.launches == before + 1
    want_y, want_st = tssd.plain(*args, chunk=256)
    assert y.dtype == x.dtype and st.shape == (b, h, p, n)
    tol = SSD_TOL[x.dtype]
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(st, want_st, rtol=SSD_TOL[torch.float32],
                               atol=SSD_TOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [16, 128])
@pytest.mark.parametrize("p", [16, 64])
@pytest.mark.parametrize("h", [1, 24])
@pytest.mark.parametrize("s", [1, 3, 101, 129, 200, 255, 256, 512, 768,
                               1024])
def test_ssd_kernel_matches_plain(cuda, dtype, b, n, p, h, s):
    """Both designs: bf16 takes the tensor-core kernels at these n and p,
    fp32 the CUDA-core one; s covers the serve run's ragged prompts (101,
    200, 255) and its multi-chunk ones (512, 768, 1024)."""
    assert tssd.plan(dtype, n, p) == (
        tssd.TENSOR_CORES if dtype == torch.bfloat16 else tssd.SIMT)
    _ssd_check(_ssd_inputs(b, s, h, p, n, dtype, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", [(24, 64), (128, 24), (128, 128), (8, 8)])
@pytest.mark.parametrize("s", [129, 512])
def test_ssd_simt_kernel_takes_bf16_shapes_tc_does_not(cuda, n, p, s):
    assert tssd.plan(torch.bfloat16, n, p) == tssd.SIMT
    _ssd_check(_ssd_inputs(3, s, 4, p, n, torch.bfloat16, cuda))


@pytest.mark.gpu
def test_ssd_kernel_raises_where_no_design_fits(cuda):
    args = list(_ssd_inputs(1, 64, 2, 16, 16, torch.float32, cuda))
    args[3] = args[4] = torch.zeros((1, 64, 0), device=cuda)
    with pytest.raises(ValueError, match="d_state"):
        tssd.ssd_scan(*args, chunk=64)
    with pytest.raises(TypeError):
        tssd.ssd_scan(*(a.half() if i in (0, 3, 4) else a for i, a in
                        enumerate(_ssd_inputs(1, 64, 2, 16, 16,
                                              torch.float32, cuda))),
                      chunk=64)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,s", [(512, 512), (300, 129), (257, 64),
                                 (1024, 200)])
def test_ssd_kernels_at_any_d_state(cuda, dtype, n, s):
    """Past 256, both CUDA-core designs walk d_state in tiles of 256: the
    forward against the plain version, the backward against the closed
    form, two calls bitwise equal."""
    args = _ssd_inputs(1, s, 4, 64, n, dtype, cuda)
    assert tssd.plan(dtype, n, 64) == tssd.bwd_design(dtype, n, 64) == \
        tssd.SIMT
    _ssd_check(args)
    dy = _randn((1, s, 4, 64), dtype, cuda, 5)
    ds = _randn((1, 4, 64, n), torch.float32, cuda, 6)
    got = tssd._kernel_backward(*args, dy, ds)
    again = tssd._kernel_backward(*args, dy, ds)
    torch.cuda.synchronize()
    want = tssd.plain_bwd(*args, dy, ds, chunk=256)
    for g, r, w in zip(got, again, want):
        assert torch.equal(g, r)
        # fp32 gradients at 2e-4 of their max-abs, bf16 ones at one ulp
        tol = SSD_TOL[g.dtype]
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol * max(1.0, w.float().abs().max().item())


@pytest.mark.gpu
def test_ssd_kernel_replays_in_a_cuda_graph(cuda):
    """The bf16 tensor-core call captured once (no allocation outside the
    caching allocator, no sync inside), replayed with x changed in place:
    each replay equals the plain version, and a replay of the first inputs
    again gives the first result bit for bit (nothing carried over)."""
    b, s, h, p, n = 3, 512, 24, 64, 128
    args = _ssd_inputs(b, s, h, p, n, torch.bfloat16, cuda)
    x = args[0]
    assert tssd.plan(x.dtype, n, p) == tssd.TENSOR_CORES
    tssd.ssd_scan(*args, chunk=256)                    # warm-up: build
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, st = tssd.ssd_scan(*args, chunk=256)
    xs = [torch.randn(x.shape, generator=torch.Generator(device=cuda)
                      .manual_seed(seed), device=cuda).to(x.dtype)
          for seed in (1, 2)]
    first = None
    for xi in xs + xs[:1]:
        x.copy_(xi)
        graph.replay()
        torch.cuda.synchronize()
        want_y, want_st = tssd.plain(*args, chunk=256)
        torch.testing.assert_close(y.float(), want_y.float(),
                                   rtol=SSD_TOL[x.dtype],
                                   atol=SSD_TOL[x.dtype])
        torch.testing.assert_close(st, want_st, rtol=SSD_TOL[torch.float32],
                                   atol=SSD_TOL[torch.float32])
        if first is None:
            first = (y.clone(), st.clone())
    torch.testing.assert_close(y, first[0], rtol=0, atol=0)
    torch.testing.assert_close(st, first[1], rtol=0, atol=0)


@pytest.mark.gpu
def test_ssd_kernel_refuses_what_jax_refuses(cuda):
    args = _ssd_inputs(1, 40, 2, 16, 16, torch.float32, cuda)
    with pytest.raises(ValueError):
        ops.ssd(*args, chunk=32)


# int8_matmul shapes: 16-byte loads (k, n multiples of 16), then masked
# byte loads; between them every output tile of int8_matmul.TILES
# (tests/test_torch_kernels.py::test_int8_plan_covers_every_tile_and_route).
INT8_VEC_SHAPES = [(512, 1024, 512), (333, 2048, 8192), (4, 2048, 8192),
                   (1, 64, 16), (129, 48, 80), (333, 2048, 512),
                   (150, 1024, 5120), (100, 1024, 5120)]
INT8_BYTE_SHAPES = [(7, 13, 5), (65, 100, 130), (300, 1000, 300),
                    (333, 1000, 8200), (150, 1000, 5128), (100, 1000, 5128)]


def _int8_operands(m, k, n, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    xq = torch.randint(-128, 128, (m, k), generator=g, device=device,
                       dtype=torch.int8)
    wq = torch.randint(-128, 128, (k, n), generator=g, device=device,
                       dtype=torch.int8)
    sx = torch.rand((m,), generator=g, device=device) / 127
    sw = torch.rand((n,), generator=g, device=device) / 127
    return xq, sx, wq, sw


def _int8_check(xq, sx, wq, sw, out_dtype):
    """int32 sums are exact in both, and the fp32 epilogue runs in the same
    order: the kernel must equal the plain version bit for bit."""
    out = tint8.int8_matmul(xq, sx, wq, sw, out_dtype)
    torch.cuda.synchronize()
    want = tint8.plain(xq, sx, wq, sw, out_dtype)
    assert out.dtype == out_dtype
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def _int8_route(xq, wq):
    (m, k), n = xq.shape, wq.shape[1]
    return tint8.plan(m, k, n, xq.data_ptr(), wq.data_ptr(),
                      torch.cuda.get_device_properties(
                          xq.device).multi_processor_count)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", INT8_VEC_SHAPES + INT8_BYTE_SHAPES)
def test_int8_matmul_kernel_matches_plain(cuda, out_dtype, m, k, n):
    xq, sx, wq, sw = _int8_operands(m, k, n, cuda)
    assert _int8_route(xq, wq)[0] == ((m, k, n) in INT8_VEC_SHAPES)
    _int8_check(xq, sx, wq, sw, out_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", ["x", "w", "both"])
def test_int8_matmul_kernel_misaligned_operands(cuda, out_dtype, shifted):
    """Contiguous views at a 1-byte offset take the byte loads."""
    m, k, n = 333, 2048, 512
    xq, sx, wq, sw = _int8_operands(m, k, n, cuda)

    def shift(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        return v
    if shifted in ("x", "both"):
        xq = shift(xq)
    if shifted in ("w", "both"):
        wq = shift(wq)
    assert not _int8_route(xq, wq)[0]
    _int8_check(xq, sx, wq, sw, out_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_value", [-128, 127])
@pytest.mark.parametrize("m,n", [(64, 512), (333, 8192)])
def test_int8_matmul_kernel_exact_at_extremes(cuda, out_dtype, w_value, m,
                                              n):
    """All-(-128) x at k 8192: |sums| up to 2^27, still exact in int32."""
    k = 8192
    _, sx, _, sw = _int8_operands(m, k, n, cuda)
    xq = torch.full((m, k), -128, dtype=torch.int8, device=cuda)
    wq = torch.full((k, n), w_value, dtype=torch.int8, device=cuda)
    _int8_check(xq, sx, wq, sw, out_dtype)


@pytest.mark.gpu
def test_int8_matmul_kernel_replays_in_a_cuda_graph(cuda):
    """Captured once (no allocation, no sync inside the call), replayed
    with x_q changed in place: each replay equals the plain version."""
    m, k, n = 512, 1024, 512
    xq, sx, wq, sw = _int8_operands(m, k, n, cuda)
    tint8.int8_matmul(xq, sx, wq, sw, torch.bfloat16)   # warm-up: build
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tint8.int8_matmul(xq, sx, wq, sw, torch.bfloat16)
    for seed in (1, 2):
        xq.copy_(_int8_operands(m, k, n, cuda, seed)[0])
        graph.replay()
        torch.cuda.synchronize()
        want = tint8.plain(xq, sx, wq, sw, torch.bfloat16)
        torch.testing.assert_close(out, want, rtol=0, atol=0)


@pytest.mark.gpu
def test_smoke_mamba_on_card_matches_cpu(cuda):
    """The smoke-size fp32 mamba2 through the ssd and rmsnorm kernels
    against the same weights on the CPU: prefill at two chunks and a
    ragged one, then per-slot decode ticks."""
    from repro_torch.config import get_config, smoke_config
    from repro_torch.models import model as lm
    from repro_torch.tree import tree_map
    cfg = smoke_config(get_config("mamba2-130m")).replace(dtype="float32")
    cpu = torch.device("cpu")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), cpu)
    on_card = tree_map(lambda t: t.to(cuda), params)
    ops.reset_launches()
    for s in (64, 19):
        toks = torch.randint(0, cfg.vocab_size, (2, s),
                             generator=torch.Generator().manual_seed(s))
        want, caches = lm.prefill(params, cfg, {"tokens": toks})
        got, gcaches = lm.prefill(on_card, cfg, {"tokens": toks.to(cuda)})
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        pos = torch.tensor([s, s], dtype=torch.int32)
        nxt = toks[:, -1:]
        for _ in range(3):
            want, caches = lm.decode_step(params, cfg, nxt, caches, pos)
            got, gcaches = lm.decode_step(on_card, cfg, nxt.to(cuda),
                                          gcaches, pos.to(cuda))
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                                       atol=1e-4)
            nxt = want.argmax(-1, keepdim=True)
            pos = pos + 1
    counts = ops.launch_counts()
    assert counts["ssd_scan"] == 2 * cfg.num_layers
    assert counts["rmsnorm"] > 0 and counts["flash_attention"] == 0


@pytest.mark.gpu
def test_smoke_model_on_card_matches_cpu(cuda):
    """The smoke-size fp32 model through the kernels (d=16, hq/hkv=2)
    against the same weights on the CPU (plain versions)."""
    from repro_torch.config import get_config, smoke_config
    from repro_torch.models import model as lm
    from repro_torch.tree import tree_map
    cfg = smoke_config(get_config("internlm2-1.8b")).replace(dtype="float32")
    cpu = torch.device("cpu")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), cpu)
    on_card = tree_map(lambda t: t.to(cuda), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 37),
                         generator=torch.Generator().manual_seed(1))
    ops.reset_launches()
    want, caches = lm.prefill(params, cfg, {"tokens": toks}, max_len=48)
    got, gcaches = lm.prefill(on_card, cfg, {"tokens": toks.to(cuda)},
                              max_len=48)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    pos = torch.tensor([37, 30], dtype=torch.int32)
    nxt = toks[:, -1:]
    want, _ = lm.decode_step(params, cfg, nxt, caches, pos)
    got, _ = lm.decode_step(on_card, cfg, nxt.to(cuda), gcaches, pos.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    counts = ops.launch_counts()
    assert min(counts[k] for k in ("rmsnorm", "flash_attention",
                                   "decode_attention")) > 0


# ---------------------------------------------------------------------------
# Backward kernels (training): each against its closed-form plain backward
# on the same inputs, and through autograd.
# ---------------------------------------------------------------------------
def _rel_close(got, want, tol):
    """|got - want| <= tol * (1 + max |want|): fp32 sums over rows or keys
    in another order than the plain version's."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= tol * (1 + want.abs().max().item()), err


def _rmsnorm_bwd_inputs(cuda, dtype, rows, d):
    return (_randn((rows, d), dtype, cuda, 0),
            _randn((d,), torch.float32, cuda, 1),
            _randn((rows, d), dtype, cuda, 2))


def _rmsnorm_bwd_check(x, w, dy, design=None):
    """dx rounded once from fp32 (one ulp in bf16), dw an fp32 sum over the
    rows in another order."""
    dx, dw = trmsnorm._kernel_backward(x, w, dy, 1e-5, design)
    torch.cuda.synchronize()
    want_dx, want_dw = trmsnorm.plain_bwd(x, w, dy, 1e-5)
    assert dx.dtype == x.dtype and dw.dtype == torch.float32
    tol = GPU_TOL[x.dtype]
    torch.testing.assert_close(dx.float(), want_dx.float(), rtol=tol,
                               atol=tol)
    _rel_close(dw, want_dw, 1e-5)
    return dx, dw


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 7, 333, 2048])
@pytest.mark.parametrize("d", [8, 100, 768, 2048, 8192, 16384])
def test_rmsnorm_bwd_kernel_matches_plain(cuda, dtype, rows, d):
    """Every plan of the design training takes (the ring: 1 to 4 chunks a
    lane, 1 to 16 warps a row; d 16384 in bf16 is 2048 chunks, the widest
    row, whose block_rows instantiation spilled), more rows than blocks;
    fp32 at d 16384 (4096 chunks) takes the stream design."""
    x, w, dy = _rmsnorm_bwd_inputs(cuda, dtype, rows, d)
    if d * x.element_size() // 16 > trmsnorm.BWD_MAX_CHUNKS:
        assert trmsnorm.bwd_design(d, x.element_size(), True) == \
            trmsnorm.STREAM
    _rmsnorm_bwd_check(x, w, dy)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lowp", [False, True])
@pytest.mark.parametrize("rows,d", [(2048, 2048), (333, 768), (2, 20000),
                                    (2, 2050), (7, 20001), (64, 100)])
def test_rmsnorm_bwd_kernel_under_lowp_and_wide_rows(cuda, dtype, lowp,
                                                     rows, d):
    """Every design that takes the row (ring, block_rows, stream), with and
    without lowp, against the closed form of the same policy; one launch a
    call; two calls bitwise equal."""
    x, w, dy = _rmsnorm_bwd_inputs(cuda, dtype, rows, d)
    want_dx, want_dw = trmsnorm.plain_bwd(x, w, dy, 1e-5, lowp)
    tol = GPU_TOL[dtype]
    for design in trmsnorm.BWD_DESIGNS:
        try:
            trmsnorm.bwd_plan(rows, d, x.element_size(), True, 132, design)
        except ValueError:
            continue
        before = trmsnorm.KERNEL_BWD.launches
        dx, dw = trmsnorm._kernel_backward(x, w, dy, 1e-5, design,
                                           lowp=lowp)
        dx2, dw2 = trmsnorm._kernel_backward(x, w, dy, 1e-5, design,
                                             lowp=lowp)
        torch.cuda.synchronize()
        assert trmsnorm.KERNEL_BWD.launches == before + 2
        assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
        torch.testing.assert_close(dx.float(), want_dx.float(), rtol=tol,
                                   atol=tol)
        _rel_close(dw, want_dw, 1e-5 if dtype == torch.float32 and not lowp
                   else tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [768, 2048])
@pytest.mark.parametrize("shifted", ["x", "dy"])
def test_rmsnorm_bwd_kernel_misaligned_row_view(cuda, dtype, d, shifted):
    """A contiguous view one element into its buffer is not 16-byte
    aligned: the bulk copies cannot take it, so it runs block_rows on
    single elements."""
    rows = 333
    x, w, dy = _rmsnorm_bwd_inputs(cuda, dtype, rows, d)
    buf = _randn((rows * d + 1,), dtype, cuda, 3)
    view = buf[1:].view(rows, d)
    if shifted == "x":
        x = view
    else:
        dy = view
    assert trmsnorm.bwd_plan(rows, d, x.element_size(), False,
                             132).design == trmsnorm.BLOCK_ROWS
    before = trmsnorm.KERNEL_BWD.launches
    _rmsnorm_bwd_check(x, w, dy)
    assert trmsnorm.KERNEL_BWD.launches == before + 1
    with pytest.raises(ValueError):
        trmsnorm._kernel_backward(x, w, dy, 1e-5, trmsnorm.RING)


@pytest.mark.gpu
@pytest.mark.parametrize("design,dtype,rows,d", [
    (design, dtype, rows, d) for design in ("ring", "block_rows")
    for dtype, rows, d in ((torch.bfloat16, 2048, 768),
                           (torch.bfloat16, 2048, 2048),
                           (torch.float32, 2048, 2048),
                           (torch.float32, 7, 100))] + [
    # 200-byte rows are not 16-byte chunks: block_rows on single elements,
    # the path training sends such rows down.
    ("block_rows", torch.bfloat16, 7, 100)])
def test_rmsnorm_bwd_kernel_replays_in_a_cuda_graph(cuda, design, dtype,
                                                    rows, d):
    """A graph of three calls, replayed twice, gives an eager call's dx and
    dw bit for bit: no atomics, and the ring's grid sync is ready again for
    the next replay."""
    code = {v: k for k, v in trmsnorm.BWD_DESIGNS.items()}[design]
    x, w, dy = _rmsnorm_bwd_inputs(cuda, dtype, rows, d)
    dx, dw = trmsnorm._kernel_backward(x, w, dy, 1e-5, code)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [trmsnorm._kernel_backward(x, w, dy, 1e-5, code)
                for _ in range(3)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for gx, gw in outs:
            assert torch.equal(gx, dx) and torch.equal(gw, dw)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [3, 16, 64])
def test_rmsnorm_bwd_ring_on_two_streams_at_once(cuda, rows):
    """Two graphs of 50 ring calls each, of small grids (a block a row),
    replayed on two streams at once so that their launches sit on the card
    together: each call gives the eager call's dx and dw bit for bit, so no
    two launches share a grid-sync word."""
    cases = [_rmsnorm_bwd_inputs(cuda, torch.bfloat16, rows, d)
             for d in (768, 2048)]
    want = [trmsnorm._kernel_backward(*c, 1e-5, trmsnorm.RING)
            for c in cases]
    graphs, outs = [], []
    for c in cases:
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1]):
            outs.append([trmsnorm._kernel_backward(*c, 1e-5, trmsnorm.RING)
                         for _ in range(50)])
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    for _ in range(3):
        for st, graph in zip(streams, graphs):
            with torch.cuda.stream(st):
                graph.replay()
        torch.cuda.synchronize()
        for (wx, ww), got in zip(want, outs):
            for gx, gw in got:
                assert torch.equal(gx, wx) and torch.equal(gw, ww)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(2048, 768), (2048, 2048), (333, 64),
                                    (4099, 768), (1, 4096)])
def test_rmsnorm_bwd_designs_agree(cuda, dtype, rows, d):
    """The block_rows design, at the 16-byte shapes it still takes, agrees
    with the ring to one ulp of dx and fp32 rounding of dw."""
    x, w, dy = _rmsnorm_bwd_inputs(cuda, dtype, rows, d)
    ring = _rmsnorm_bwd_check(x, w, dy, trmsnorm.RING)
    old = _rmsnorm_bwd_check(x, w, dy, trmsnorm.BLOCK_ROWS)
    tol = GPU_TOL[dtype]
    torch.testing.assert_close(old[0].float(), ring[0].float(), rtol=tol,
                               atol=tol)
    _rel_close(old[1], ring[1], 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_autograd_runs_the_backward_kernel(cuda, dtype):
    x = _randn((4, 33, 2048), dtype, cuda, 0).requires_grad_(True)
    w = _randn((2048,), torch.float32, cuda, 1).requires_grad_(True)
    dy = _randn((4, 33, 2048), dtype, cuda, 2)
    ops.reset_launches()
    y = ops.rmsnorm(x, w)
    y.backward(dy)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["rmsnorm"] == 1 and counts["rmsnorm_bwd"] == 1
    want_dx, want_dw = trmsnorm.plain_bwd(x.detach(), w.detach(), dy)
    tol = GPU_TOL[dtype]
    torch.testing.assert_close(x.grad.float(), want_dx.float(), rtol=tol,
                               atol=tol)
    _rel_close(w.grad, want_dw, 1e-5)
    # Bitwise repeatable: no atomics in either kernel.
    dx2, dw2 = trmsnorm._kernel_backward(x.detach(), w.detach(), dy, 1e-5)
    assert torch.equal(dx2, x.grad) and torch.equal(dw2, w.grad)


@pytest.mark.gpu
def test_rmsnorm_lowp_under_grad_runs_its_backward_on_card(cuda):
    x = _randn((4, 64), torch.bfloat16, cuda, 0).requires_grad_(True)
    w = torch.ones(64, device=cuda, requires_grad=True)
    before = trmsnorm.KERNEL_BWD.launches
    ops.rmsnorm(x, w, lowp=True).sum().backward()
    assert trmsnorm.KERNEL_BWD.launches == before + 1
    want = trmsnorm.plain_bwd(x.detach(), w.detach(),
                              torch.ones_like(x), 1e-5, True)
    assert torch.equal(x.grad, want[0])


def _attn_inputs(cuda, dtype, b, sq, skv, hq, hkv, d):
    q = _randn((b, sq, hq, d), dtype, cuda, 0)
    k = _randn((b, skv, hkv, d), dtype, cuda, 1)
    v = _randn((b, skv, hkv, d), dtype, cuda, 2)
    dout = _randn((b, sq, hq, d), dtype, cuda, 3)
    return q, k, v, dout


# lse: fp32 log-sum-exp of scores that are exact products of the inputs;
# the bf16 wgmma kernel sums exp2 of the scaled scores in another order.
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 128), (torch.bfloat16, 64), (torch.bfloat16, 16),
    (torch.float32, 128), (torch.float32, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq", [1, 65, 256, 333])
def test_flash_forward_lse_matches_plain(cuda, dtype, d, causal, sq):
    q, k, v, _ = _attn_inputs(cuda, dtype, 2, sq, sq, 4, 2, d)
    scale = 1.0 / d ** 0.5
    out, lse = tflash._kernel_forward(q, k, v, causal, scale, with_lse=True)
    torch.cuda.synchronize()
    _rel_close(lse, attention_lse_ref(q, k, causal=causal, scale=scale),
               LSE_TOL[dtype])
    # The forward's output does not depend on whether lse is written.
    want, none = tflash._kernel_forward(q, k, v, causal, scale)
    assert none is None and torch.equal(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (8, 256, 16, 8, 128), (8, 256, 16, 8, 64), (1, 333, 16, 8, 128),
    (2, 65, 4, 4, 64), (1, 77, 8, 1, 16), (2, 130, 4, 2, 32),
    (1, 1, 2, 1, 64)])
def test_flash_bwd_kernel_matches_plain(cuda, dtype, causal, b, s, hq, hkv,
                                        d):
    """Groups 1, 2, 4 and 8, ragged lengths, every head dim, the training
    shape at internlm2's and granite-moe's head dims; the plain backward
    gets the kernel forward's output and log-sum-exp. bf16 at d 64 and 128
    runs the wgmma kernels, the rest the CUDA-core ones."""
    q, k, v, dout = _attn_inputs(cuda, dtype, b, s, s, hq, hkv, d)
    scale = 1.0 / d ** 0.5
    out, lse = tflash._kernel_forward(q, k, v, causal, scale, with_lse=True)
    got = tflash._kernel_backward(q, k, v, out, dout, lse, causal, scale)
    torch.cuda.synchronize()
    want = tflash.plain_bwd(q, k, v, out, dout, lse, causal=causal,
                            scale=scale)
    for g, w_, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _rel_close(g, w_, 1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (2, 200, 8, 8, 96), (2, 200, 8, 8, 80), (2, 200, 8, 1, 256),
    (2, 200, 8, 8, 100), (1, 77, 4, 2, 40), (1, 77, 4, 2, 136),
    (1, 77, 4, 2, 250), (1, 65, 4, 2, 8), (1, 65, 2, 1, 1)])
def test_flash_kernels_at_padded_head_dims(cuda, dtype, causal, b, s, hq,
                                           hkv, d):
    """Forward and backward at head dims between the instantiated ones
    and at 256, on the route ``fwd_design`` names (bf16 with whole
    16-byte rows above 32 on the wgmma kernels), against the plain
    versions."""
    q, k, v, dout = _attn_inputs(cuda, dtype, b, s, s, hq, hkv, d)
    scale = 1.0 / d ** 0.5
    out, lse = tflash._kernel_forward(q, k, v, causal, scale, with_lse=True)
    got = tflash._kernel_backward(q, k, v, out, dout, lse, causal, scale)
    torch.cuda.synchronize()
    tol = GPU_TOL[dtype]
    torch.testing.assert_close(
        out.float(), tflash.plain(q, k, v, causal=causal,
                                  scale=scale).float(), rtol=tol, atol=tol)
    want = tflash.plain_bwd(q, k, v, out, dout, lse, causal=causal,
                            scale=scale)
    for g, w_ in zip(got, want):
        _rel_close(g, w_, 1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.gpu
def test_flash_refuses_head_dim_0(cuda):
    q = _randn((1, 8, 2, 0), torch.bfloat16, cuda, 0)
    before = tflash.KERNEL.launches
    with pytest.raises(ValueError, match="head_dim 0"):
        tflash.flash_attention(q, q, q)
    assert tflash.KERNEL.launches == before


# Above 256: every shape in both dtypes (bf16 at 288 and 512 on the
# tensor-core column tiles, the rest on the CUDA-core ones), then bf16 on
# the tensor-core ones at d 264, 320, 384 and 576 (two and three tiles of
# 192): groups 1, 4 and 8, sq and skv of 1, 65 and 333, causal and full.
WIDE_FLASH_CASES = [
    (dtype, *case) for dtype in (torch.float32, torch.bfloat16)
    for case in ((2, 130, 130, 4, 4, 257, True),
                 (2, 130, 130, 4, 4, 257, False),
                 (1, 200, 200, 4, 1, 288, True),
                 (1, 200, 200, 4, 1, 288, False),
                 (2, 77, 77, 2, 2, 512, True), (2, 77, 77, 2, 2, 512, False),
                 (1, 65, 200, 2, 1, 300, False))] + [
    (torch.bfloat16, *case) for case in (
        (2, 65, 65, 4, 1, 264, True), (2, 65, 333, 4, 1, 264, False),
        (1, 333, 65, 4, 4, 320, False), (2, 1, 1, 4, 4, 320, True),
        (1, 1, 333, 8, 8, 384, False), (1, 333, 333, 8, 2, 384, True),
        (1, 333, 333, 8, 1, 576, True), (1, 333, 333, 8, 1, 576, False))]
# Route "wide" (the CUDA-core column tiles, S summed once per cluster):
# fp32 at three tiles on one kv head, at four tiles (d 1000, skv above
# sq), and at nine tiles in two clusters of 8 (d 2100, the second
# cluster's blocks past the last tile storing nothing); bf16 above 768.
WIDE_SIMT_CASES = [
    (dtype, *case, causal) for dtype, case in (
        (torch.float32, (1, 333, 333, 8, 1, 576)),
        (torch.float32, (1, 65, 130, 2, 2, 1000)),
        (torch.float32, (1, 40, 40, 2, 1, 2100)),
        (torch.bfloat16, (1, 130, 77, 4, 2, 800)))
    for causal in (True, False)]
WIDE_FLASH_CASES += WIDE_SIMT_CASES
# Route "wide" at one tile (fp32 at d 33-256): every tile width (64, 128,
# 192, 256), 16-byte and element copies, groups 1, 2, 4 and 8 at 8/1,
# 8/2 and 32/8 heads, the dK/dV walk in one part and in several (8/1,
# 8/2), sq above and below skv, causal and full.
ONE_TILE_CASES = [
    (torch.float32, *case) for case in (
        (1, 130, 200, 8, 1, 33, False), (2, 65, 65, 8, 1, 33, True),
        (1, 200, 65, 8, 2, 64, False), (2, 130, 130, 8, 2, 64, True),
        (1, 77, 200, 32, 8, 96, False), (1, 200, 200, 32, 8, 96, True),
        (2, 130, 130, 8, 2, 99, True), (1, 65, 130, 8, 2, 99, False),
        (1, 333, 333, 8, 1, 100, True), (1, 130, 77, 8, 8, 100, False),
        (1, 130, 130, 32, 8, 160, True), (1, 200, 130, 32, 8, 160, False),
        (2, 256, 256, 8, 1, 256, True), (1, 65, 333, 8, 1, 256, False),
        (1, 1, 1, 8, 2, 64, True), (8, 256, 256, 8, 1, 256, True))]


def _check_flash_against_plain(dtype, b, sq, skv, hq, hkv, d, causal,
                               cuda):
    """Forward with its lse and backward against the plain versions; one
    launch each; the backward bitwise repeatable."""
    q, k, v, dout = _attn_inputs(cuda, dtype, b, sq, skv, hq, hkv, d)
    scale = d ** -0.5
    before = (tflash.KERNEL.launches, tflash.KERNEL_BWD.launches)
    out, lse = tflash._kernel_forward(q, k, v, causal, scale, with_lse=True)
    got = tflash._kernel_backward(q, k, v, out, dout, lse, causal, scale)
    again = tflash._kernel_backward(q, k, v, out, dout, lse, causal, scale)
    torch.cuda.synchronize()
    assert (tflash.KERNEL.launches, tflash.KERNEL_BWD.launches) == \
        (before[0] + 1, before[1] + 2)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    tol = GPU_TOL[dtype]
    torch.testing.assert_close(
        out.float(), tflash.plain(q, k, v, causal=causal,
                                  scale=scale).float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, attention_lse_ref(
        q, k, causal=causal, scale=scale), rtol=1e-5, atol=1e-5)
    want = tflash.plain_bwd(q, k, v, out, dout, lse, causal=causal,
                            scale=scale)
    for g, w_ in zip(got, want):
        _rel_close(g, w_, 1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b,sq,skv,hq,hkv,d,causal", WIDE_FLASH_CASES)
def test_flash_above_256_forward_and_backward_match_plain(
        cuda, dtype, b, sq, skv, hq, hkv, d, causal):
    """The column-tile kernels of both routes, forward with its lse and
    backward, against the plain versions; one launch each; the backward
    bitwise repeatable."""
    _check_flash_against_plain(dtype, b, sq, skv, hq, hkv, d, causal, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b,sq,skv,hq,hkv,d,causal", ONE_TILE_CASES)
def test_flash_wide_one_tile_matches_plain(cuda, dtype, b, sq, skv, hq, hkv,
                                           d, causal):
    """Route "wide" at one tile (fp32, d 33-256), forward with its lse and
    backward, against the plain versions; one launch each; the backward
    (in one part or several) bitwise repeatable."""
    assert tflash.fwd_design(dtype, d) == "wide"
    assert tflash.simt_wide_plan(d)["tiles"] == 1
    _check_flash_against_plain(dtype, b, sq, skv, hq, hkv, d, causal, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b,sq,skv,hq,hkv,d,causal", [
    c for c in WIDE_FLASH_CASES + ONE_TILE_CASES
    if tflash.fwd_design(c[0], c[6]) == "wide"])
def test_flash_wide_replays_in_a_cuda_graph_and_writes_nothing_past_d(
        cuda, dtype, b, sq, skv, hq, hkv, d, causal):
    """Route "wide": the profiler names its three column-tile kernels (and
    delta's pass, and where the dK/dV walk runs in parts their sum) and no
    other route's; o, dq, dk and dv carved from the front of larger
    buffers that hold a canary keep it in each tail (a store past d in the
    last row, or by a cluster's blocks past the last tile, would land
    there) and equal the wrapper's own; forward and backward captured once
    in a CUDA graph and replayed after the inputs change in place equal
    eager calls on the new inputs bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels._build import dtype_code, stream_handle
    assert tflash.fwd_design(dtype, d) == tflash.bwd_design(dtype, d) == \
        "wide"
    q, k, v, dout = _attn_inputs(cuda, dtype, b, sq, skv, hq, hkv, d)
    scale = tflash._scale(q, None)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, lse = tflash._kernel_forward(q, k, v, causal, scale,
                                          with_lse=True)
        dq, dk, dv = tflash._kernel_backward(q, k, v, out, dout, lse, causal,
                                             scale)
        torch.cuda.synchronize()
    names = " ".join(e.key for e in prof.key_averages())
    assert all(n in names for n in (
        "flash_fwd_wide_kernel", "flash_bwd_dkdv_wide_kernel",
        "flash_bwd_dq_wide_kernel", "flash_bwd_preprocess_rows")), names
    assert "wgmma" not in names and "stage_rows" not in names, names
    parts = tflash.simt_wide_kv_parts(b, skv, hq, hkv, d)
    assert ("flash_bwd_parts_sum_kernel" in names) == (parts > 1), names

    def carve(t):
        buf = torch.full((t.numel() + 300,), -7.0, dtype=dtype, device=cuda)
        return buf, buf[:t.numel()].view(t.shape)
    (ob, o2), (qb, dq2), (kb, dk2), (vb, dv2) = (
        carve(t) for t in (out, dq, dk, dv))
    lse2, delta = torch.empty_like(lse), torch.empty_like(lse)
    ints = (b, sq, skv, hq, hkv, d, scale, int(causal), dtype_code(q),
            stream_handle(q.device))
    tflash.KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), o2.data_ptr(),
                  lse2.data_ptr(), None, *ints)
    scratch = (torch.empty(tflash.wide_parts_numel(b, skv, hq, hkv, d),
                           device=cuda) if parts > 1 else None)
    tflash.KERNEL_BWD(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                      delta.data_ptr(), dq2.data_ptr(), dk2.data_ptr(),
                      dv2.data_ptr(),
                      None if scratch is None else scratch.data_ptr(),
                      *ints)
    torch.cuda.synchronize()
    for buf, got, want in ((ob, o2, out), (qb, dq2, dq), (kb, dk2, dk),
                           (vb, dv2, dv)):
        assert (buf[got.numel():] == -7.0).all()
        assert torch.equal(got, want)
    assert torch.equal(lse2, lse)

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out, g_lse = tflash._kernel_forward(q, k, v, causal, scale,
                                              with_lse=True)
        g_grads = tflash._kernel_backward(q, k, v, g_out, dout, g_lse,
                                          causal, scale)
    for seed in (10, 20):
        for i, t in enumerate((q, k, v, dout)):
            t.copy_(_randn(t.shape, dtype, cuda, seed + i))
        graph.replay()
        torch.cuda.synchronize()
        w_out, w_lse = tflash._kernel_forward(q, k, v, causal, scale,
                                              with_lse=True)
        w_grads = tflash._kernel_backward(q, k, v, w_out, dout, w_lse,
                                          causal, scale)
        torch.cuda.synchronize()
        assert torch.equal(g_out, w_out) and torch.equal(g_lse, w_lse)
        assert all(torch.equal(a, b_) for a, b_ in zip(g_grads, w_grads))


# bf16 head dims from 33 to 256 that are not whole 16-byte rows: the
# backward's "wgmma_staged" route at each padded D (64, 128, 160, 256),
# odd and even d, groups 1-4, ragged and unequal lengths.
STAGED_FLASH_CASES = [
    (8, 256, 256, 8, 8, 100, True), (8, 256, 256, 8, 2, 99, True),
    (2, 65, 65, 4, 1, 36, True), (1, 333, 333, 8, 2, 76, False),
    (1, 65, 333, 4, 4, 130, False), (1, 333, 65, 4, 4, 250, True),
    (2, 1, 1, 4, 4, 99, True), (1, 200, 200, 4, 1, 255, True),
    (1, 100, 100, 2, 2, 33, False), (1, 129, 129, 4, 2, 161, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", STAGED_FLASH_CASES)
def test_flash_staged_backward_matches_plain(cuda, b, sq, skv, hq, hkv, d,
                                             causal):
    """The staged route: one launch a call, against the plain backward at
    the bf16 tolerance of d 128 (1e-2 of 1 + max-abs), bitwise repeatable,
    and the same through autograd."""
    assert tflash.bwd_design(torch.bfloat16, d) == "wgmma_staged"
    q, k, v, dout = _attn_inputs(cuda, torch.bfloat16, b, sq, skv, hq, hkv,
                                 d)
    scale = tflash._scale(q, None)      # the wrapper's, bit for bit
    out, lse = tflash._kernel_forward(q, k, v, causal, scale, with_lse=True)
    before = tflash.KERNEL_BWD.launches
    got = tflash._kernel_backward(q, k, v, out, dout, lse, causal, scale)
    again = tflash._kernel_backward(q, k, v, out, dout, lse, causal, scale)
    torch.cuda.synchronize()
    assert tflash.KERNEL_BWD.launches == before + 2
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    want = tflash.plain_bwd(q, k, v, out, dout, lse, causal=causal,
                            scale=scale)
    for g, w_, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _rel_close(g, w_, 1e-2)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    auto = torch.autograd.grad(ops.attention(*leaves, causal=causal),
                               leaves, dout)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(auto, got))


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", STAGED_FLASH_CASES)
def test_flash_staged_forward_matches_plain(cuda, b, sq, skv, hq, hkv, d,
                                            causal):
    """The staged route's forward (bf16, d 33-256 not a multiple of 8, at
    d 99, 100 and 250 among others): the profiler names the copy and the
    wgmma forward and no CUDA-core kernel; one launch a call, against the
    plain forward at the bf16 tolerance, its lse against the plain one;
    an output carved from the front of a larger buffer keeps a canary in
    its tail (a store past d in the last row would land there) and equals
    the wrapper's own; a CUDA graph's replay equals an eager call."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels._build import dtype_code, stream_handle
    bf16 = torch.bfloat16
    assert tflash.fwd_design(bf16, d) == "wgmma_staged"
    q, k, v, _ = _attn_inputs(cuda, bf16, b, sq, skv, hq, hkv, d)
    scale = tflash._scale(q, None)
    before = tflash.KERNEL.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, lse = tflash._kernel_forward(q, k, v, causal, scale,
                                          with_lse=True)
        torch.cuda.synchronize()
    assert tflash.KERNEL.launches == before + 1
    names = " ".join(e.key for e in prof.key_averages())
    assert "flash_fwd_wgmma_kernel" in names and \
        "flash_stage_rows_group_kernel" in names, names
    assert "simt" not in names and "wide" not in names, names
    torch.testing.assert_close(
        out.float(), tflash.plain(q, k, v, causal=causal,
                                  scale=scale).float(), rtol=2e-2, atol=2e-2)
    _rel_close(lse, attention_lse_ref(q, k, causal=causal, scale=scale),
               LSE_TOL[bf16])
    buf = torch.full((out.numel() + 300,), -7.0, dtype=bf16, device=cuda)
    o2 = buf[:out.numel()].view(out.shape)
    scratch = torch.empty(tflash.staged_scratch_numel(
        b, sq, skv, hq, hkv, d, forward=True), dtype=bf16, device=cuda)
    tflash.KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), o2.data_ptr(),
                  None, scratch.data_ptr(), b, sq, skv, hq, hkv, d, scale,
                  int(causal), dtype_code(q), stream_handle(q.device))
    torch.cuda.synchronize()
    assert (buf[out.numel():] == -7.0).all() and torch.equal(o2, out)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out, _ = tflash._kernel_forward(q, k, v, causal, scale)
    for t in (q, k, v):
        t.copy_(_randn(t.shape, bf16, cuda, 9))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(g_out, tflash._kernel_forward(q, k, v, causal,
                                                     scale)[0])


# bf16 head dims above 256 that are not whole 16-byte rows: route
# "wgmma_wide_staged", forward and backward, at odd and even d, one kv head
# and groups of 1 to 5, one to four column tiles of 192 and 256, lengths
# that are not multiples of 64, sq above and below skv.
WIDE_STAGED_HEADS = [(5, 1, 257), (4, 4, 263), (8, 2, 300), (2, 2, 767)]
WIDE_STAGED_CASES = [(b, sq, skv, hq, hkv, d, causal)
                     for hq, hkv, d in WIDE_STAGED_HEADS
                     for b, sq, skv in ((2, 130, 130), (1, 130, 77))
                     for causal in (True, False)]
WIDE_STAGED_KERNELS = ("flash_stage_rows_kernel",
                       "flash_fwd_wgmma_wide_kernel",
                       "flash_bwd_dkdv_wgmma_wide_kernel",
                       "flash_bwd_dq_wgmma_wide_kernel")


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", WIDE_STAGED_CASES)
def test_flash_wide_staged_matches_plain(cuda, b, sq, skv, hq, hkv, d,
                                         causal):
    """The staged route above 256: one launch a call each way, which by
    the profiler's kernel names runs the copy and the tensor-core column
    tiles and never the CUDA-core ones or delta's own pass; the forward
    and its lse against the plain version, the backward against the plain
    backward at the staged route's tolerance below 256 (1e-2 of 1 +
    max-abs); both bitwise repeatable."""
    from torch.profiler import ProfilerActivity, profile
    bf16 = torch.bfloat16
    assert tflash.fwd_design(bf16, d) == tflash.bwd_design(bf16, d) == \
        "wgmma_wide_staged"
    q, k, v, dout = _attn_inputs(cuda, bf16, b, sq, skv, hq, hkv, d)
    scale = tflash._scale(q, None)      # the wrapper's, bit for bit
    before = (tflash.KERNEL.launches, tflash.KERNEL_BWD.launches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, lse = tflash._kernel_forward(q, k, v, causal, scale,
                                          with_lse=True)
        got = tflash._kernel_backward(q, k, v, out, dout, lse, causal, scale)
        torch.cuda.synchronize()
    out2, lse2 = tflash._kernel_forward(q, k, v, causal, scale,
                                        with_lse=True)
    again = tflash._kernel_backward(q, k, v, out, dout, lse, causal, scale)
    torch.cuda.synchronize()
    assert (tflash.KERNEL.launches, tflash.KERNEL_BWD.launches) == \
        (before[0] + 2, before[1] + 2)
    names = " ".join(e.key for e in prof.key_averages())
    assert all(n in names for n in WIDE_STAGED_KERNELS), names
    assert not any(n in names for n in (
        "flash_fwd_wide_kernel", "flash_bwd_dkdv_wide_kernel",
        "flash_bwd_dq_wide_kernel", "flash_bwd_preprocess")), names
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    tol = GPU_TOL[bf16]
    torch.testing.assert_close(
        out.float(), tflash.plain(q, k, v, causal=causal,
                                  scale=scale).float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, attention_lse_ref(
        q, k, causal=causal, scale=scale), rtol=LSE_TOL[bf16],
        atol=LSE_TOL[bf16])
    want = tflash.plain_bwd(q, k, v, out, dout, lse, causal=causal,
                            scale=scale)
    for g, w_, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _rel_close(g, w_, 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,d", WIDE_STAGED_HEADS)
def test_flash_wide_staged_replays_in_a_cuda_graph(cuda, hq, hkv, d):
    """Forward and backward captured once (the copies' scratch from the
    graph's pool, the tensor maps by value) and replayed after the inputs
    change in place: each replay equals eager calls on the new inputs bit
    for bit."""
    bf16 = torch.bfloat16
    q, k, v, dout = _attn_inputs(cuda, bf16, 2, 130, 130, hq, hkv, d)
    scale = tflash._scale(q, None)
    out, lse = tflash._kernel_forward(q, k, v, True, scale, with_lse=True)
    tflash._kernel_backward(q, k, v, out, dout, lse, True, scale)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out, g_lse = tflash._kernel_forward(q, k, v, True, scale,
                                              with_lse=True)
        g_grads = tflash._kernel_backward(q, k, v, g_out, dout, g_lse, True,
                                          scale)
    for seed in (10, 20):
        for i, t in enumerate((q, k, v, dout)):
            t.copy_(_randn(t.shape, bf16, cuda, seed + i))
        graph.replay()
        torch.cuda.synchronize()
        w_out, w_lse = tflash._kernel_forward(q, k, v, True, scale,
                                              with_lse=True)
        w_grads = tflash._kernel_backward(q, k, v, w_out, dout, w_lse, True,
                                          scale)
        torch.cuda.synchronize()
        assert torch.equal(g_out, w_out) and torch.equal(g_lse, w_lse)
        assert all(torch.equal(a, b_) for a, b_ in zip(g_grads, w_grads))


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,d", WIDE_STAGED_HEADS)
def test_flash_wide_staged_writes_nothing_past_d(cuda, hq, hkv, d):
    """o, dq, dk and dv carved from the front of larger buffers that hold a
    canary value: each buffer's tail keeps it (a store past d in the last
    row would land there), and each output equals the wrapper's own. The
    route refuses to run without its scratch (the call raises), where the
    CUDA-core column tiles would have served it."""
    from repro_torch.kernels._build import dtype_code, stream_handle
    bf16 = torch.bfloat16
    b, sq, skv = 1, 130, 77
    q, k, v, dout = _attn_inputs(cuda, bf16, b, sq, skv, hq, hkv, d)
    scale = tflash._scale(q, None)
    out, lse = tflash._kernel_forward(q, k, v, True, scale, with_lse=True)
    dq, dk, dv = tflash._kernel_backward(q, k, v, out, dout, lse, True,
                                         scale)

    def carve(t):
        buf = torch.full((t.numel() + 64,), -7.0, dtype=bf16, device=cuda)
        return buf, buf[:t.numel()].view(t.shape)
    (ob, o2), (qb, dq2), (kb, dk2), (vb, dv2) = (
        carve(t) for t in (out, dq, dk, dv))
    lse2 = torch.empty_like(lse)
    delta = torch.empty_like(lse)
    f_scratch = torch.empty(tflash.staged_scratch_numel(
        b, sq, skv, hq, hkv, d, forward=True), dtype=bf16, device=cuda)
    b_scratch = torch.empty(tflash.staged_scratch_numel(
        b, sq, skv, hq, hkv, d), dtype=bf16, device=cuda)
    stream = stream_handle(q.device)
    ints = (b, sq, skv, hq, hkv, d, scale, 1, dtype_code(q), stream)
    tflash.KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), o2.data_ptr(),
                  lse2.data_ptr(), f_scratch.data_ptr(), *ints)
    tflash.KERNEL_BWD(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                      delta.data_ptr(), dq2.data_ptr(), dk2.data_ptr(),
                      dv2.data_ptr(), b_scratch.data_ptr(), *ints)
    torch.cuda.synchronize()
    for buf, got, want in ((ob, o2, out), (qb, dq2, dq), (kb, dk2, dk),
                           (vb, dv2, dv)):
        assert (buf[got.numel():] == -7.0).all()
        assert torch.equal(got, want)
    assert torch.equal(lse2, lse)
    before = (tflash.KERNEL.launches, tflash.KERNEL_BWD.launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        tflash.KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      o2.data_ptr(), lse2.data_ptr(), None, *ints)
    with pytest.raises(RuntimeError, match="launch failed"):
        tflash.KERNEL_BWD(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                          delta.data_ptr(), dq2.data_ptr(), dk2.data_ptr(),
                          dv2.data_ptr(), None, *ints)
    assert (tflash.KERNEL.launches, tflash.KERNEL_BWD.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,d,lengths", [
    (8, 1, 256, [129, 334, 517, 731]), (8, 1, 256, [0, 1, 129, 731]),
    (1, 1, 256, [0, 1, 129, 731]), (5, 1, 256, [0, 1, 129, 731]),
    (16, 1, 256, [0, 1, 129, 731]), (71, 1, 256, [0, 1, 129, 731]),
    (16, 8, 256, [740, 0, 64, 65]), (8, 1, 168, [129, 334, 517, 731]),
    (8, 2, 200, [740, 0, 33, 64]), (4, 1, 248, [32, 33, 31, 1])])
def test_decode_mma_route_matches_plain(cuda, hq, hkv, d, lengths):
    """bf16 at D 256 with d a multiple of 8 (route "mma"): one launch a
    call in each mode, against the plain version (out at GPU_TOL, the
    lse at 1e-5), the same out in both modes, -inf at length 0; and no
    row at or past length is read (NaN there changes nothing)."""
    skv = 740
    assert tdecode.pv_layout(2, d, hq // hkv)["route"] == "mma"
    q = _randn((4, hq, d), torch.bfloat16, cuda, 0)
    k = _randn((4, skv, hkv, d), torch.bfloat16, cuda, 1)
    v = _randn((4, skv, hkv, d), torch.bfloat16, cuda, 2)
    length = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = tdecode.KERNEL.launches
    out = tdecode.decode_attention(q, k, v, length)
    out2, lse = tdecode.decode_attention(q, k, v, length, return_lse=True)
    torch.cuda.synchronize()
    assert tdecode.KERNEL.launches == before + 2
    want, want_lse = tdecode.plain(q, k, v, length, return_lse=True)
    tol = GPU_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(out, out2)
    fin = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], want_lse[fin], rtol=1e-5, atol=1e-5)
    for i, n in enumerate(lengths):
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    assert torch.equal(tdecode.decode_attention(q, k, v, length), out)


@pytest.mark.gpu
def test_decode_mma_route_replays_in_a_cuda_graph(cuda):
    """gemma-2b's 8/1 at d 256 on route "mma", captured once and replayed
    with `length` changed in place: each replay matches the plain version,
    two replays agree (the combine counters are back at 0), and rows past
    length, set to NaN, are never read."""
    b, skv, hq, hkv, d = 4, 740, 8, 1, 256
    q = _randn((b, hq, d), torch.bfloat16, cuda, 0)
    k = _randn((b, skv, hkv, d), torch.bfloat16, cuda, 1)
    v = _randn((b, skv, hkv, d), torch.bfloat16, cuda, 2)
    length = torch.tensor([129, 334, 517, 731], dtype=torch.int32,
                          device=cuda)
    tdecode.decode_attention(q, k, v, length)      # warm-up: counter, build
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tdecode.decode_attention(q, k, v, length)
    tol = GPU_TOL[torch.bfloat16]
    for lens in ([1, 2, 3, 4], [740, 0, 64, 65], [700, 600, 500, 400]):
        length.copy_(torch.tensor(lens, dtype=torch.int32))
        want = tdecode.plain(q, k, v, length)
        want = torch.where(length[:, None, None] == 0, 0.0, want.float())
        k_past, v_past = k.clone(), v.clone()
        for i, n in enumerate(lens):
            k[i, n:] = float("nan")
            v[i, n:] = float("nan")
        graph.replay()
        torch.cuda.synchronize()
        first = out.clone()
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, first, rtol=0, atol=0)
        torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol)
        k.copy_(k_past)
        v.copy_(v_past)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv", [(65, 200), (200, 65)])
def test_flash_bwd_kernel_full_attention_skv_differs(cuda, dtype, sq, skv):
    q, k, v, dout = _attn_inputs(cuda, dtype, 2, sq, skv, 4, 2, 64)
    out, lse = tflash._kernel_forward(q, k, v, False, 0.125, with_lse=True)
    got = tflash._kernel_backward(q, k, v, out, dout, lse, False, 0.125)
    torch.cuda.synchronize()
    want = tflash.plain_bwd(q, k, v, out, dout, lse, causal=False,
                            scale=0.125)
    for g, w_ in zip(got, want):
        _rel_close(g, w_, 1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("d,hq", [(128, 16), (64, 16), (160, 32)])
def test_flash_bwd_wgmma_is_bitwise_repeatable(cuda, d, hq):
    """Two calls at the training shape give the same gradients bit for bit:
    no block adds into another's output, so a resumed run repeats."""
    q, k, v, dout = _attn_inputs(cuda, torch.bfloat16, 8, 256, 256, hq, 8, d)
    scale = d ** -0.5
    out, lse = tflash._kernel_forward(q, k, v, True, scale, with_lse=True)
    first = tflash._kernel_backward(q, k, v, out, dout, lse, True, scale)
    second = tflash._kernel_backward(q, k, v, out, dout, lse, True, scale)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 160),
                                     (torch.bfloat16, 32),
                                     (torch.bfloat16, 100),
                                     (torch.bfloat16, 99),
                                     (torch.float32, 128),
                                     (torch.float32, 160)])
def test_flash_bwd_launches_the_kernels_of_its_design(cuda, dtype, d):
    """By the profiler's kernel names: bf16 at d 64/128/160 runs the wgmma
    kernels and never the CUDA-core ones; at d 100 and 99 the staging copy
    (which writes delta) and the wgmma kernels; fp32 above 32 route
    "wide"'s tiles after delta's pass a warp a row; bf16 at 32 the
    CUDA-core kernels."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v, dout = _attn_inputs(cuda, dtype, 2, 130, 130, 8, 4, d)
    scale = d ** -0.5
    out, lse = tflash._kernel_forward(q, k, v, True, scale, with_lse=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tflash._kernel_backward(q, k, v, out, dout, lse, True, scale)
        torch.cuda.synchronize()
    names = " ".join(e.key for e in prof.key_averages())
    wgmma = ("flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel")
    simt = ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")
    wide = ("flash_bwd_dkdv_wide_kernel", "flash_bwd_dq_wide_kernel",
            "flash_bwd_preprocess_rows_kernel")
    design = tflash.bwd_design(dtype, d)
    want, never = {"wgmma": (wgmma, simt + wide),
                   "simt": (simt, wgmma + wide),
                   "wide": (wide, wgmma + simt),
                   "wgmma_staged": (wgmma + ("flash_stage_rows_group_kernel",),
                                    simt + wide + ("flash_bwd_preprocess",))
                   }[design]
    if design in ("wgmma", "simt"):
        assert "flash_bwd_preprocess_kernel" in names
    assert all(n in names for n in want), names
    assert not any(n in names for n in never), names


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_runs_the_backward_kernel(cuda, dtype):
    """Through ops.attention under grad: one forward and one backward
    launch, gradients equal to the plain backward's and bitwise
    repeatable."""
    q, k, v, dout = _attn_inputs(cuda, dtype, 2, 100, 100, 8, 4, 128)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.reset_launches()
    out = ops.attention(*leaves, causal=True)
    out.backward(dout)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_bwd"] == 1
    out2, lse = tflash._kernel_forward(q, k, v, True, 128 ** -0.5,
                                       with_lse=True)
    want = tflash.plain_bwd(q, k, v, out2, dout, lse, causal=True)
    again = tflash._kernel_backward(q, k, v, out2, dout, lse, True,
                                    128 ** -0.5)
    for t, w_, a in zip(leaves, want, again):
        _rel_close(t.grad, w_, 1e-5 if dtype == torch.float32 else 1e-2)
        assert torch.equal(t.grad, a)


@pytest.mark.gpu
def test_kernels_without_backward_raise_under_grad(cuda):
    """decode_attention and int8_matmul refuse to run where autograd would
    record them; under no_grad they run, and so does ssd_scan, whose
    backward is a kernel."""
    q = _randn((2, 4, 64), torch.float32, cuda, 0).requires_grad_(True)
    kv = _randn((2, 16, 2, 64), torch.float32, cuda, 1)
    length = torch.tensor([3, 16], dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError):
        ops.decode_attention(q, kv, kv, length)
    x, dt, A, B, C, D = _ssd_inputs(1, 8, 2, 16, 16, torch.float32, cuda)
    xq, sx, wq, sw = _int8_operands(4, 32, 16, cuda)
    with pytest.raises(NotImplementedError):
        ops.int8_matmul(xq, sx.requires_grad_(True), wq, sw)
    with torch.no_grad():
        ops.decode_attention(q, kv, kv, length)
        ops.ssd(x, dt, A, B, C, D, chunk=8)
        ops.int8_matmul(xq, sx, wq, sw)


@pytest.mark.gpu
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_smoke_training_grads_on_card_match_cpu(cuda, remat):
    """loss_fn and its gradient for the smoke-size fp32 model through the
    forward and backward kernels (d 16, hq/hkv 2) against the same weights
    on the CPU; remat "dots" checkpoints selectively around the kernels'
    autograd Functions."""
    from repro_torch.config import get_config, smoke_config
    from repro_torch.models import model as lm
    from repro_torch.tree import tree_leaves, tree_map
    cfg = smoke_config(get_config("internlm2-1.8b")).replace(dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    toks = torch.randint(0, cfg.vocab_size, (2, 71),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": torch.ones((2, 70))}
    out = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t, d=dev: t.to(d, copy=True).requires_grad_(True),
                     params)
        ops.reset_launches()
        loss, _ = lm.loss_fn(p, cfg, {k: v.to(dev) for k, v in batch.items()},
                             remat=remat)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        out[str(dev)] = (loss.item(), [g.cpu() for g in grads],
                         ops.launch_counts())
    (l_cpu, g_cpu, _), (l_gpu, g_gpu, counts) = out["cpu"], out["cuda"]
    n = cfg.num_layers
    fwd = 2 if remat == "none" else 4        # rmsnorms a layer
    assert counts["rmsnorm_bwd"] == 2 * n + 1
    assert counts["flash_attention_bwd"] == n
    assert counts["rmsnorm"] == fwd * n + 1
    assert counts["flash_attention"] == (1 if remat == "none" else 2) * n
    assert abs(l_gpu - l_cpu) <= 1e-5 * max(1.0, abs(l_cpu))
    for a, c in zip(g_gpu, g_cpu):
        assert (a - c).abs().max() <= 1e-4 * c.abs().max()


SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("b,s,h,p,n", [(2, 256, 4, 64, 128),
                                       (1, 101, 3, 128, 128),
                                       (2, 129, 2, 20, 33),
                                       (1, 64, 2, 16, 256)])
def test_ssd_bwd_kernel_matches_plain(cuda, dtype, with_state, b, s, h, p,
                                      n):
    """One call of the backward kernels against the closed form: dx, dB
    and dC rounded once (one ulp in bf16), the fp32 gradients at 2e-4 of
    their max-abs (64-step tiles against the plain version's chunk);
    mamba2's and jamba's heads, a ragged s, n and p off every chunk, n at
    its limit; a second call is bitwise the same."""
    args = _ssd_inputs(b, s, h, p, n, dtype, cuda)
    dy = _randn((b, s, h, p), dtype, cuda, 5)
    ds = _randn((b, h, p, n), torch.float32, cuda, 6) if with_state else None
    before = tssd.KERNEL_BWD.launches
    got = tssd._kernel_backward(*args, dy, ds)
    torch.cuda.synchronize()
    assert tssd.KERNEL_BWD.launches == before + 1
    want = tssd.plain_bwd(*args, dy, ds, chunk=256)
    again = tssd._kernel_backward(*args, dy, ds)
    for name, a, w, r in zip(SSD_GRADS, got, want, again):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        if dtype == torch.bfloat16 and name in ("dx", "dB", "dC"):
            tol = SSD_TOL[dtype]
            torch.testing.assert_close(a.float(), w.float(), rtol=tol,
                                       atol=tol)
        else:
            _rel_close(a, w, SSD_TOL[torch.float32])
        assert torch.equal(a, r), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_autograd_runs_the_backward_kernel(cuda, dtype):
    args = [a.requires_grad_(True) for a in
            _ssd_inputs(2, 256, 4, 64, 128, dtype, cuda)]
    dy = _randn((2, 256, 4, 64), dtype, cuda, 5)
    ops.reset_launches()
    y, _ = ops.ssd(*args, chunk=256)
    y.backward(dy)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["ssd_scan"] == 1 and counts["ssd_scan_bwd"] == 1
    want = tssd.plain_bwd(*(a.detach() for a in args), dy, None, chunk=256)
    for name, a, w in zip(SSD_GRADS, args, want):
        if dtype == torch.bfloat16 and name in ("dx", "dB", "dC"):
            tol = SSD_TOL[dtype]
            torch.testing.assert_close(a.grad.float(), w.float(), rtol=tol,
                                       atol=tol)
        else:
            _rel_close(a.grad, w, SSD_TOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_smoke_mamba_training_grads_on_card_match_cpu(cuda, remat):
    """loss_fn and its gradient for the smoke-size fp32 mamba2 through the
    ssd and rmsnorm kernels and their backward kernels against the same
    weights on the CPU (every leaf, A_log, dt_bias and D included)."""
    from repro_torch.config import get_config, smoke_config
    from repro_torch.models import model as lm
    from repro_torch.tree import tree_leaves, tree_map
    cfg = smoke_config(get_config("mamba2-130m")).replace(dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    toks = torch.randint(0, cfg.vocab_size, (2, 65),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": torch.ones((2, 64))}
    out = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t, d=dev: t.to(d, copy=True).requires_grad_(True),
                     params)
        ops.reset_launches()
        loss, _ = lm.loss_fn(p, cfg, {k: v.to(dev) for k, v in batch.items()},
                             remat=remat)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        out[str(dev)] = (loss.item(), [g.cpu() for g in grads],
                         ops.launch_counts())
    (l_cpu, g_cpu, _), (l_gpu, g_gpu, counts) = out["cpu"], out["cuda"]
    n = cfg.num_layers
    fwd = 1 if remat == "none" else 2
    assert counts["ssd_scan"] == fwd * n and counts["ssd_scan_bwd"] == n
    assert counts["rmsnorm"] == fwd * n + 1
    assert counts["rmsnorm_bwd"] == n + 1
    assert abs(l_gpu - l_cpu) <= 1e-5 * max(1.0, abs(l_cpu))
    for a, c in zip(g_gpu, g_cpu):
        assert torch.isfinite(a).all() and c.abs().max() > 0
        assert (a - c).abs().max() <= 1e-4 * c.abs().max()


# The SSD backward's tensor-core design against the closed form, at
# chip_smoke.py's SSD_BWD_TOL and SSD_BWD_LOWP: the fp32 gradients (ddt,
# dA, dD) within 2e-4 of their max-abs (64-step tiles against the plain
# version's chunk, sums over heads, batches and tiles in another order,
# operands with an fp32 factor as bf16 hi/lo pairs, about 2^-17 a term);
# dx, dB and dC, rounded once to bf16 by both, at one bf16 ulp.
SSD_BWD_TOL = 2e-4
SSD_BWD_LOWP = ("dx", "dB", "dC")


def _ssd_bwd_check(got, want):
    for name, a, w in zip(SSD_GRADS, got, want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        if a.dtype == torch.bfloat16 and name in SSD_BWD_LOWP:
            tol = SSD_TOL[torch.bfloat16]
            torch.testing.assert_close(a.float(), w.float(), rtol=tol,
                                       atol=tol)
        else:
            assert torch.isfinite(a).all(), name
            err = (a.float() - w.float()).abs().max().item()
            assert err <= SSD_BWD_TOL * w.float().abs().max().item(), \
                (name, err)


def _ssd_bwd_kernels(call) -> set:
    """Names of the CUDA kernels ``call`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA}


@pytest.mark.gpu
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [40, 64, 200, 256])
@pytest.mark.parametrize("n,p,h", [(16, 16, 1), (32, 64, 3), (48, 32, 5),
                                   (128, 64, 24), (128, 16, 7),
                                   (64, 48, 2)])
def test_ssd_bwd_tc_kernel_matches_plain(cuda, with_state, s, n, p, h):
    """The tensor-core backward (bf16, n and p multiples of 16, n <= 128,
    p <= 64): one tile, a tile exactly, ragged tiles and mamba2's four;
    n 16-128, p 16-64, 1-24 heads (groups of 1 to 4 blocks, the last
    group short at h 5 and 7); one launch counted, a second call bitwise
    the same."""
    b = 2
    assert tssd.bwd_design(torch.bfloat16, n, p) == tssd.TENSOR_CORES
    args = _ssd_inputs(b, s, h, p, n, torch.bfloat16, cuda)
    dy = _randn((b, s, h, p), torch.bfloat16, cuda, 5)
    ds = _randn((b, h, p, n), torch.float32, cuda, 6) if with_state else None
    before = tssd.KERNEL_BWD.launches
    got = tssd._kernel_backward(*args, dy, ds)
    torch.cuda.synchronize()
    assert tssd.KERNEL_BWD.launches == before + 1
    _ssd_bwd_check(got, tssd.plain_bwd(*args, dy, ds, chunk=256))
    again = tssd._kernel_backward(*args, dy, ds)
    for name, a, r in zip(SSD_GRADS, got, again):
        assert torch.equal(a, r), name


@pytest.mark.gpu
def test_ssd_bwd_tc_kernel_replays_in_a_cuda_graph(cuda):
    """The tensor-core backward captured once (scratch from the caching
    allocator, no sync inside), replayed with dy changed in place: each
    replay equals the closed form, and a replay of the first inputs gives
    the first result bit for bit."""
    b, s, h, p, n = 2, 256, 24, 64, 128
    args = _ssd_inputs(b, s, h, p, n, torch.bfloat16, cuda)
    dy = _randn((b, s, h, p), torch.bfloat16, cuda, 5)
    ds = _randn((b, h, p, n), torch.float32, cuda, 6)
    tssd._kernel_backward(*args, dy, ds)                # warm-up: build
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = tssd._kernel_backward(*args, dy, ds)
    first = None
    for seed in (7, 8, 7):
        dy.copy_(_randn(dy.shape, torch.bfloat16, cuda, seed))
        graph.replay()
        torch.cuda.synchronize()
        _ssd_bwd_check(got, tssd.plain_bwd(*args, dy, ds, chunk=256))
        if first is None:
            first = [g.clone() for g in got]
    for name, a, r in zip(SSD_GRADS, got, first):
        assert torch.equal(a, r), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,n,p,design", [
    (torch.bfloat16, 128, 64, "ssd_bwd_tc_local_kernel"),
    (torch.float32, 128, 64, "ssd_bwd_local_kernel"),
    (torch.bfloat16, 128, 128, "ssd_bwd_local_kernel"),     # jamba's p
    (torch.bfloat16, 256, 64, "ssd_bwd_local_kernel"),      # n past 128
    (torch.bfloat16, 40, 64, "ssd_bwd_local_kernel"),       # n off 16
])
def test_ssd_bwd_routes_by_dtype_and_shape(cuda, dtype, n, p, design):
    """bf16 at the tensor-core design's shapes launches its kernels; fp32,
    and bf16 where that design does not fit, the CUDA-core ones."""
    args = _ssd_inputs(1, 100, 3, p, n, dtype, cuda)
    dy = _randn((1, 100, 3, p), dtype, cuda, 5)
    names = _ssd_bwd_kernels(lambda: tssd._kernel_backward(*args, dy, None))
    assert any(design in nm for nm in names), names
    other = "ssd_bwd_local_kernel" if "_tc_" in design else "ssd_bwd_tc_"
    assert not any(other in nm for nm in names), names


@pytest.mark.gpu
def test_ssd_bwd_raises_where_no_design_fits(cuda):
    """d_state 0 and float16 raise before any launch; the tensor-core
    design asked for where it does not fit raises too."""
    args = list(_ssd_inputs(1, 64, 2, 16, 16, torch.float32, cuda))
    dy = _randn((1, 64, 2, 16), torch.float32, cuda, 5)
    before = tssd.KERNEL_BWD.launches
    with pytest.raises(ValueError):
        tssd._kernel_backward(*args, dy, None, tssd.TENSOR_CORES)
    big = list(args)
    big[3] = big[4] = torch.zeros((1, 64, 0), device=cuda)
    with pytest.raises(ValueError, match="d_state"):
        tssd._kernel_backward(*big, dy, None)
    half = [a.half() if i in (0, 3, 4) else a for i, a in enumerate(args)]
    with pytest.raises(TypeError):
        tssd._kernel_backward(*half, dy.half(), None)
    assert tssd.KERNEL_BWD.launches == before
