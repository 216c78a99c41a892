"""Flash prefill attention: the CUDA kernels ``csrc/flash_attention.cu`` and
their plain versions.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention`` of the
JAX package. A tensor on the CPU goes to the plain version
(``ref.attention_ref``); a CUDA tensor goes to the kernel, or the call
raises; a fake CUDA tensor to its fake path (checked, outputs
allocated, counted by the dry run, not launched). Any ``sq`` and ``skv``
are taken, any ``hq / hkv``, and any head_dim d >= 1, forward and
backward alike: up to ``MAX_HEAD_DIM`` (256) a call runs at
``padded_head_dim(d)``, the least of ``HEAD_DIMS`` (16, 32, 64, 128, 160,
256) at or above d, its columns past d zero; above it, on the column-tile
kernels at the real d. Only d < 1 raises.

Hand-written kernels of ``csrc/flash_attention.cu``,
``csrc/flash_attention_wide.cu`` and ``csrc/flash_attention_simt_wide.cu``
serve a CUDA tensor, one call of them counted as a launch of
``flash_attention``, on the route :func:`fwd_design` names:

* ``"wgmma"``, bf16 where d is a multiple of 8 above 32 (the serving path
  at 64, 128 and 160): ``flash_fwd_wgmma_kernel``, tensor cores (wgmma,
  fp32 accumulators, P rounded to bf16 for P.V) fed by TMA, 64-column
  boxes zero past d;
* ``"wgmma_staged"``, bf16 at a head dim that is not whole 16-byte rows (d
  not a multiple of 8) from 33 to 256: ``flash_stage_rows_group_kernel``
  copies q, k and v into a scratch of rows :func:`staged_ld` (d) elements
  long, columns past d zero, so the TMA maps' row stride is a multiple of
  16 bytes; then ``flash_fwd_wgmma_kernel`` at the padded D reads the
  copies (an instantiation of its own, which stores the output column by
  column at the real d);
* ``"simt"``, both dtypes at d up to ``SIMT_MAX_HEAD_DIM`` (32):
  ``flash_fwd_simt_kernel`` at D 16 or 32, full fp32 products on the CUDA
  cores;
* ``"wgmma_wide"``, bf16 above 256 where d is a multiple of 8 up to
  ``TC_WIDE_MAX_HEAD_DIM`` (768): ``flash_fwd_wgmma_wide_kernel``, tensor
  cores fed by TMA, a block a (q tile, q head, batch, column tile of 192
  or 256 output columns, ``wgmma_col_tiles(d, forward=True)``; two
  blocks an SM at 192): each recomputes S over the
  whole d from 64-column boxes streamed through a shared-memory ring by a
  producer warp, in the same order in every tile, and accumulates P.V for
  its own columns;
* ``"wgmma_wide_staged"``, bf16 above 256 where d is not a multiple of 8,
  up to ``TC_WIDE_MAX_HEAD_DIM``: ``flash_stage_rows_kernel`` copies q, k
  and v into a scratch of rows :func:`staged_ld` (d) elements long,
  columns past d zero, so the TMA maps' row stride is a multiple of 16
  bytes; then ``flash_fwd_wgmma_wide_kernel`` reads the copies, at the
  column tiles of d's ``"wgmma_wide"`` plan (an instantiation of its own,
  which stores the output column by column at the real d);
* ``"wide"``, fp32 above ``SIMT_MAX_HEAD_DIM`` and bf16 above
  ``TC_WIDE_MAX_HEAD_DIM``: ``flash_fwd_wide_kernel``, full fp32 products
  on the CUDA cores, a block a (q tile, q head, batch, column tile,
  :func:`simt_wide_plan`). Up to 256 one tile of 64, 128, 192 or 256
  columns holds the whole d; above it column tiles of 192 or 256, those of
  a row tile launched as a thread-block cluster of up to 8: each block
  computes the partial scores over its own slice of d, every block sums
  the cluster's partials in rank order through distributed shared memory
  (so S, m and l are bitwise equal across the tiles), then runs the online
  softmax and P.V over its own columns. The Q rows of a block's slice stay
  in shared memory for its whole walk (at one tile, and above it at d not
  a multiple of 4 up to 2048); pieces of K and
  chunks of V staged by cp.async (bf16 converted to fp32 once in shared
  memory) while the last is multiplied, register tiles fed by 128-bit
  shared loads.

Where autograd records the call (grad mode on, an input that requires
grad), it runs through :class:`FlashAttentionFunction`: the forward kernel
also writes each row's log-sum-exp, and the backward is one call, counted
as ``flash_attention_bwd``, of ``flash_bwd_preprocess_kernel`` (delta; the
staged routes' copy kernels write it instead, and route ``"wide"`` runs
``flash_bwd_preprocess_rows_kernel``) and two kernels on the route
:func:`bwd_design` names, which is the forward's at every shape:

* ``"wgmma"``, as the forward's (the training paths at 64, 128 and 160):
  ``flash_bwd_dkdv_wgmma_kernel`` and ``flash_bwd_dq_wgmma_kernel``,
  tensor cores (wgmma, fp32 accumulators, P and dS rounded to bf16 as
  operands) fed by TMA, deterministic (no atomics); D 160 and 256 in
  three and four boxes as the forward's, the dK/dV kernel on two
  warpgroups;
* ``"wgmma_staged"``, as the forward's: ``flash_stage_rows_group_kernel``
  copies q, k, v and dout and writes delta from the dout rows it copies;
  then the ``"wgmma"`` kernels at the padded D read the copies
  (instantiations of their own, which store dq, dk and dv column by
  column at the real d);
* ``"simt"``, both dtypes at d up to 32: ``flash_bwd_dkdv_kernel`` and
  ``flash_bwd_dq_kernel`` at D 16 or 32, full fp32 products on the CUDA
  cores;
* ``"wgmma_wide"``, as the forward's: ``flash_bwd_dkdv_wgmma_wide_kernel``
  (a block a kv tile, kv head, batch, column tile and role: dV or dK) and
  ``flash_bwd_dq_wgmma_wide_kernel``, the forward's column tiles and ring
  on the tensor cores (S and dP recomputed over the whole d in each, P and
  dS rounded to bf16 as operands; no atomics);
* ``"wgmma_wide_staged"``, as the forward's: ``flash_stage_rows_kernel``
  copies q, k, v and dout and writes delta from the dout rows it copies,
  then the ``"wgmma_wide"`` kernels read the copies (instantiations of
  their own, which store dq, dk and dv column by column at the real d);
* ``"wide"``, the forward's: ``flash_bwd_dkdv_wide_kernel`` (a block a
  kv tile of ``SIMT_WIDE_KV_ROWS`` rows, kv head, batch and column tile,
  walking the group's q heads and q tiles, K and V resident as the
  forward's Q; where those blocks are fewer than a wave, the walk over the
  q heads in
  :func:`simt_wide_kv_parts` parts, a block each, whose fp32 partial sums
  go to a scratch that ``flash_bwd_parts_sum_kernel`` adds in part order)
  and ``flash_bwd_dq_wide_kernel`` (Q and dO resident likewise), the
  forward's
  column tiles and clusters (S^T and dP^T, or S and dP, summed once per
  cluster from each block's slice of d; each block writing its own columns
  of dK and dV, or dQ; no atomics, bitwise repeatable).

delta = rowsum(dO * O) is summed over the real d.

On the CPU the backward is the closed form ``ref.attention_bwd_ref``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels._build import (check_operand, dtype_code, is_fake,
                                        needs_grad, on_card,
                                        register_kernel, stream_handle)
from repro_torch.kernels.ref import (attention_bwd_ref, attention_lse_ref,
                                     attention_ref)
from repro_torch.roofline import kernel_cost

HEAD_DIMS = (16, 32, 64, 128, 160, 256)   # the instantiated (padded) dims
MAX_HEAD_DIM = HEAD_DIMS[-1]    # above it, the column-tile kernels
WIDE_TILE_COLS = 256    # output columns a column tile, at most
TC_WIDE_MAX_HEAD_DIM = 768      # the C kTcWideMaxDim
TC_WIDE_FWD_192_MAX = 704       # the C kTcWideFwd192MaxDim
TC_WIDE_WIDTHS = (192, 256)     # the wgmma column tiles' instantiated N
SIMT_WIDE_COLS = 256        # the C kSimtWideCols: output columns a tile
SIMT_WIDE_MAX_CLUSTER = 8   # kSimtWideMaxCluster: blocks a cluster
SIMT_WIDE_PIECE = 32        # kSimtWidePiece: columns of d a staged piece
SIMT_WIDE_KV_ROWS = 32      # kSimtWideKvRows: kv rows a dK/dV block
SIMT_WIDE_WAVE = 132            # kSimtWideWave: dK/dV blocks below which
SIMT_WIDE_FILL_BLOCKS = 264     # the walk splits, into kSimtWideFillBlocks
SIMT_MAX_HEAD_DIM = 32      # kSimtMaxDim: above it fp32 takes route "wide"
# Route "wide"'s instantiations, (dtype, copy width VEC, tile width,
# mode), modes as the C kStreamed (clusters, X staged with Y), kResident
# (clusters, X resident: element copies, VEC 1, up to d 2048) and
# kOneTile (d up to 256): fp32 at one tile of every width with 16-byte and
# element copies; clusters of 192 and 256 resident at VEC 1 and streamed
# at VEC 4, and streamed at 256 and VEC 1 (d above 2048, where every tile
# is 256 wide); bf16 (above 768, where every tile is 256 wide) at 256 the
# same.
STREAMED, RESIDENT, ONE_TILE = 0, 1, 2
SIMT_WIDE_KERNELS = tuple(
    [(torch.float32, vec, w, ONE_TILE) for w in (64, 128, 192, 256)
     for vec in (1, 4)] +
    [(dt, vec, w, mode) for dt in (torch.float32, torch.bfloat16)
     for vec, w, mode in ((1, 192, RESIDENT), (1, 256, RESIDENT),
                          (4, 192, STREAMED), (4, 256, STREAMED),
                          (1, 256, STREAMED))
     if dt == torch.float32 or w == 256])
SIMT_WIDE_WIDTHS = tuple(sorted({w for _, _, w, _ in SIMT_WIDE_KERNELS}))
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = register_kernel(
    "flash_attention", "repro_flash_attention",
    [_P] * 6 + [_I] * 6 + [_F, _I, _I, _P])
KERNEL_BWD = register_kernel(
    "flash_attention_bwd", "repro_flash_attention_bwd",
    [_P] * 11 + [_I] * 6 + [_F, _I, _I, _P])


def padded_head_dim(d: int) -> int:
    """The head dim a call of head dim ``d`` runs at (the C
    ``padded_dim``): the least of ``HEAD_DIMS`` at or above it, or d
    itself above ``MAX_HEAD_DIM`` (the column-tile kernels pad nothing);
    d < 1 raises."""
    if d < 1:
        raise ValueError(f"head_dim {d} is not a head dim (no kernel takes "
                         f"d < 1)")
    return next((dd for dd in HEAD_DIMS if dd >= d), d)


def col_tiles(d: int) -> tuple[int, int]:
    """(tiles, width) of the column-tile kernels above ``MAX_HEAD_DIM``
    (the C ``wide_col_tiles``, ``wide_tile_width``): ceil(d / 256) tiles of
    equal width rounded up to 16, the last cut at d; one tile of d below."""
    if d <= MAX_HEAD_DIM:
        return 1, padded_head_dim(d)
    n = -(-d // WIDE_TILE_COLS)
    width = -(-d // n)
    return n, -(-width // 16) * 16


def simt_wide_plan(d: int) -> dict:
    """The CUDA-core tiles' plan (route ``"wide"``; the C ``simt_wide_*``
    functions of ``common.cuh``): ``tiles`` of ``width`` output columns
    (ceil(d / 256) tiles of equal width rounded up to a multiple of 64, the
    last cut at d; one tile up to 256), run as ``clusters`` clusters of
    ``cluster`` blocks (at most 8; blocks past the last tile store
    nothing), block r of a cluster summing the scores over slice r of d,
    ``slice`` columns (whole 32-column pieces, the last slice cut at d);
    ``resident``: a block keeps its X rows over its slice in shared memory
    (at one tile; above it with element copies, d % 4 != 0, where the
    slice is no wider than a tile: up to d 2048)."""
    tiles = -(-d // SIMT_WIDE_COLS)
    width = -(-(-(-d // tiles)) // 64) * 64
    cluster = min(tiles, SIMT_WIDE_MAX_CLUSTER)
    slice_ = -(-(-(-d // cluster)) // SIMT_WIDE_PIECE) * SIMT_WIDE_PIECE
    return {"tiles": tiles, "width": width, "cluster": cluster,
            "clusters": -(-tiles // cluster), "slice": slice_,
            "resident": tiles == 1 or (d % 4 != 0 and slice_ <= width)}


def simt_wide_mode(d: int) -> int:
    """The instantiation mode route ``"wide"`` runs d at (``ONE_TILE``,
    ``RESIDENT`` or ``STREAMED``)."""
    plan = simt_wide_plan(d)
    return ONE_TILE if plan["tiles"] == 1 else \
        RESIDENT if plan["resident"] else STREAMED


def simt_wide_kv_tiles(skv: int) -> int:
    """Blocks along the kv rows of the column tiles' dK/dV kernel (the C
    ``simt_wide_kv_tiles``): ``SIMT_WIDE_KV_ROWS`` rows each."""
    return -(-skv // SIMT_WIDE_KV_ROWS)


def simt_wide_kv_parts(b: int, skv: int, hq: int, hkv: int, d: int) -> int:
    """Parts of route ``"wide"``'s dK/dV walk over a kv head's q heads (the
    C ``simt_wide_kv_parts`` of the blocks one part takes): one where the
    blocks fill a wave (``SIMT_WIDE_WAVE``), else enough for
    ``SIMT_WIDE_FILL_BLOCKS`` blocks, at most the group."""
    plan = simt_wide_plan(d)
    blocks = plan["cluster"] * plan["clusters"] * hkv * b * \
        simt_wide_kv_tiles(skv)
    if blocks >= SIMT_WIDE_WAVE:
        return 1
    return min(-(-SIMT_WIDE_FILL_BLOCKS // blocks), hq // hkv)


def wide_parts_numel(b: int, skv: int, hq: int, hkv: int, d: int) -> int:
    """float32 elements of route ``"wide"``'s dK/dV parts' scratch: the
    partial dV and dK of each part (0 with one part)."""
    parts = simt_wide_kv_parts(b, skv, hq, hkv, d)
    return 0 if parts == 1 else 2 * parts * b * skv * hkv * d


def simt_wide_smem(kernel: str, width: int, mode: int) -> int:
    """Bytes of dynamic shared memory of route ``"wide"``'s kernel
    (``"fwd"``, ``"dkdv"``, ``"dq"``) at a tile width and mode (the C
    ``Tiles::smem`` of flash_attention_simt_wide.cuh): the resident X
    rows, three staging buffers, W and, with a cluster, two partials."""
    m, n, np_, nz, kc = {
        "fwd": (64, 64, 1, 1, 32),
        "dkdv": (SIMT_WIDE_KV_ROWS, 64, 2, 2, 16),
        "dq": (64, 32, 2, 1, 16 if width == 256 and mode != STREAMED
               else 32)}[kernel]
    lp = 2 * SIMT_WIDE_PIECE + 4
    res = mode != STREAMED
    x = np_ * m * (width + 4) if res else 0
    stage = max(np_ * ((0 if res else m) + n) * lp, nz * kc * width)
    part = 256 * np_ * (m // 16) * (n // 16) if mode != ONE_TILE else 0
    return 4 * (x + 3 * stage + nz * m * (n + 4) + 2 * part)


def wgmma_col_tiles(d: int, forward: bool = False) -> tuple[int, int]:
    """(tiles, width) of the tensor-core column-tile kernels above
    ``MAX_HEAD_DIM``, each width one of ``TC_WIDE_WIDTHS``, the last tile
    cut at d. The backward's (the C ``tc_wide_col_tiles``,
    ``tc_wide_tile_width``): ceil(d / 256) tiles of equal width rounded up
    to a whole 64-column box. The forward's (``tc_wide_fwd_col_tiles``,
    ``tc_wide_fwd_tile_width``): tiles of 192 up to
    ``TC_WIDE_FWD_192_MAX``, where two blocks an SM fit, else the
    backward's."""
    if forward and d <= TC_WIDE_FWD_192_MAX:
        return -(-d // 192), 192
    n = -(-d // WIDE_TILE_COLS)
    width = -(-d // n)
    return n, -(-width // 64) * 64


def fwd_design(dtype: torch.dtype, d: int) -> str:
    """The route on the card, as ``repro_flash_attention`` and
    ``repro_flash_attention_bwd`` dispatch it (the C ``tc_wide_route``,
    ``tc_wide_staged_route``, ``simt_wide_route``, ``tc_route`` and
    ``staged_route``): for bfloat16 above ``MAX_HEAD_DIM`` up to
    ``TC_WIDE_MAX_HEAD_DIM`` ``"wgmma_wide"`` where d is a multiple of 8
    and ``"wgmma_wide_staged"`` where it is not, above that ``"wide"``; up
    to it above ``SIMT_MAX_HEAD_DIM`` ``"wgmma"`` where d is a multiple of
    8 (the TMA maps' rows are whole 16-byte chunks) and ``"wgmma_staged"``
    where it is not; for float32 ``"wide"`` above ``SIMT_MAX_HEAD_DIM``;
    else ``"simt"``. A dtype or head_dim no kernel takes raises."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{dtype}")
    padded_head_dim(d)
    if d <= SIMT_MAX_HEAD_DIM:
        return "simt"
    if dtype == torch.float32 or d > TC_WIDE_MAX_HEAD_DIM:
        return "wide"
    staged = "_staged" if d % 8 else ""
    return ("wgmma_wide" if d > MAX_HEAD_DIM else "wgmma") + staged


# The backward takes the forward's route at every shape.
bwd_design = fwd_design


def staged_ld(d: int) -> int:
    """Elements a staged row (the C ``staged_ld``): the least multiple of 8
    at or above d, so that a bf16 row is whole 16-byte chunks."""
    return -(-d // 8) * 8


STAGED_DESIGNS = ("wgmma_staged", "wgmma_wide_staged")   # take a scratch


def staged_scratch_numel(b: int, sq: int, skv: int, hq: int, hkv: int,
                         d: int, forward: bool = False) -> int:
    """bf16 elements of a staged route's scratch (``STAGED_DESIGNS``): q,
    k, v and, for the backward, dout in rows of :func:`staged_ld` (d)."""
    return ((1 if forward else 2) * b * sq * hq +
            2 * b * skv * hkv) * staged_ld(d)


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool = True, scale: Optional[float] = None
          ) -> torch.Tensor:
    return attention_ref(q, k, v, causal=causal, scale=scale)


def plain_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
              scale: Optional[float] = None):
    """(dq, dk, dv) in closed form; ``lse`` is the forward's (b, hq, sq)."""
    return attention_bwd_ref(q, k, v, out, dout, lse, causal=causal,
                             scale=scale)


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    """1 / sqrt(d) of the real d (head_dim 0 is refused by the checks)."""
    if scale is not None:
        return scale
    return 1.0 / math.sqrt(max(q.shape[-1], 1))


class FlashAttentionFunction(torch.autograd.Function):
    """flash_attention with its backward: kernels on the card (the forward
    kernel writes the log-sum-exp the backward kernels read), the closed
    form ``plain_bwd`` on the CPU (which recomputes the log-sum-exp)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        scale = _scale(q, scale)
        if on_card(q, "flash_attention"):
            out, lse = _kernel_forward(q, k, v, causal, scale, with_lse=True)
        else:
            out, lse = plain(q, k, v, causal=causal, scale=scale), None
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if on_card(q, "flash_attention"):
            dq, dk, dv = _kernel_backward(q, k, v, out, dout, lse,
                                          ctx.causal, ctx.scale)
        else:
            lse = attention_lse_ref(q, k, causal=ctx.causal, scale=ctx.scale)
            dq, dk, dv = plain_bwd(q, k, v, out, dout, lse,
                                   causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """q: (b, sq, hq, d); k, v: (b, skv, hkv, d) -> (b, sq, hq, d)."""
    if needs_grad(q, k, v):
        return FlashAttentionFunction.apply(q, k, v, causal, scale)
    if not on_card(q, "flash_attention"):
        return plain(q, k, v, causal=causal, scale=scale)
    return _kernel_forward(q, k, v, causal, _scale(q, scale))[0]


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(name, t, q.device, 4, q.dtype)
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"hq={hq} is not a multiple of hkv={hkv}")
    padded_head_dim(d)


def _kernel_forward(q, k, v, causal: bool, scale: float,
                    with_lse: bool = False):
    """(out, lse): lse (b, hq, sq) fp32 when ``with_lse``, else None."""
    _check(q, k, v)
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.numel() == 0:
        return out, lse
    if skv == 0:
        raise ValueError("flash_attention needs skv >= 1")
    # The staged route's copies (on a fake tensor too, so the dry run's
    # memory peak holds them).
    scratch = (torch.empty(staged_scratch_numel(b, sq, skv, hq, hkv, d,
                                                forward=True),
                           dtype=q.dtype, device=q.device)
               if fwd_design(q.dtype, d) in STAGED_DESIGNS else None)
    if is_fake(q):
        KERNEL.fake_call(kernel_cost.flash(b, sq, skv, hq, hkv, d, q.dtype,
                                           causal, with_lse))
        return out, lse
    KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           lse.data_ptr() if with_lse else None,
           None if scratch is None else scratch.data_ptr(), b, sq, skv, hq,
           hkv, d, float(scale), int(causal), dtype_code(q),
           stream_handle(q.device))
    return out, lse


def _kernel_backward(q, k, v, out, dout, lse, causal: bool, scale: float):
    _check(q, k, v)
    check_operand("out", out, q.device, 4, q.dtype)
    check_operand("dout", dout, q.device, 4, q.dtype)
    check_operand("lse", lse, q.device, 3, torch.float32)
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != (b, hq, sq):
        raise ValueError(f"shapes out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # The staged route's copies, or route "wide"'s dK/dV parts (on a fake
    # tensor too, so the dry run's memory peak holds them).
    design = bwd_design(q.dtype, d)
    scratch = None
    if design in STAGED_DESIGNS:
        scratch = torch.empty(staged_scratch_numel(b, sq, skv, hq, hkv, d),
                              dtype=q.dtype, device=q.device)
    elif design == "wide" and wide_parts_numel(b, skv, hq, hkv, d):
        scratch = torch.empty(wide_parts_numel(b, skv, hq, hkv, d),
                              dtype=torch.float32, device=q.device)
    if is_fake(q):
        KERNEL_BWD.fake_call(kernel_cost.flash_bwd(b, sq, skv, hq, hkv, d,
                                                   q.dtype, causal))
        return dq, dk, dv
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    KERNEL_BWD(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
               None if scratch is None else scratch.data_ptr(), b, sq, skv,
               hq, hkv, d, float(scale), int(causal), dtype_code(q),
               stream_handle(q.device))
    return dq, dk, dv
