"""Decode attention: the CUDA kernel ``csrc/decode_attention.cu`` and its
plain version.

Replaces ``src/repro/kernels/decode_attention.py::decode_attention`` of the
JAX package. A tensor on the CPU goes to the plain version
(``ref.decode_attention_ref``); a CUDA tensor goes to the kernel, or the
call raises; a fake CUDA tensor to its fake path (checked, outputs
allocated, counted by the dry run as a read of the whole cache, since a
fake length has no value; not launched). The kernel has no backward: on
the card, a call that autograd would record raises
``NotImplementedError``. Any ``skv`` is taken, any head_dim d >= 1 and any
group ``hq / hkv`` >= 1, in bf16 or fp32. Up to ``MAX_HEAD_DIM`` (256) the
call runs at the least of ``HEAD_DIMS`` at or above d, as the flash
kernel; above it, ``decode_wide_kernel`` takes the output's columns in
``flash_attention.col_tiles(d)`` tiles of at most 256, a block each, each
recomputing the scores over the whole d (streamed in pieces, in the same
order in every tile) and combining its own columns. A group above
``MAX_GROUP`` (16) runs in ``group_slices(g)`` slices of at most 16 q
heads, a block each, each reading the kv head's rows. Only d < 1 raises.
:func:`pv_layout` is the kernel's arithmetic for who owns which head,
16 bytes of d and cache row in P.V, and names the route.

bf16 at D 256 where d is a multiple of 8 (d 168-256, gemma-2b's 256; the
C ``decode_mma_route``) takes route ``"mma"`` instead:
``decode_mma_kernel`` of ``csrc/decode_attention_tc.cu``, the slice's q
heads as the 16 rows of ``mma.sync`` m16n8k16 over cache tiles of
``MMA_TILE`` rows (scores and P.V on the tensor cores, P rounded to bf16
for P.V, fp32 sums), its splits planned by :func:`mma_split_rows` so
that the grid fills the card. fp32, bf16 at other d, and every D below
256 keep ``"split"``.

The kernel is split-KV: ``num_splits(skv)`` blocks per (batch, kv head),
each over ``split_rows(skv)`` cache rows (on route ``"mma"``,
``mma_split_rows(skv, units)`` with units the (batch, kv head, q-head
slice) blocks of a split), combined in the same launch by the block that
finishes last. Both numbers follow from ``skv`` (the cache's capacity)
and the shape alone, never from ``length``, so a call reads nothing
back to the host and can be captured in a CUDA graph. The combine counts
blocks on an int32 buffer per device that the kernel leaves zeroed; calls
on one device are assumed to be ordered (one stream at a time).

Partial mode (``return_lse=True``) also gives each (slot, q head)'s
fp32 log-sum-exp of its scaled scores, written by the same combine
(``ref.decode_attention_partial_ref`` is its plain version): a slot of
length 0 gives out 0 and lse -inf. Slices of a sequence-sharded cache,
each attended with its local lengths, then combine across ranks by
``exp(lse - max)`` weights (``kernels/ops.py``). The out of a call is the
same in both modes.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Tuple, Union

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels._build import (check_operand, dtype_code, is_fake,
                                        on_card, refuse_grad,
                                        register_kernel, stream_handle)
from repro_torch.kernels.ref import (decode_attention_partial_ref,
                                     decode_attention_ref)
from repro_torch.roofline import kernel_cost

HEAD_DIMS = _flash.HEAD_DIMS        # the instantiated (padded) head dims
MAX_HEAD_DIM = _flash.MAX_HEAD_DIM
MAX_GROUP = 16      # q heads a block; larger groups run in slices of 16
THREADS = 128   # a block (kThreads)
MAX_SMEM = 232448   # shared memory a block may use (kMaxSmem)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = register_kernel(
    "decode_attention", "repro_decode_attention",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
     _P])
TILE = 64   # cache rows per tile inside a block; split_rows is a multiple
WIDE_PIECE = 64     # columns of d a streamed piece above MAX_HEAD_DIM
MAX_SPLITS = 16
MMA_TILE = 64       # cache rows a tile on route "mma" (kDecodeMmaTile)
MMA_BLOCKS = 132    # blocks the "mma" split plan aims at (kDecodeMmaBlocks)
MMA_MIN_ROWS = 64   # cache rows a split on route "mma", at least
MMA_MAX_SPLITS = 32     # the combine takes one split a lane
# Combine counters, one list per device; every buffer stays alive, since a
# captured CUDA graph keeps the pointer it was given.
_COUNTERS: Dict[torch.device, List[torch.Tensor]] = {}


def split_rows(skv: int) -> int:
    """Cache rows per block: the least multiple of 64 that cuts the cache
    into at most MAX_SPLITS splits (the kernel's combine takes at most 32,
    one per lane of a warp). 4 slots at cache 740 give 12 x 8 x 4 = 384
    blocks at 8 kv heads; a cache of 4096 gives 16 splits of 256 rows."""
    return TILE * max(1, -(-skv // (TILE * MAX_SPLITS)))


def num_splits(skv: int) -> int:
    return -(-skv // split_rows(skv))


def mma_route(dtype: torch.dtype, d: int) -> bool:
    """Whether a call takes route ``"mma"`` (the C ``decode_mma_route``,
    bf16 only): D 256 and d whole 16-byte chunks."""
    return dtype == torch.bfloat16 and 160 < d <= MAX_HEAD_DIM and d % 8 == 0


def mma_splits(units: int) -> int:
    """Splits a (batch, kv head, slice) unit aims at on route ``"mma"``
    (the C ``decode_mma_splits``): ceil(MMA_BLOCKS / units), at most 32."""
    return min(MMA_MAX_SPLITS, -(-MMA_BLOCKS // units))


def mma_split_rows(skv: int, units: int) -> int:
    """Cache rows a split on route ``"mma"`` (the C
    ``decode_mma_split_rows``): the least whole tiles of ``MMA_TILE`` that
    cover ``skv`` in :func:`mma_splits` (units) splits, but at least
    ``MMA_MIN_ROWS``. 4 slots on one kv head at cache 740: 12 splits of
    64 rows, 48 blocks; at cache 4096, 32 splits of 128 rows."""
    n = mma_splits(units)
    return max(MMA_MIN_ROWS, MMA_TILE * -(-skv // (MMA_TILE * n)))


def group_bucket(g: int, d: Optional[int] = None) -> int:
    """The bucket of the instantiation that serves group ``g``
    (``dispatch_g``): the least of 1, 2, 4, 8, 16 at or above it, 16 above
    16; the group is a constant there where it equals its bucket, else
    read at run time. A head dim ``d`` below its padded D takes the
    padded instantiation, the run-time bucket 16, at any group, and so
    does every d at D 256 (the one instantiation there) and above (the
    column-tile kernel, which reads the group at run time)."""
    if g < 1:
        raise ValueError(f"hq / hkv = {g} is not a group of q heads")
    if d is not None:
        big = _flash.padded_head_dim(d)
        if d != big or big >= MAX_HEAD_DIM:
            return MAX_GROUP
    return next((gm for gm in (1, 2, 4, 8, 16) if gm >= g), MAX_GROUP)


def group_slices(g: int) -> int:
    """Blocks a (split, kv head) takes: ceil(g / 16) slices of q heads."""
    return -(-g // group_bucket(g))


def pv_layout(element_size: int, d: int, g: int) -> Dict[str, int]:
    """The P.V ownership of ``csrc/decode_attention.cu`` (``Layout`` and
    the kernel's ``pc``, ``grp``, ``R``, ``pg``, ``rs``) for a group of
    ``g`` q heads, in the block of its first slice (gb = min(g, 16) heads;
    ``slices`` blocks a kv head), at the padded head dim ``D``: thread t
    takes 16-byte chunk ``t % ch`` of D in thread group ``t // ch``, and
    works only if that chunk is below ``chunks``, the ones holding the
    real d; group grp, if below ``active``, takes head ``grp % gb`` over
    the rows r with ``r % r_slices == grp // gb``, and heads ``grp % gb +
    hg * i`` below gb for i < ``hpt``. ``vec``: the rows load as whole
    16-byte chunks (else element by element, zero past d). ``stages``:
    tiles in flight (``Layout::kStages``; one where two would not fit in
    ``MAX_SMEM``). ``route``: ``"split"`` (``decode_split_kernel``).

    Above ``MAX_HEAD_DIM``, ``route`` ``"wide"`` (``decode_wide_kernel``):
    ``col_tiles`` blocks a (split, kv head, slice), each over ``tile``
    output columns (the last cut at d), thread t owning columns t and t +
    ``THREADS`` of its tile for each of the slice's heads; one tile in
    flight, K and q staged in ``WIDE_PIECE``-column pieces, ``smem``
    bytes.

    bf16 at D 256 where d is a multiple of 8: ``route`` ``"mma"``
    (``decode_mma_kernel``): a block a (split, kv head, slice of ``heads``
    q heads, the mma's M), cache tiles of ``tile`` rows, ``warps`` warps
    each scoring ``tile / warps`` rows and owning ``cols_per_warp`` output
    columns in P.V; ``stages`` tiles in flight where a split has more than
    one, ``smem`` bytes then."""
    ve = 16 // element_size
    big = _flash.padded_head_dim(d)
    if element_size == 2 and 160 < d <= MAX_HEAD_DIM and d % 8 == 0:
        lds, warps = MAX_HEAD_DIM + 8, MMA_TILE // 8
        smem = 2 * (2 * 2 * MMA_TILE * lds + MAX_GROUP * lds +
                    MAX_GROUP * (MMA_TILE + 8)) + 4 * 2 * warps * MAX_GROUP
        return {"route": "mma", "D": MAX_HEAD_DIM, "tile": MMA_TILE,
                "heads": MAX_GROUP, "warps": warps,
                "cols_per_warp": MAX_HEAD_DIM // warps,
                "slices": group_slices(g), "stages": 2, "smem": smem}
    if big > MAX_HEAD_DIM:
        n, tw = _flash.col_tiles(d)
        smem = 4 * (MAX_GROUP * WIDE_PIECE + TILE * (WIDE_PIECE + 1) +
                    TILE * (_flash.WIDE_TILE_COLS + 1) + MAX_GROUP * TILE +
                    3 * MAX_GROUP)
        return {"route": "wide", "D": d, "col_tiles": n, "tile": tw,
                "cols_per_thread": _flash.WIDE_TILE_COLS // THREADS,
                "slices": group_slices(g), "stages": 1, "smem": smem}
    ch = big // ve
    hg = THREADS // ch
    gm = group_bucket(g, d)
    gb = min(g, gm)             # q heads of the first slice's block
    r_slices = hg // gb if gb < hg else 1
    stage = element_size * 2 * TILE * (big + ve)        # K and V tiles
    fixed = 4 * (gm * big + gm * TILE + THREADS * ve + 3 * gm)
    return {"route": "split", "D": big, "ve": ve, "ch": ch,
            "chunks": -(-d // ve),
            "vec": d % ve == 0, "hg": hg, "hpt": -(-gm // hg),
            "r_slices": r_slices, "active": min(hg, r_slices * gb),
            "slices": group_slices(g),
            "stages": 2 if 2 * stage + fixed <= MAX_SMEM else 1}


def _counter(device: torch.device, n: int) -> torch.Tensor:
    bufs = _COUNTERS.setdefault(device, [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 1024), dtype=torch.int32,
                                device=device))
    return bufs[-1]


Out = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          length: torch.Tensor, *, scale: Optional[float] = None,
          return_lse: bool = False) -> Out:
    if return_lse:
        return decode_attention_partial_ref(q, k, v, length, scale=scale)
    return decode_attention_ref(q, k, v, length, scale=scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor, *, scale: Optional[float] = None,
                     return_lse: bool = False) -> Out:
    """q: (b, hq, d); k, v: (b, skv, hkv, d); length: (b,) int32 valid
    cache rows -> (b, hq, d), and with ``return_lse`` also the (b, hq)
    fp32 log-sum-exp (partial mode, see the module docstring)."""
    if not on_card(q, "decode_attention"):
        return plain(q, k, v, length, scale=scale, return_lse=return_lse)
    refuse_grad("decode_attention", q, k, v)
    check_operand("q", q, q.device, 3)
    check_operand("k", k, q.device, 4, q.dtype)
    check_operand("v", v, q.device, 4, q.dtype)
    check_operand("length", length, q.device, 1, torch.int32)
    b, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d \
            or length.shape[0] != b:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, length {tuple(length.shape)} "
                         "do not fit")
    if hkv == 0 or hq % hkv or hq == 0:
        raise ValueError(f"hq / hkv = {hq}/{hkv} is not a whole group of "
                         "q heads a kv head")
    big = _flash.padded_head_dim(d)
    if skv == 0:
        raise ValueError("decode_attention needs skv >= 1")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if b == 0:
        return (out, lse) if return_lse else out
    if is_fake(q):      # the lengths are not known: every row is counted
        KERNEL.fake_call(kernel_cost.decode(b, hq, hkv, d, b * skv, q.dtype,
                                            return_lse))
        return (out, lse) if return_lse else out
    g = hq // hkv
    gs, per = group_slices(g), min(g, MAX_GROUP)
    rows = (mma_split_rows(skv, b * hkv * gs) if mma_route(q.dtype, d)
            else split_rows(skv))
    splits = -(-skv // rows)
    # One fp32 scratch for the partials: (m, l) of each (b, kv head, slice,
    # column tile, split, q head of the slice), then, from a 16-byte
    # boundary, their accumulators of D (a column tile's width at most,
    # above MAX_HEAD_DIM) each.
    nct = _flash.col_tiles(d)[0]
    width = min(big, _flash.WIDE_TILE_COLS)
    n_part = b * hkv * gs * nct * splits * per
    n_ml = -(-2 * n_part // 4) * 4
    part = torch.empty(n_ml + n_part * width, dtype=torch.float32,
                       device=q.device)
    counter = _counter(q.device, b * hkv * gs * nct)
    KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
           out.data_ptr(), None if lse is None else lse.data_ptr(),
           part.data_ptr(), part.data_ptr() + 4 * n_ml,
           counter.data_ptr(), b, skv, hq, hkv, d, rows,
           float(scale), dtype_code(q), stream_handle(q.device))
    return (out, lse) if return_lse else out
