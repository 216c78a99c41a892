"""Decode attention: the CUDA kernel ``csrc/decode_attention.cu`` and its
plain version.

Replaces ``src/repro/kernels/decode_attention.py::decode_attention`` of the
JAX package. A tensor on the CPU goes to the plain version
(``ref.decode_attention_ref``); a CUDA tensor goes to the kernel, or the
call raises; a fake CUDA tensor to its fake path (checked, outputs
allocated, counted by the dry run as a read of the whole cache, since a
fake length has no value; not launched). The kernel has no backward: on
the card, a call that autograd would record raises
``NotImplementedError``. Any ``skv`` is taken; head_dim must be 16, 32,
64, 128 or 160 and ``hq / hkv`` any group from 1 to ``MAX_GROUP`` (16),
in bf16 or fp32. :func:`pv_layout` is the kernel's
arithmetic for who owns which head, 16 bytes of d and cache row in P.V.

The kernel is split-KV: ``num_splits(skv)`` blocks per (batch, kv head),
each over ``split_rows(skv)`` cache rows, combined in the same launch by
the block that finishes last. Both numbers follow from ``skv`` (the
cache's capacity) alone, never from ``length``, so a call reads nothing
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

from repro_torch.kernels._build import (check_operand, dtype_code, is_fake,
                                        on_card, refuse_grad,
                                        register_kernel, stream_handle)
from repro_torch.kernels.ref import (decode_attention_partial_ref,
                                     decode_attention_ref)
from repro_torch.roofline import kernel_cost

HEAD_DIMS = (16, 32, 64, 128, 160)
MAX_GROUP = 16
THREADS = 128   # a block (kThreads)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = register_kernel(
    "decode_attention", "repro_decode_attention",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
     _P])
TILE = 64   # cache rows per tile inside a block; split_rows is a multiple
MAX_SPLITS = 16
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


def group_bucket(g: int) -> int:
    """The bucket of the instantiation that serves group ``g``: the least
    of 1, 2, 4, 8, 16 at or above it (``dispatch_g``; the group is a
    constant there where it equals its bucket, else read at run time)."""
    if not 1 <= g <= MAX_GROUP:
        raise ValueError(f"hq / hkv = {g} not in 1..{MAX_GROUP}")
    return next(gm for gm in (1, 2, 4, 8, 16) if gm >= g)


def pv_layout(element_size: int, d: int, g: int) -> Dict[str, int]:
    """The P.V ownership of ``csrc/decode_attention.cu`` (``Layout`` and
    the kernel's ``pc``, ``grp``, ``R``, ``pg``, ``rs``): thread t takes
    16-byte chunk ``t % ch`` of d in thread group ``t // ch``; group grp,
    if below ``active``, takes head ``grp % g`` over the rows r with
    ``r % r_slices == grp // g``, and heads ``grp % g + hg * i`` below g
    for i < ``hpt``."""
    ve = 16 // element_size
    ch = d // ve
    hg = THREADS // ch
    gm = group_bucket(g)
    r_slices = hg // g if g < hg else 1
    return {"ve": ve, "ch": ch, "hg": hg, "hpt": -(-gm // hg),
            "r_slices": r_slices, "active": min(hg, r_slices * g)}


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
    if hkv == 0 or hq % hkv or not 1 <= hq // hkv <= MAX_GROUP:
        raise ValueError(f"hq / hkv = {hq}/{hkv} is not a group of 1 to "
                         f"{MAX_GROUP} q heads a kv head")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
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
    g, splits = hq // hkv, num_splits(skv)
    # One fp32 scratch for the partials: (m, l) of each (b, kv head, split,
    # q head), then their accumulators of d each.
    n_part = b * hkv * splits * g
    part = torch.empty(n_part * (2 + d), dtype=torch.float32,
                       device=q.device)
    counter = _counter(q.device, b * hkv)
    KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
           out.data_ptr(), None if lse is None else lse.data_ptr(),
           part.data_ptr(), part.data_ptr() + 8 * n_part,
           counter.data_ptr(), b, skv, hq, hkv, d, split_rows(skv),
           float(scale), dtype_code(q), stream_handle(q.device))
    return (out, lse) if return_lse else out
