"""Dispatch of the model stack's kernel calls, by the tensor's device.

* A CPU tensor goes to the plain PyTorch version. ``impl`` is honoured as
  the JAX package's ``reference`` mode honours it
  (``src/repro/kernels/ops.py:54-98``): ``chunked*`` prefill goes to
  ``ref.attention_chunked`` and ``chunked`` decode to
  ``ref.decode_attention_lowcast``.
* A CUDA tensor goes to the hand-written kernel, or the call raises. As in
  the JAX package's kernel modes, ``impl`` is not read there. ``rmsnorm``
  honours ``lowp`` on both devices.
* Under grad mode, where an input requires grad, ``rmsnorm`` (with or
  without ``lowp``), ``attention`` and ``ssd`` run through their
  ``torch.autograd.Function``: the same forward, and a backward that is a
  hand-written kernel on the card and the closed-form plain backward on
  the CPU. ``decode_attention`` and ``int8_matmul`` have no backward
  kernel: on the card they raise ``NotImplementedError`` rather than
  return a result that carries no gradient (a kernel writes through a raw
  pointer, which autograd does not see); on the CPU autograd runs through
  the plain version.

There is no process-global mode: the device of the data decides.

**On a mesh** (DTensor inputs, under ``use_sharding``), ``rmsnorm``,
``attention``, ``decode_attention`` and ``ssd`` run the same dispatch on
local shards (``distributed.sharding.on_local_shards``), so the kernel
runs on the card and the plain version on the CPU:

* ``rmsnorm`` on the rows where they lie (the normalised dim whole);
* ``attention`` on local q heads (``heads_act``) against the kv heads
  they read (:func:`local_kv_heads`: a slice of the kv heads, or, where
  the local q heads and the group do not divide one another, kv repeated
  to q heads first, as ``chunked_kvrep`` does);
* ``ssd`` on local heads (``heads_act``), ``A`` and ``D`` sliced to them;
* ``decode_attention`` on each rank's slice of a sequence-sharded cache
  (``kv_seq``) with every q head, in partial mode, the slices combined
  across the ranks that hold them (:func:`combine_partials`); the cache
  is never gathered.

The inputs that stay whole while the work is split (rmsnorm's weight,
k and v, the SSD's ``A``, ``B``, ``C`` and ``D``) get ``Partial``
gradients (``distributed.sharding.grad_placements``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed import sharding as _sh
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._build import launch_counts, reset_launches
from repro_torch.kernels.decode_attention import decode_attention as _decode
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.int8_matmul import int8_matmul as _int8
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd

__all__ = ["attention", "combine_partials", "decode_attention",
           "int8_matmul", "launch_counts", "local_kv_heads",
           "quantize_int8", "reset_launches", "rmsnorm", "ssd"]


def _whole(mesh) -> Tuple[Replicate, ...]:
    return (Replicate(),) * mesh.ndim


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
            lowp: bool = False) -> torch.Tensor:
    if isinstance(x, DTensor):
        xp, rep = _sh.row_placements(x, [-1]), _whole(x.device_mesh)
        return _sh.on_local_shards(
            lambda xl, wl: _rmsnorm(xl, wl, eps, lowp=lowp), x.device_mesh,
            (xp, rep), xp, (xp, _sh.grad_placements(rep, xp)))(
                x, _sh.replicated(w, x))
    return _rmsnorm(x, w, eps, lowp=lowp)


def local_kv_heads(g: int, q_off: int, q_len: int, k_off: int, k_len: int
                   ) -> Tuple[int, int, Optional[int]]:
    """The kv heads that q heads ``[q_off, q_off + q_len)`` read, in
    groups of ``g`` q heads a kv head, out of a local kv shard holding
    heads ``[k_off, k_off + k_len)``: ``(lo, hi, rep)``, the local kv heads
    ``[lo, hi)`` and ``rep`` None where they serve the q heads as they are
    (``q_len`` a multiple of ``g``, or a divisor of it, with ``q_off`` a
    multiple of ``q_len``); else each of them is to be repeated ``g``
    times and the q heads' ``q_len`` rows taken from offset ``rep``."""
    lo, hi = q_off // g, (q_off + q_len - 1) // g + 1
    if lo < k_off or hi > k_off + k_len:
        raise ValueError(f"q heads [{q_off}, {q_off + q_len}) read kv heads "
                         f"[{lo}, {hi}), not all in the local "
                         f"[{k_off}, {k_off + k_len})")
    aligned = q_off % q_len == 0 and (q_len % g == 0 or g % q_len == 0)
    return lo - k_off, hi - k_off, None if aligned else q_off - lo * g


def _kv_for(kl: torch.Tensor, g: int, q_len: int,
            heads: Tuple[int, int, Optional[int]]) -> torch.Tensor:
    lo, hi, rep = heads
    kl = kl[:, :, lo:hi]
    if rep is not None:
        kl = torch.repeat_interleave(kl, g, dim=2)[:, :, rep:rep + q_len]
    return kl.contiguous()


def attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
              q_offset: int = 0, kv_len=None, impl: str = "ref",
              chunk: int = 512) -> torch.Tensor:
    if isinstance(q, DTensor):
        if kv_len is not None or q_offset:
            raise NotImplementedError(
                "attention with kv_len/q_offset does not run on a mesh")
        qp = _sh.kernel_placements(q, ("batch", None, "heads_act", None))
        kp = _sh.kernel_placements(k, ("batch", None, "kv_heads_act", None))
        g = q.shape[2] // k.shape[2]
        q_off, q_len = _sh.local_slice(q, qp, 2)
        heads = local_kv_heads(g, q_off, q_len, *_sh.local_slice(k, kp, 2))

        def local(ql, kl, vl):
            return attention(ql, _kv_for(kl, g, q_len, heads),
                             _kv_for(vl, g, q_len, heads), causal=causal,
                             scale=scale, impl=impl, chunk=chunk)

        kg = _sh.grad_placements(kp, qp)
        return _sh.on_local_shards(local, q.device_mesh, (qp, kp, kp), qp,
                                   (qp, kg, kg))(q, k, v)
    if kv_len is not None or q_offset:
        # Masked/offset attention is not on the serving path and has no
        # kernel; it must not silently run the plain version on the card.
        if q.is_cuda:
            raise NotImplementedError(
                "attention with kv_len/q_offset has no CUDA kernel")
        return _ref.attention_ref(q, k, v, causal=causal, scale=scale,
                                  q_offset=q_offset, kv_len=kv_len)
    if not q.is_cuda and impl.startswith("chunked"):
        if impl == "chunked_kvrep":
            g = q.shape[2] // k.shape[2]
            k = torch.repeat_interleave(k, g, dim=2)
            v = torch.repeat_interleave(v, g, dim=2)
        return _ref.attention_chunked(q, k, v, causal=causal, scale=scale,
                                      chunk=chunk)
    return _flash(q, k, v, causal=causal, scale=scale)


def combine_partials(out: torch.Tensor, lse: torch.Tensor,
                     groups: Sequence[dist.ProcessGroup]) -> torch.Tensor:
    """Combine decode attention over slices of the cache held by the ranks
    of ``groups`` (each rank's ``(out, lse)`` from partial mode): one
    all-reduce of the max lse, then one of the ``exp(lse - max)``-weighted
    outs with their weights. One slice gives its out back unchanged."""
    m = lse.clone()
    for grp in groups:
        dist.all_reduce(m, dist.ReduceOp.MAX, group=grp)
    w = torch.where(torch.isneginf(m), 0.0, torch.exp(lse - m))
    b, hq, d = out.shape
    acc = torch.cat([(out.float() * w[..., None]).reshape(b, hq * d), w],
                    dim=1)
    for grp in groups:
        dist.all_reduce(acc, dist.ReduceOp.SUM, group=grp)
    den = acc[:, hq * d:]
    num = acc[:, :hq * d].reshape(b, hq, d)
    return torch.where(den[..., None] > 0, num / den[..., None],
                       0.0).to(out.dtype)


def decode_attention(q, k, v, length, *, scale: Optional[float] = None,
                     impl: str = "ref") -> torch.Tensor:
    if isinstance(k, DTensor):
        if impl == "chunked":
            raise NotImplementedError(
                "the low-cast decode has no partial mode for a mesh")
        mesh = k.device_mesh
        kp = _sh.row_placements(k, [2, 3])       # batch and kv_seq shards
        qp = tuple(p if p == Shard(0) else Replicate() for p in kp)
        seq: List[int] = [i for i, p in enumerate(kp) if p == Shard(1)]
        groups = [mesh.get_group(i) for i in seq]
        s_off, s_len = _sh.local_slice(k, kp, 1)

        def local(ql, kl, vl, ll):
            ll = torch.clamp(ll - s_off, 0, s_len).to(torch.int32)
            out, lse = _decode(ql, kl, vl, ll, scale=scale, return_lse=True)
            return combine_partials(out, lse, groups)

        return _sh.on_local_shards(
            local, mesh, (qp, kp, kp, qp), qp, None)(
                q, k, v, _sh.replicated(length, k))
    if not q.is_cuda and impl == "chunked":
        return _ref.decode_attention_lowcast(q, k, v, length, scale=scale)
    return _decode(q, k, v, length, scale=scale)


def int8_matmul(x_q, sx, w_q, sw, out_dtype=torch.float32) -> torch.Tensor:
    return _int8(x_q, sx, w_q, sw, out_dtype)


def ssd(x, dt, A, B, C, D, *, chunk: int = 128):
    """Returns (y, final_state (b, h, p, n) fp32)."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        xp = _sh.kernel_placements(x, ("batch", None, "heads_act", None))
        bp = tuple(p if p == Shard(0) else Replicate() for p in xp)
        sp = tuple(Shard(1) if p == Shard(2) else p for p in xp)
        rep = _whole(mesh)
        h_off, h_len = _sh.local_slice(x, xp, 2)

        def local(xl, dtl, Al, Bl, Cl, Dl):
            return _ssd(xl, dtl, Al[h_off:h_off + h_len], Bl, Cl,
                        Dl[h_off:h_off + h_len], chunk=chunk)

        rg, bg = _sh.grad_placements(rep, xp), _sh.grad_placements(bp, xp)
        return _sh.on_local_shards(
            local, mesh, (xp, xp, rep, bp, bp, rep), (xp, sp),
            (xp, xp, rg, bg, bg, rg))(
                x, _sh.replicated(dt, x), _sh.replicated(A, x),
                _sh.replicated(B, x), _sh.replicated(C, x),
                _sh.replicated(D, x))
    return _ssd(x, dt, A, B, C, D, chunk=chunk)


quantize_int8 = _ref.quantize_int8
