"""Dispatch of the model stack's kernel calls, by the tensor's device.

* A CPU tensor goes to the plain PyTorch version. ``impl`` is honoured as
  the JAX package's ``reference`` mode honours it
  (``src/repro/kernels/ops.py:54-98``): ``chunked*`` prefill goes to
  ``ref.attention_chunked`` and ``chunked`` decode to
  ``ref.decode_attention_lowcast``.
* A CUDA tensor goes to the hand-written kernel, or the call raises. As in
  the JAX package's kernel modes, ``impl`` is not read there. ``rmsnorm``
  honours ``lowp`` on both devices.
* Under grad mode, where an input requires grad, ``rmsnorm`` (lowp off),
  ``attention`` and ``ssd`` run through their ``torch.autograd.Function``:
  the same forward, and a backward that is a hand-written kernel on the
  card and the closed-form plain backward on the CPU.
  ``decode_attention`` and ``int8_matmul`` have no backward kernel: on the
  card they raise ``NotImplementedError`` rather than return a result that
  carries no gradient (a kernel writes through a raw pointer, which
  autograd does not see); on the CPU autograd runs through the plain
  version. So does ``rmsnorm`` with ``lowp``, which raises on the card
  under grad.

There is no process-global mode: the device of the data decides.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels._build import launch_counts, reset_launches
from repro_torch.kernels.decode_attention import decode_attention as _decode
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.int8_matmul import int8_matmul as _int8
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd

__all__ = ["attention", "decode_attention", "int8_matmul", "launch_counts",
           "quantize_int8", "reset_launches", "rmsnorm", "ssd"]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
            lowp: bool = False) -> torch.Tensor:
    return _rmsnorm(x, w, eps, lowp=lowp)


def attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
              q_offset: int = 0, kv_len=None, impl: str = "ref",
              chunk: int = 512) -> torch.Tensor:
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


def decode_attention(q, k, v, length, *, scale: Optional[float] = None,
                     impl: str = "ref") -> torch.Tensor:
    if not q.is_cuda and impl == "chunked":
        return _ref.decode_attention_lowcast(q, k, v, length, scale=scale)
    return _decode(q, k, v, length, scale=scale)


def int8_matmul(x_q, sx, w_q, sw, out_dtype=torch.float32) -> torch.Tensor:
    return _int8(x_q, sx, w_q, sw, out_dtype)


def ssd(x, dt, A, B, C, D, *, chunk: int = 128):
    """Returns (y, final_state (b, h, p, n) fp32)."""
    return _ssd(x, dt, A, B, C, D, chunk=chunk)


quantize_int8 = _ref.quantize_int8
