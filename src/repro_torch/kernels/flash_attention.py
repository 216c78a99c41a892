"""Flash prefill attention: the CUDA kernels ``csrc/flash_attention.cu`` and
their plain versions.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention`` of the
JAX package. A tensor on the CPU goes to the plain version
(``ref.attention_ref``); a CUDA tensor goes to the kernel, or the call
raises; a fake CUDA tensor to its fake path (checked, outputs
allocated, counted by the dry run, not launched). Any ``sq`` and ``skv``
are taken, and any ``hq / hkv``; head_dim must be 16, 32, 64, 128 or
160 (``HEAD_DIMS``) for the forward and 16, 32, 64 or 128
(``BWD_HEAD_DIMS``) for the backward: on the card, a call at head_dim 160
that autograd would record raises ``NotImplementedError``.

Two hand-written kernels of ``csrc/flash_attention.cu`` serve a CUDA
tensor, both launched and counted as ``flash_attention``:

* bf16 at head_dim 64, 128 or 160 (the serving path):
  ``flash_fwd_wgmma_kernel``, tensor cores (wgmma, fp32 accumulators, P
  rounded to bf16 for P.V) fed by TMA; d 160 as three 64-column boxes,
  zero past 160;
* fp32 at any head_dim, and bf16 at 16 or 32: ``flash_fwd_simt_kernel``,
  full fp32 products on the CUDA cores.

Where autograd records the call (grad mode on, an input that requires
grad), it runs through :class:`FlashAttentionFunction`: the forward kernel
also writes each row's log-sum-exp, and the backward is one call, counted
as ``flash_attention_bwd``, of ``flash_bwd_preprocess_kernel`` (delta) and
two kernels on the route :func:`bwd_design` names:

* ``"wgmma"``, bf16 at head_dim 64 or 128 (the training path):
  ``flash_bwd_dkdv_wgmma_kernel`` and ``flash_bwd_dq_wgmma_kernel``,
  tensor cores (wgmma, fp32 accumulators, P and dS rounded to bf16 as
  operands) fed by TMA, deterministic (no atomics);
* ``"simt"``, fp32 at any backward head_dim and bf16 at 16 or 32:
  ``flash_bwd_dkdv_kernel`` and ``flash_bwd_dq_kernel``, full fp32
  products on the CUDA cores.

On the CPU the backward is the closed form ``ref.attention_bwd_ref``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels._build import (check_operand, dtype_code, is_fake,
                                        needs_grad, on_card, refuse_grad,
                                        register_kernel, stream_handle)
from repro_torch.kernels.ref import (attention_bwd_ref, attention_lse_ref,
                                     attention_ref)
from repro_torch.roofline import kernel_cost

HEAD_DIMS = (16, 32, 64, 128, 160)
BWD_HEAD_DIMS = (16, 32, 64, 128)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = register_kernel(
    "flash_attention", "repro_flash_attention",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P])
KERNEL_BWD = register_kernel(
    "flash_attention_bwd", "repro_flash_attention_bwd",
    [_P] * 10 + [_I] * 6 + [_F, _I, _I, _P])


def bwd_design(dtype: torch.dtype, d: int) -> str:
    """The backward's route on the card, as ``repro_flash_attention_bwd``
    dispatches it: ``"wgmma"`` for bfloat16 at head_dim 64 or 128, else
    ``"simt"``; a dtype or head_dim no backward kernel takes raises."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{dtype}")
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {BWD_HEAD_DIMS}")
    return "wgmma" if dtype == torch.bfloat16 and d in (64, 128) else "simt"


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
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


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
        d = q.shape[-1]
        if on_card(q, "flash_attention") and d in HEAD_DIMS and \
                d not in BWD_HEAD_DIMS:     # forward kernel, no backward
            refuse_grad(f"flash_attention at head_dim {d}", q, k, v)
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
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")


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
    if is_fake(q):
        KERNEL.fake_call(kernel_cost.flash(b, sq, skv, hq, hkv, d, q.dtype,
                                           causal, with_lse))
        return out, lse
    KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           lse.data_ptr() if with_lse else None, b, sq, skv, hq, hkv, d,
           float(scale), int(causal), dtype_code(q), stream_handle(q.device))
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
    if is_fake(q):
        KERNEL_BWD.fake_call(kernel_cost.flash_bwd(b, sq, skv, hq, hkv, d,
                                                   q.dtype, causal))
        return dq, dk, dv
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    KERNEL_BWD(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, skv, hq,
               hkv, d, float(scale), int(causal), dtype_code(q),
               stream_handle(q.device))
    return dq, dk, dv
