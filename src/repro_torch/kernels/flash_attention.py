"""Flash prefill attention: the CUDA kernel ``csrc/flash_attention.cu`` and
its plain version.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention`` of the
JAX package. A tensor on the CPU goes to the plain version
(``ref.attention_ref``); a CUDA tensor goes to the kernel, or the call
raises. Any ``sq`` and ``skv`` are taken; head_dim must be 16, 32, 64 or
128.

Two hand-written kernels of ``csrc/flash_attention.cu`` serve a CUDA
tensor, both launched and counted as ``flash_attention``:

* bf16 at head_dim 64 or 128 (the serving path): ``flash_fwd_wgmma_kernel``,
  tensor cores (wgmma, fp32 accumulators, P rounded to bf16 for P.V) fed
  by TMA;
* fp32 at any head_dim, and bf16 at 16 or 32: ``flash_fwd_simt_kernel``,
  full fp32 products on the CUDA cores.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels._build import (check_operand, dtype_code,
                                        register_kernel, stream_handle)
from repro_torch.kernels.ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = register_kernel(
    "flash_attention", "repro_flash_attention",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P])


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool = True, scale: Optional[float] = None
          ) -> torch.Tensor:
    return attention_ref(q, k, v, causal=causal, scale=scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """q: (b, sq, hq, d); k, v: (b, skv, hkv, d) -> (b, sq, hq, d)."""
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
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
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    if skv == 0:
        raise ValueError("flash_attention needs skv >= 1")
    KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           b, sq, skv, hq, hkv, d, float(scale), int(causal), dtype_code(q),
           stream_handle(q.device))
    return out
