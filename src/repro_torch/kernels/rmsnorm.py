"""RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` and its plain version.

Replaces ``src/repro/kernels/rmsnorm.py::rmsnorm`` of the JAX package. A
tensor on the CPU goes to the plain version (``ref.rmsnorm_ref``, or
``ref.rmsnorm_lowp`` with ``lowp``); a CUDA tensor goes to the kernel, or
the call raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (check_operand, dtype_code,
                                        register_kernel, stream_handle)
from repro_torch.kernels.ref import rmsnorm_lowp, rmsnorm_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = register_kernel("rmsnorm", "repro_rmsnorm",
                         [_P, _P, _P, _I, _I, _F, _I, _I, _P])


def plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
          lowp: bool = False) -> torch.Tensor:
    return rmsnorm_lowp(x, w, eps) if lowp else rmsnorm_ref(x, w, eps)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
            lowp: bool = False) -> torch.Tensor:
    """x: (..., d) float32/bfloat16, w: (d,) float32 -> x's shape/dtype."""
    if x.device.type == "cpu":
        return plain(x, w, eps, lowp)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    d = x.shape[-1]
    check_operand("x", x, x.device, x.dim())
    check_operand("w", w, x.device, 1, torch.float32)
    if w.shape[0] != d:
        raise ValueError(f"w has {w.shape[0]} entries, x rows have {d}")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    KERNEL(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d, float(eps),
           int(lowp), dtype_code(x), stream_handle(x.device))
    return out
