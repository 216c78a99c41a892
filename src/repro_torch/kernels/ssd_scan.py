"""Mamba-2 SSD chunked scan: the CUDA kernel ``csrc/ssd_scan.cu`` and its
plain version.

Replaces ``src/repro/kernels/ssd_scan.py::ssd_scan`` of the JAX package. A
tensor on the CPU goes to the plain version (``ref.ssd_chunked``); a CUDA
tensor goes to the kernel, or the call raises. Both take the inputs the
JAX wrapper takes: ``s <= chunk`` or ``s % chunk == 0``, else
``ValueError``. The kernel runs its own tile over the sequence; the result
does not depend on the chunk beyond rounding.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (check_operand, dtype_code,
                                        register_kernel, stream_handle)
from repro_torch.kernels.ref import check_ssd_chunk, ssd_chunked

MAX_STATE = 256          # d_state the kernel's shared memory holds
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = register_kernel(
    "ssd_scan", "repro_ssd_scan",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])


def plain(x, dt, A, B, C, D, *, chunk: int = 256):
    return ssd_chunked(x, dt, A, B, C, D, chunk=chunk)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 256):
    """x: (b, s, h, p); dt: (b, s, h) fp32; A, D: (h,) fp32; B, C:
    (b, s, n) in x's dtype -> (y (b, s, h, p) in x's dtype, final state
    (b, h, p, n) fp32)."""
    if x.device.type == "cpu":
        return plain(x, dt, A, B, C, D, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    check_operand("x", x, x.device, 4)
    check_operand("dt", dt, x.device, 3, torch.float32)
    check_operand("A", A, x.device, 1, torch.float32)
    check_operand("D", D, x.device, 1, torch.float32)
    check_operand("B", B, x.device, 3, x.dtype)
    check_operand("C", C, x.device, 3, x.dtype)
    b, s, h, p = x.shape
    n = B.shape[-1]
    if dt.shape != (b, s, h) or A.shape != (h,) or D.shape != (h,) or \
            B.shape != (b, s, n) or C.shape != (b, s, n):
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}, D {tuple(D.shape)} do not fit")
    check_ssd_chunk(s, chunk)
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"d_state {n} not in 1..{MAX_STATE}")
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        state.zero_()
        return y, state
    KERNEL(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
           C.data_ptr(), D.data_ptr(), y.data_ptr(), state.data_ptr(),
           b, s, h, p, n, dtype_code(x), stream_handle(x.device))
    return y, state
