"""Mamba-2 SSD chunked scan: the CUDA kernels ``csrc/ssd_scan.cu`` and their
plain version.

Replaces ``src/repro/kernels/ssd_scan.py::ssd_scan`` of the JAX package. A
tensor on the CPU goes to the plain version (``ref.ssd_chunked``); a CUDA
tensor goes to a kernel, or the call raises. Both take the inputs the
JAX wrapper takes: ``s <= chunk`` or ``s % chunk == 0``, else
``ValueError``. The kernels run their own tile of ``TILE`` steps over the
sequence; the result does not depend on the chunk beyond rounding.
:func:`plan` picks one of two designs: the tensor-core one (bf16, three
launches parallel over the tiles, scratch from the caching allocator) or
the CUDA-core one (float32, and bf16 shapes the first does not take).
Neither has a backward: on the card, a call that autograd would record
raises ``NotImplementedError`` (mamba2 training waits for one).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (check_operand, dtype_code,
                                        on_card, refuse_grad,
                                        register_kernel, stream_handle)
from repro_torch.kernels.ref import check_ssd_chunk, ssd_chunked

MAX_STATE = 256          # d_state either design's shared memory holds
TC_MAX_HEADDIM = 64      # head dim the tensor-core design's smem holds
TILE = 64                # steps a tile of the tensor-core design
SIMT, TENSOR_CORES = 0, 1             # design codes of the C entry point
DESIGNS = {SIMT: "simt", TENSOR_CORES: "tensor_cores"}
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = register_kernel(
    "ssd_scan", "repro_ssd_scan",
    [_P] * 11 + [_I] * 7 + [_P])


def plan(dtype: torch.dtype, n: int, p: int) -> int:
    """The design of a launch: ``TENSOR_CORES`` for bfloat16 where d_state
    ``n`` and the head dim ``p`` are multiples of 16, n <= ``MAX_STATE``
    and p <= ``TC_MAX_HEADDIM``; else ``SIMT`` for float32 or bfloat16 with
    1 <= n <= ``MAX_STATE``; anything else raises."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssd_scan takes float32 or bfloat16, got {dtype}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"d_state {n} not in 1..{MAX_STATE}")
    if dtype == torch.bfloat16 and n % 16 == 0 and p % 16 == 0 and \
            16 <= p <= TC_MAX_HEADDIM:
        return TENSOR_CORES
    return SIMT


def plain(x, dt, A, B, C, D, *, chunk: int = 256):
    return ssd_chunked(x, dt, A, B, C, D, chunk=chunk)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 256):
    """x: (b, s, h, p); dt: (b, s, h) fp32; A, D: (h,) fp32; B, C:
    (b, s, n) in x's dtype -> (y (b, s, h, p) in x's dtype, final state
    (b, h, p, n) fp32)."""
    if not on_card(x, "ssd_scan"):
        return plain(x, dt, A, B, C, D, chunk=chunk)
    refuse_grad("ssd_scan", x, dt, A, B, C, D)
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
    design = plan(x.dtype, n, p)
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        state.zero_()
        return y, state
    scratch = (0, 0, 0)
    if design == TENSOR_CORES:      # tile states, decays, entering states
        tiles = -(-s // TILE)
        g = torch.empty((b, h, tiles, p, n), dtype=torch.float32,
                        device=x.device)
        decay = torch.empty((b, h, tiles), dtype=torch.float32,
                            device=x.device)
        hp = torch.empty((b, h, tiles, 2, p, n), dtype=torch.bfloat16,
                         device=x.device)
        scratch = (g.data_ptr(), decay.data_ptr(), hp.data_ptr())
    KERNEL(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
           C.data_ptr(), D.data_ptr(), y.data_ptr(), state.data_ptr(),
           *scratch, b, s, h, p, n, dtype_code(x), design,
           stream_handle(x.device))
    return y, state
