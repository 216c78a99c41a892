"""W8A8 int8 matmul: the CUDA kernel ``csrc/int8_matmul.cu`` and its plain
version.

Replaces ``src/repro/kernels/int8_matmul.py::int8_matmul`` of the JAX
package. A tensor on the CPU goes to the plain version
(``ref.int8_matmul_ref``); a CUDA tensor goes to the kernel, or the call
raises. Any m, k, n and any alignment are taken (the Pallas kernel needs
them divisible by its blocks): :func:`plan` picks the kernel's load
routine and output tile. No model path calls it, in either package. It
has no backward: on the card, a call that autograd would record (a scale
that requires grad) raises ``NotImplementedError``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (DTYPE_CODES, check_operand,
                                        num_sms, on_card, refuse_grad,
                                        register_kernel, stream_handle)
from repro_torch.kernels.ref import int8_matmul_ref

# |x_q w_q| <= 128^2 k must fit the kernel's int32 sums.
MAX_K = (2 ** 31 - 1) // 128 ** 2
# Output tiles (rows, columns) of the kernel, by its ``tile`` code: 64
# rows for each warpgroup.
TILES = ((192, 128), (128, 128), (64, 128), (64, 64))
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = register_kernel("int8_matmul", "repro_int8_matmul",
                         [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])


def plan(m: int, k: int, n: int, x_ptr: int, w_ptr: int,
         num_sms: int) -> tuple[bool, int]:
    """(vec, tile) of a launch: 16-byte loads where k and n are multiples
    of 16 and both operands are 16-byte aligned, else masked byte loads;
    the largest tile of ``TILES`` that still keeps half the SMs busy (a
    larger tile reads fewer bytes from L2 for each product, and one wave
    of large tiles beats two of smaller ones), else the smallest."""
    vec = k % 16 == 0 and n % 16 == 0 and x_ptr % 16 == 0 and \
        w_ptr % 16 == 0
    for tile, (bm, bn) in enumerate(TILES):
        if 2 * -(-m // bm) * -(-n // bn) >= num_sms:
            return vec, tile
    return vec, len(TILES) - 1


def plain(x_q, sx, w_q, sw, out_dtype=torch.float32) -> torch.Tensor:
    return int8_matmul_ref(x_q, sx, w_q, sw).to(out_dtype)


def int8_matmul(x_q: torch.Tensor, sx: torch.Tensor, w_q: torch.Tensor,
                sw: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """x_q: (m, k) int8; sx: (m,) fp32; w_q: (k, n) int8; sw: (n,) fp32
    -> (m, n) in ``out_dtype`` (float32 or bfloat16)."""
    if not on_card(x_q, "int8_matmul"):
        return plain(x_q, sx, w_q, sw, out_dtype)
    refuse_grad("int8_matmul", sx, sw)
    check_operand("x_q", x_q, x_q.device, 2, torch.int8, aligned=False)
    check_operand("w_q", w_q, x_q.device, 2, torch.int8, aligned=False)
    check_operand("sx", sx, x_q.device, 1, torch.float32)
    check_operand("sw", sw, x_q.device, 1, torch.float32)
    m, k = x_q.shape
    k2, n = w_q.shape
    if k2 != k or sx.shape[0] != m or sw.shape[0] != n:
        raise ValueError(f"shapes x_q {tuple(x_q.shape)}, sx "
                         f"{tuple(sx.shape)}, w_q {tuple(w_q.shape)}, sw "
                         f"{tuple(sw.shape)} do not fit")
    if k > MAX_K:
        raise ValueError(f"k={k} > {MAX_K} could overflow the int32 sums")
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    out = torch.empty((m, n), dtype=out_dtype, device=x_q.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    vec, tile = plan(m, k, n, x_q.data_ptr(), w_q.data_ptr(),
                     num_sms(x_q.device))
    KERNEL(x_q.data_ptr(), sx.data_ptr(), w_q.data_ptr(), sw.data_ptr(),
           out.data_ptr(), m, k, n, DTYPE_CODES[out_dtype], int(vec), tile,
           stream_handle(x_q.device))
    return out
