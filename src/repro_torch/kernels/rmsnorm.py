"""RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` and its plain version.

Replaces ``src/repro/kernels/rmsnorm.py::rmsnorm`` of the JAX package. A
tensor on the CPU goes to the plain version (``ref.rmsnorm_ref``, or
``ref.rmsnorm_lowp`` with ``lowp``); a CUDA tensor goes to the kernel, or
the call raises. :func:`plan` sets the kernel's launch: its load width,
the 16-byte chunks a lane holds, the warps a row and the rows a block.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (check_operand, dtype_code,
                                        register_kernel, stream_handle)
from repro_torch.kernels.ref import rmsnorm_lowp, rmsnorm_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = register_kernel("rmsnorm", "repro_rmsnorm",
                         [_P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _I, _I,
                          _P])
MAX_NV = 8      # chunks a lane holds in registers
MAX_WPR = 8     # warps a row
MAX_ROWS_PER_BLOCK = 8
ROW_BLOCKS = 128    # blocks a launch of one-warp rows aims at: ~1 an SM


def plan(rows: int, d: int, element_size: int, aligned: bool
         ) -> tuple[bool, int, int, int]:
    """(vec, nv, wpr, rows_per_block) of a launch (``csrc/rmsnorm.cu``).

    vec: chunks of 16 bytes, where d fills them and every pointer is
    16-byte aligned; else chunks of one element. A row of ``d // chunk``
    chunks is held by ``wpr`` warps, ``nv`` chunks a lane: one warp and
    just enough chunks where 32 x MAX_NV 16-byte chunks hold the row, else
    MAX_NV chunks and the fewest warps (a power of two up to MAX_WPR) that
    hold it; wider rows stream the rest. One-warp rows go several to a
    block once there are more than ROW_BLOCKS, so a short tick puts each
    row on an SM of its own."""
    vec = aligned and (d * element_size) % 16 == 0
    chunks = d * element_size // 16 if vec else d
    if vec and chunks <= 32 * MAX_NV:
        nv, wpr = -(-chunks // 32), 1
    else:
        nv, wpr = MAX_NV, 1
        while wpr < MAX_WPR and wpr * 32 * nv < chunks:
            wpr *= 2
    rows_per_block = min(MAX_ROWS_PER_BLOCK, max(1, rows // ROW_BLOCKS)) \
        if wpr == 1 else 1
    return vec, nv, wpr, rows_per_block


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
    check_operand("x", x, x.device, x.dim(), aligned=False)
    check_operand("w", w, x.device, 1, torch.float32, aligned=False)
    if w.shape[0] != d:
        raise ValueError(f"w has {w.shape[0]} entries, x rows have {d}")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    vec, nv, wpr, rpb = plan(rows, d, x.element_size(),
                             x.data_ptr() % 16 == 0 and
                             w.data_ptr() % 16 == 0)
    KERNEL(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d, float(eps),
           int(lowp), dtype_code(x), int(vec), nv, wpr, rpb,
           stream_handle(x.device))
    return out
