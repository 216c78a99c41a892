"""RMSNorm: the CUDA kernels ``csrc/rmsnorm.cu`` and their plain versions.

Replaces ``src/repro/kernels/rmsnorm.py::rmsnorm`` of the JAX package. A
tensor on the CPU goes to the plain version (``ref.rmsnorm_ref``, or
``ref.rmsnorm_lowp`` with ``lowp``); a CUDA tensor goes to the kernel, or
the call raises; a fake CUDA tensor to the kernel's fake path
(``_build.is_fake``: checked, outputs allocated, counted by the dry run,
not launched). :func:`plan` sets the kernel's launch: its load width,
the 16-byte chunks a lane holds, the warps a row and the rows a block.

Where autograd records the call (grad mode on, an input that requires
grad), it runs through :class:`RMSNormFunction`: the same forward, and a
backward that is one C call on the card (counted as ``rmsnorm_bwd``;
:func:`bwd_design` picks its design, :func:`bwd_plan` sets its launch) and
the closed form on the CPU (``ref.rmsnorm_bwd_ref``, or
``ref.rmsnorm_lowp_bwd_ref`` with ``lowp``: ``jax.grad`` of
``ref.rmsnorm_lowp``, whose multiply chain and its backward run in bf16).
Both directions take any row width, with or without ``lowp``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels._build import (check_operand, dtype_code, is_fake,
                                        needs_grad, num_sms, on_card,
                                        register_kernel, stream_handle)
from repro_torch.kernels.ref import (rmsnorm_bwd_ref, rmsnorm_lowp,
                                     rmsnorm_lowp_bwd_ref, rmsnorm_ref)
from repro_torch.roofline import kernel_cost

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = register_kernel("rmsnorm", "repro_rmsnorm",
                         [_P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _I, _I,
                          _P])
KERNEL_BWD = register_kernel("rmsnorm_bwd", "repro_rmsnorm_bwd",
                             [_P] * 6 + [_I, _I, _F] + [_I] * 8 + [_P])
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


# Designs of the backward (``csrc/rmsnorm.cu``), codes of its C entry point:
# block_rows, a block a row at a time, then a second kernel for dw (the
# first design); ring, one persistent block an SM streaming its rows
# through a shared-memory ring, dw's column sums after a grid sync in the
# same launch; stream, a block a row at a time in two passes over the row
# (its sums, then dx and dw), nothing of it held, for rows of any width.
BLOCK_ROWS, RING, STREAM = 0, 1, 2
BWD_DESIGNS = {BLOCK_ROWS: "block_rows", RING: "ring", STREAM: "stream"}
BWD_THREADS = 256       # threads a block of block_rows and stream
BWD_MAX_CHUNKS = 2048   # chunks a row of ring and block_rows, at most
BWD_BLOCKS_PER_SM = 2   # block_rows: blocks an SM
# block_rows: chunks a thread at most, of 16 bytes and of one element
BLOCK_ROWS_MAX_NV = {True: 4, False: 8}
RING_WARPS = 16                 # warps a block of the ring design
RING_MAX_NV = 4                 # chunks a lane of the ring design
RING_BYTES = 192 * 1024         # ring slots a block, at most
RING_MAX_SLOTS = 128            # ring slots (mbarriers) a block, at most


class BwdPlan(NamedTuple):
    """A backward launch: ``design``; ``vec`` (16-byte chunks, else one
    element); ``nv`` chunks a lane (block_rows: a thread); ``wpr`` warps a
    row and ``spg`` ring slots a row group (ring); ``blocks``."""
    design: int
    vec: bool
    nv: int
    wpr: int
    spg: int
    blocks: int


def _chunks(d: int, element_size: int, aligned: bool) -> tuple[bool, int]:
    """(vec, chunks): 16-byte chunks where d fills them and every pointer is
    16-byte aligned, else single elements."""
    vec = aligned and (d * element_size) % 16 == 0
    return vec, d * element_size // 16 if vec else d


def bwd_design(d: int, element_size: int, aligned: bool) -> int:
    """``RING`` where the row is at most ``BWD_MAX_CHUNKS`` 16-byte chunks,
    which its bulk copies need; ``BLOCK_ROWS`` where it is at most as many
    single elements; ``STREAM`` for every wider row."""
    vec, chunks = _chunks(d, element_size, aligned)
    if chunks > BWD_MAX_CHUNKS:
        return STREAM
    return RING if vec else BLOCK_ROWS


def bwd_plan(rows: int, d: int, element_size: int, aligned: bool,
             num_sms: int, design: Optional[int] = None) -> BwdPlan:
    """The launch of ``design`` (:func:`bwd_design`'s by default). A design
    that does not take the row raises: ring and block_rows past
    ``BWD_MAX_CHUNKS`` chunks, or where their other limits say so.

    block_rows: ``nv`` the least power of two with ``nv * BWD_THREADS``
    chunks >= the row's (up to ``BLOCK_ROWS_MAX_NV``); ``blocks`` blocks of
    one row at a time, each writing one fp32 partial row of dw, at most
    ``BWD_BLOCKS_PER_SM`` an SM.

    ring: 16-byte chunks only. One warp a row and just enough chunks a
    lane where 32 x ``RING_MAX_NV`` chunks hold the row, else
    ``RING_MAX_NV`` chunks and the fewest warps (2, 4, 8 or 16) that hold
    it; one block an SM (at most one a row), each a contiguous range of
    rows; ``spg`` slots for each of the ``RING_WARPS // wpr`` row groups:
    enough for the group's rows, within ``RING_BYTES`` and
    ``RING_MAX_SLOTS``. The C side sizes the launch's shared memory and
    refuses a plan that does not fit a block.

    stream: any row, ``blocks`` as block_rows'."""
    vec, chunks = _chunks(d, element_size, aligned)
    design = bwd_design(d, element_size, aligned) if design is None \
        else design
    row_blocks = max(1, min(rows, BWD_BLOCKS_PER_SM * num_sms))
    if design == STREAM:
        return BwdPlan(STREAM, vec, 1, 1, 0, row_blocks)
    if chunks > BWD_MAX_CHUNKS:
        raise ValueError(f"the {BWD_DESIGNS.get(design, design)} design "
                         f"takes rows of at most {BWD_MAX_CHUNKS} chunks, "
                         f"got {chunks}")
    if design == BLOCK_ROWS:
        nv = 1
        while nv * BWD_THREADS < chunks:
            nv *= 2
        if nv > BLOCK_ROWS_MAX_NV[vec]:
            raise ValueError(f"block_rows takes rows of at most "
                             f"{BLOCK_ROWS_MAX_NV[vec] * BWD_THREADS} "
                             f"chunks of this size, got {chunks}")
        return BwdPlan(BLOCK_ROWS, vec, nv, 1, 0, row_blocks)
    if design != RING:
        raise ValueError(f"unknown rmsnorm backward design {design}")
    if not vec:
        raise ValueError("the ring design takes 16-byte chunks: d a "
                         "multiple of 16 bytes, every pointer aligned")
    if chunks <= 32 * RING_MAX_NV:
        nv, wpr = -(-chunks // 32), 1
    else:
        nv, wpr = RING_MAX_NV, 2
        while wpr * 32 * nv < chunks:
            wpr *= 2
    groups = RING_WARPS // wpr
    blocks = max(1, min(rows, num_sms))
    per_block = -(-rows // blocks)
    spg = max(1, min(-(-per_block // groups),
                     RING_BYTES // (groups * 2 * d * element_size),
                     RING_MAX_SLOTS // groups))
    return BwdPlan(design, True, nv, wpr, spg, blocks)


def plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
          lowp: bool = False) -> torch.Tensor:
    return rmsnorm_lowp(x, w, eps) if lowp else rmsnorm_ref(x, w, eps)


def plain_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
              eps: float = 1e-5, lowp: bool = False
              ) -> tuple[torch.Tensor, torch.Tensor]:
    if lowp:
        return rmsnorm_lowp_bwd_ref(x, w, dy, eps)
    return rmsnorm_bwd_ref(x, w, dy, eps)


class RMSNormFunction(torch.autograd.Function):
    """rmsnorm with its backward: kernels on the card, the closed form
    ``plain_bwd`` on the CPU."""

    @staticmethod
    def forward(ctx, x, w, eps, lowp=False):
        ctx.save_for_backward(x, w)
        ctx.eps, ctx.lowp = eps, lowp
        return _forward(x, w, eps, lowp)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        if on_card(x, "rmsnorm"):
            dx, dw = _kernel_backward(x, w, dy, ctx.eps, lowp=ctx.lowp)
        else:
            dx, dw = plain_bwd(x, w, dy, ctx.eps, ctx.lowp)
        return dx, dw, None, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
            lowp: bool = False) -> torch.Tensor:
    """x: (..., d) float32/bfloat16, w: (d,) float32 -> x's shape/dtype."""
    if needs_grad(x, w):
        return RMSNormFunction.apply(x, w, eps, lowp)
    return _forward(x, w, eps, lowp)


def _forward(x: torch.Tensor, w: torch.Tensor, eps: float,
             lowp: bool) -> torch.Tensor:
    if not on_card(x, "rmsnorm"):
        return plain(x, w, eps, lowp)
    return _kernel_forward(x, w, eps, lowp)


def _kernel_forward(x: torch.Tensor, w: torch.Tensor, eps: float,
                    lowp: bool) -> torch.Tensor:
    d = x.shape[-1]
    check_operand("x", x, x.device, x.dim(), aligned=False)
    check_operand("w", w, x.device, 1, torch.float32, aligned=False)
    if w.shape[0] != d:
        raise ValueError(f"w has {w.shape[0]} entries, x rows have {d}")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    if is_fake(x):
        KERNEL.fake_call(kernel_cost.rmsnorm(rows, d, x.element_size()))
        return out
    vec, nv, wpr, rpb = plan(rows, d, x.element_size(),
                             x.data_ptr() % 16 == 0 and
                             w.data_ptr() % 16 == 0)
    KERNEL(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d, float(eps),
           int(lowp), dtype_code(x), int(vec), nv, wpr, rpb,
           stream_handle(x.device))
    return out


def _kernel_backward(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                     eps: float, design: Optional[int] = None,
                     lowp: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """dx, dw on the card, by ``design`` (:func:`bwd_design`'s by default,
    as training calls it); raises where that design does not take the
    row. ``lowp``: the gradient of ``ref.rmsnorm_lowp`` (in fp32 the plain
    one's arithmetic)."""
    d = x.shape[-1]
    check_operand("x", x, x.device, x.dim(), aligned=False)
    check_operand("w", w, x.device, 1, torch.float32, aligned=False)
    check_operand("dy", dy, x.device, x.dim(), x.dtype, aligned=False)
    if dy.shape != x.shape or w.shape[0] != d:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"dy {tuple(dy.shape)} do not fit")
    dx = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return dx, torch.zeros_like(w)
    dw = torch.empty_like(w)
    if is_fake(x):
        KERNEL_BWD.fake_call(kernel_cost.rmsnorm_bwd(rows, d,
                                                     x.element_size()))
        return dx, dw
    p = bwd_plan(rows, d, x.element_size(),
                 all(t.data_ptr() % 16 == 0 for t in (x, w, dy, dx)),
                 num_sms(x.device), design)
    part = torch.empty((p.blocks, d), dtype=torch.float32, device=x.device)
    KERNEL_BWD(x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
               dw.data_ptr(), part.data_ptr(), rows, d, float(eps),
               int(lowp), dtype_code(x), p.design, int(p.vec), p.nv, p.wpr,
               p.spg, p.blocks, stream_handle(x.device))
    return dx, dw
