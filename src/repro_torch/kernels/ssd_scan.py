"""Mamba-2 SSD chunked scan: the CUDA kernels ``csrc/ssd_scan.cu`` and
``csrc/ssd_scan_bwd.cu`` and their plain versions.

Replaces ``src/repro/kernels/ssd_scan.py::ssd_scan`` of the JAX package. A
tensor on the CPU goes to the plain version (``ref.ssd_chunked``); a CUDA
tensor goes to a kernel, or the call raises; a fake CUDA tensor to the
kernel's fake path (checked, outputs allocated, counted by the dry run,
not launched). Both take the inputs the JAX wrapper takes:
``s <= chunk`` or ``s % chunk == 0``, else ``ValueError``. The kernels
run their own tile of ``TILE`` steps over the sequence; the result does
not depend on the chunk beyond rounding.
:func:`plan` picks one of two forward designs: the tensor-core one (bf16,
three launches parallel over the tiles, scratch from the caching
allocator) or the CUDA-core one (float32, and bf16 shapes the first does
not take).

Where autograd records the call (grad mode on, an input that requires
grad), it runs through :class:`SSDScanFunction`: the same forward, and a
backward that is ``csrc/ssd_scan_bwd.cu`` on the card and the closed form
``ref.ssd_chunked_bwd_ref`` on the CPU. :func:`bwd_design` picks one of
two backward designs, as :func:`plan` does for the forward: the
tensor-core one (bf16, three launches) or the CUDA-core one (float32, and
bf16 shapes the first does not take; four launches); either call counts
as one ``ssd_scan_bwd``, and :func:`bwd_plan` sizes its scratch. Under
no_grad a call launches the forward alone, as before.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (check_operand, dtype_code, is_fake,
                                        needs_grad, on_card,
                                        register_kernel, stream_handle)
from repro_torch.kernels.ref import (check_ssd_chunk, ssd_chunked,
                                     ssd_chunked_bwd_ref)
from repro_torch.roofline import kernel_cost

MAX_STATE = 256          # d_state either design's shared memory holds
TC_MAX_HEADDIM = 64      # head dim the tensor-core design's smem holds
TC_BWD_MAX_STATE = 128   # d_state the tensor-core backward's registers hold
TC_BWD_GROUPS = 4        # its blocks a (tile, batch), each a group of heads
TILE = 64                # steps a tile of the tensor-core design
SIMT, TENSOR_CORES = 0, 1             # design codes of the C entry point
DESIGNS = {SIMT: "simt", TENSOR_CORES: "tensor_cores"}
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = register_kernel(
    "ssd_scan", "repro_ssd_scan",
    [_P] * 11 + [_I] * 7 + [_P])
KERNEL_BWD = register_kernel(
    "ssd_scan_bwd", "repro_ssd_scan_bwd",
    [_P] * 15 + [_I] * 7 + [_P])
BWD_TILE = 64            # steps a tile of the backward (csrc/ssd_scan_bwd.cu)


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


def bwd_design(dtype: torch.dtype, n: int, p: int) -> int:
    """The design of a backward launch (``csrc/ssd_scan_bwd.cu``):
    ``TENSOR_CORES`` for bfloat16 where d_state ``n`` and the head dim
    ``p`` are multiples of 16, n <= ``TC_BWD_MAX_STATE`` and p <=
    ``TC_MAX_HEADDIM``; else ``SIMT`` for float32 or bfloat16 with
    1 <= n <= ``MAX_STATE`` and any p, the shapes the forward takes;
    anything else raises."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssd_scan takes float32 or bfloat16, got {dtype}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"d_state {n} not in 1..{MAX_STATE}")
    if dtype == torch.bfloat16 and n % 16 == 0 and p % 16 == 0 and \
            n <= TC_BWD_MAX_STATE and 16 <= p <= TC_MAX_HEADDIM:
        return TENSOR_CORES
    return SIMT


def bwd_plan(dtype: torch.dtype, b: int, s: int, h: int, p: int, n: int,
             design: int | None = None) -> int:
    """The fp32 scratch floats of a backward launch of ``design``
    (:func:`bwd_design`'s by default; either raises where that one does).
    ``SIMT``: the tile states and their gradients (b, h, tiles, p, n)
    twice, decays and the dA and dD partials (b, h, tiles) three times, and
    the per-head dB and dC partials (b, h, s, n) twice. ``TENSOR_CORES``:
    the state entering each tile and the gradient of the state leaving it,
    each (b, h, tiles, 2, p, n) as bf16 hi/lo pairs (half a float each),
    the dB and dC sums of each group of heads (b, groups, s, n) twice,
    sized for min(``TC_BWD_GROUPS``, h) groups (the kernel's own split
    has no more), and the dA and dD partials (b, h, tiles) twice."""
    chosen = bwd_design(dtype, n, p)
    design = chosen if design is None else design
    if design == TENSOR_CORES and chosen != TENSOR_CORES:
        raise ValueError(f"the tensor-core backward does not take {dtype} "
                         f"at d_state {n}, head dim {p}")
    tiles = -(-s // BWD_TILE)
    if design == TENSOR_CORES:
        return 2 * b * h * tiles * p * n + 2 * b * min(TC_BWD_GROUPS, h) * s * n + \
            2 * b * h * tiles
    return 2 * b * h * tiles * p * n + 3 * b * h * tiles + 2 * b * h * s * n


def plain(x, dt, A, B, C, D, *, chunk: int = 256):
    return ssd_chunked(x, dt, A, B, C, D, chunk=chunk)


def plain_bwd(x, dt, A, B, C, D, dy, dstate=None, *, chunk: int = 256):
    """(dx, ddt, dA, dB, dC, dD) in closed form; ``dstate`` may be None."""
    return ssd_chunked_bwd_ref(x, dt, A, B, C, D, dy, dstate, chunk=chunk)


class SSDScanFunction(torch.autograd.Function):
    """ssd_scan with its backward: the kernels on the card (the states
    entering each tile recomputed there, so the forward saves only its
    inputs), the closed form ``plain_bwd`` on the CPU. The final state's
    gradient may be None (training reads y alone)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, D)
        ctx.chunk = chunk
        return _forward(x, dt, A, B, C, D, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C, D = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dstate is not None:
            dstate = dstate.contiguous()
        if on_card(x, "ssd_scan"):
            grads = _kernel_backward(x, dt, A, B, C, D, dy, dstate,
                                     chunk=ctx.chunk)
        else:
            grads = plain_bwd(x, dt, A, B, C, D, dy, dstate,
                              chunk=ctx.chunk)
        return (*grads, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 256):
    """x: (b, s, h, p); dt: (b, s, h) fp32; A, D: (h,) fp32; B, C:
    (b, s, n) in x's dtype -> (y (b, s, h, p) in x's dtype, final state
    (b, h, p, n) fp32)."""
    if needs_grad(x, dt, A, B, C, D):
        return SSDScanFunction.apply(x, dt, A, B, C, D, chunk)
    return _forward(x, dt, A, B, C, D, chunk)


def _forward(x, dt, A, B, C, D, chunk: int):
    if not on_card(x, "ssd_scan"):
        return plain(x, dt, A, B, C, D, chunk=chunk)
    return _kernel_forward(x, dt, A, B, C, D, chunk)


def _check(x, dt, A, B, C, D) -> tuple[int, int, int, int, int]:
    """The operand checks of both kernels; returns (b, s, h, p, n)."""
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
    return b, s, h, p, n


def _kernel_forward(x, dt, A, B, C, D, chunk: int):
    b, s, h, p, n = _check(x, dt, A, B, C, D)
    check_ssd_chunk(s, chunk)
    design = plan(x.dtype, n, p)
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        state.zero_()
        return y, state
    if is_fake(x):
        KERNEL.fake_call(kernel_cost.ssd(b, s, h, p, n, x.dtype, chunk))
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


def _kernel_backward(x, dt, A, B, C, D, dy, dstate, design=None,
                     chunk: int = 256):
    """(dx, ddt, dA, dB, dC, dD) from one ``repro_ssd_scan_bwd`` call of
    ``design`` (:func:`bwd_design`'s by default, as training calls it);
    ``dstate`` (b, h, p, n) fp32 or None for zero. ``chunk``, the
    forward's, sizes only a fake call's count of work."""
    b, s, h, p, n = _check(x, dt, A, B, C, D)
    check_operand("dy", dy, x.device, 4, x.dtype, aligned=False)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    if dstate is not None:
        check_operand("dstate", dstate, x.device, 4, torch.float32,
                      aligned=False)
        if dstate.shape != (b, h, p, n):
            raise ValueError(f"dstate {tuple(dstate.shape)} is not "
                             f"{(b, h, p, n)}")
    design = bwd_design(x.dtype, n, p) if design is None else design
    work_floats = bwd_plan(x.dtype, b, s, h, p, n, design)
    grads = tuple(torch.empty_like(t) for t in (x, dt, A, B, C, D))
    if x.numel() == 0:
        return tuple(g.zero_() for g in grads)
    if is_fake(x):
        KERNEL_BWD.fake_call(kernel_cost.ssd_bwd(b, s, h, p, n, x.dtype,
                                                 chunk, dstate is not None))
        return grads
    if design == TENSOR_CORES and dy.data_ptr() % 16:
        dy = dy.clone()         # its rows go to shared memory by cp.async
    work = torch.empty(work_floats, dtype=torch.float32, device=x.device)
    KERNEL_BWD(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
               C.data_ptr(), D.data_ptr(), dy.data_ptr(),
               None if dstate is None else dstate.data_ptr(),
               *(g.data_ptr() for g in grads), work.data_ptr(),
               b, s, h, p, n, dtype_code(x), design, stream_handle(x.device))
    return grads
