"""Gradient compression for data-parallel sync over weak links.

Directly motivated by the paper's setting: the SoC Cluster's inter-unit
fabric is ~1 Gbps — two orders of magnitude below datacenter interconnects —
so cross-unit synchronization must ship fewer bytes. We provide blockwise
int8 quantization with error feedback and a compressed all-reduce
(all-to-all reduce-scatter in int8 wire format + int8 all-gather: 2x N/4
bytes on the wire instead of 2x N fp32 bytes).

The JAX package's ``distributed/compression.py`` in PyTorch.
``compressed_psum_mean`` runs on one rank's tensor with a
``ProcessGroup`` in the place of an axis name. ``torch.round`` rounds half
to even as ``jnp.round`` does, and the divisions are IEEE on both sides,
so the linear int8 codes are JAX's bit for bit; the log-space codes go
through ``log``, whose last bit may differ between the two libraries.
Every division by a constant divides by a tensor on the operand's device
(``_div``): PyTorch's CUDA kernels turn a division by a Python number into
a product with its reciprocal, which may round differently.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed import ProcessGroup


# ---------------------------------------------------------------------------
# Blockwise int8 quantization.
# ---------------------------------------------------------------------------
def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every device."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _blocks(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, block), pad


def quantize_blockwise(x: torch.Tensor, block: int = 256
                       ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """x: any shape -> (q int8 (nb, block), scales (nb,), pad)."""
    blocks, pad = _blocks(x, block)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax == 0, 1.0, _div(amax, 127.0))
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0], pad


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor, pad: int,
                         shape, dtype=torch.float32) -> torch.Tensor:
    flat = (q.to(torch.float32) * scales[:, None]).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape).to(dtype)


def quantize_blockwise_log(x: torch.Tensor, block: int = 256,
                           tiny: float = 1e-30
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, int]:
    """Log-space blockwise int8 for *non-negative* tensors (e.g. Adam's
    second moment): per-block (min, max) of log(x+tiny) mapped to [0, 255],
    giving bounded *relative* error — linear int8 would collapse small
    entries to zero and blow up 1/sqrt(v).

    Returns (q uint8 (nb, block), log_min (nb,), log_scale (nb,), pad)."""
    flat, pad = _blocks(x, block)
    blocks = torch.log(flat + tiny)
    lo = blocks.amin(dim=1, keepdim=True)
    hi = blocks.amax(dim=1, keepdim=True)
    scale = _div(torch.clamp_min(hi - lo, 1e-12), 255.0)
    q = torch.clamp(torch.round((blocks - lo) / scale), 0, 255).to(
        torch.uint8)
    return q, lo[:, 0], scale[:, 0], pad


def dequantize_blockwise_log(q: torch.Tensor, log_min: torch.Tensor,
                             log_scale: torch.Tensor, pad: int, shape,
                             tiny: float = 1e-30) -> torch.Tensor:
    logs = q.to(torch.float32) * log_scale[:, None] + log_min[:, None]
    flat = torch.exp(logs).reshape(-1) - tiny
    if pad:
        flat = flat[:-pad]
    return torch.clamp_min(flat, 0.0).reshape(shape)


def quantize_with_feedback(x: torch.Tensor, err: torch.Tensor,
                           block: int = 256):
    """Error-feedback quantization: q = Q(x + err); err' = (x+err) - deQ(q).

    Returns ((q, scales, pad), new_err). The residual is re-injected on the
    next step so the quantization error does not bias the optimizer
    trajectory (1-bit-Adam-style memory compensation).
    """
    target = x.to(torch.float32) + err
    q, scales, pad = quantize_blockwise(target, block)
    approx = dequantize_blockwise(q, scales, pad, x.shape)
    return (q, scales, pad), target - approx


# ---------------------------------------------------------------------------
# Compressed all-reduce (mean) over a process group.
# Wire format: int8 payloads + fp32 per-block scales.
# ---------------------------------------------------------------------------
def compressed_psum_mean(x: torch.Tensor, group: ProcessGroup,
                         block: int = 256) -> torch.Tensor:
    a = group.size()
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    pad_to = (-n) % (a * block)
    if pad_to:
        flat = F.pad(flat, (0, pad_to))
    per = flat.shape[0] // a
    chunks = flat.reshape(a, per)

    # 1) reduce-scatter in int8: quantize each destination chunk, all_to_all,
    #    dequantize, and sum the a received contributions.
    qs, scales, _ = quantize_blockwise(chunks, block)       # (a*nb, block)
    nb = qs.shape[0] // a
    qs_r = torch.empty_like(qs)
    sc_r = torch.empty_like(scales)
    dist.all_to_all_single(qs_r, qs, group=group)
    dist.all_to_all_single(sc_r, scales, group=group)
    own = torch.sum(qs_r.reshape(a, nb, block).to(torch.float32)
                    * sc_r.reshape(a, nb)[..., None], dim=0)
    own = _div(own, float(a))

    # 2) all-gather the reduced chunk, again in int8.
    q2, s2, _ = quantize_blockwise(own, block)
    q2_g = torch.empty((a * nb, block), dtype=q2.dtype, device=q2.device)
    s2_g = torch.empty((a * nb,), dtype=s2.dtype, device=s2.device)
    dist.all_gather_into_tensor(q2_g, q2, group=group)
    dist.all_gather_into_tensor(s2_g, s2, group=group)
    full = (q2_g.to(torch.float32) * s2_g[:, None]).reshape(-1)
    if pad_to:
        full = full[:-pad_to]
    return full.reshape(x.shape).to(x.dtype)


def wire_bytes_fp32(num_elements: int, axis_size: int) -> int:
    """Bytes on the wire for a ring fp32 all-reduce (2(A-1)/A * N * 4)."""
    return int(2 * (axis_size - 1) / axis_size * num_elements * 4)


def wire_bytes_compressed(num_elements: int, axis_size: int,
                          block: int = 256) -> int:
    payload = num_elements  # int8
    scales = (num_elements // block) * 4
    return int(2 * (axis_size - 1) / axis_size * (payload + scales))
