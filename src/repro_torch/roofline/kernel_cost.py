"""Bytes and operations of one call of each hand-written kernel, from its
shapes: one source for the bound column of the kernel table
(``chip_smoke.py``'s kernel cases) and for the dry run, which counts a
traced kernel call as one op with these numbers (each wrapper's fake path,
``record``).

Each function gives a :class:`Cost`: the bytes the call must move (each
input read once, each output written once), the arithmetic operations it
does (2 a multiply-add), and the dtype whose peak rate bounds them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Cost(NamedTuple):
    bytes: float
    ops: float
    dtype: torch.dtype


def rmsnorm(rows: int, d: int, e: int) -> Cost:
    """Read x, write the output, read w; square, sum, scale and weight in
    fp32 on the CUDA cores."""
    return Cost(2 * rows * d * e + 4 * d, 4 * rows * d, torch.float32)


def rmsnorm_bwd(rows: int, d: int, e: int) -> Cost:
    """Read x, dy and w, write dx and dw."""
    return Cost(3 * rows * d * e + 8 * d, 8 * rows * d, torch.float32)


def causal_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs a call scores: key j visible from query i where
    j <= i when causal (``ref.attention_ref``'s mask), every pair else."""
    if not causal:
        return sq * skv
    m = min(sq, skv)
    return m * (m + 1) // 2 + (sq - m) * skv


def flash(b: int, sq: int, skv: int, hq: int, hkv: int, d: int,
          dtype: torch.dtype, causal: bool = True, lse: bool = False
          ) -> Cost:
    """Read q, k, v, write the output (and the fp32 log-sum-exp under
    grad); QK^T and PV over the scored pairs."""
    e = torch.empty((), dtype=dtype).element_size()
    nbytes = e * (2 * b * sq * hq * d + 2 * b * skv * hkv * d) + \
        (4 * b * hq * sq if lse else 0)
    return Cost(nbytes, 4 * b * hq * d * causal_pairs(sq, skv, causal),
                dtype)


def flash_bwd(b: int, sq: int, skv: int, hq: int, hkv: int, d: int,
              dtype: torch.dtype, causal: bool = True) -> Cost:
    """Read q, k, v, out, dout and the log-sum-exp once, write dq, dk,
    dv; the five products of the backward (S recomputed, dP, dV, dK, dQ)
    over the scored pairs: 2.5x the forward's."""
    e = torch.empty((), dtype=dtype).element_size()
    nbytes = e * (3 * b * sq * hq * d + 2 * b * skv * hkv * d) + \
        4 * b * hq * sq + e * (b * sq * hq * d + 2 * b * skv * hkv * d)
    return Cost(nbytes, 10 * b * hq * d * causal_pairs(sq, skv, causal),
                dtype)


def decode(b: int, hq: int, hkv: int, d: int, rows: int,
           dtype: torch.dtype, lse: bool = False) -> Cost:
    """One query token a slot against ``rows`` valid cache rows in all
    (the sum of the slots' lengths): read q, those rows of k and v, the
    lengths, write the output (and the fp32 log-sum-exp in partial
    mode)."""
    e = torch.empty((), dtype=dtype).element_size()
    nbytes = e * (2 * b * hq * d + 2 * rows * hkv * d) + 4 * b + \
        (4 * b * hq if lse else 0)
    return Cost(nbytes, 4 * rows * hq * d, dtype)


def _ssd_chunks(s: int, chunk: int) -> tuple[int, int, int]:
    q = min(chunk, s)
    return q, s // q, q * (q + 1) // 2


def ssd(b: int, s: int, h: int, p: int, n: int, dtype: torch.dtype,
        chunk: int) -> Cost:
    """Work of the chunked algorithm at the model's chunk, causal pairs
    only: C.B^T once per batch and chunk (shared by the heads), then per
    head M.(dt x), the read of the carried state and its update. Read x,
    dt, A, B, C, D, write y and the fp32 final state."""
    e = torch.empty((), dtype=dtype).element_size()
    q, nc, pairs = _ssd_chunks(s, chunk)
    nops = b * nc * (2 * n * pairs + h * (2 * p * pairs + 4 * q * n * p))
    nbytes = (e * (2 * b * s * h * p + 2 * b * s * n) + 4 * b * s * h
              + 8 * h + 4 * b * h * p * n)
    return Cost(nbytes, nops, dtype)


def ssd_bwd(b: int, s: int, h: int, p: int, n: int, dtype: torch.dtype,
            chunk: int, with_state: bool) -> Cost:
    """Read x, dy, dt, B, C (and dstate) once, write dx, ddt, dB, dC. Work
    of the chunked backward at the model's chunk: C.B^T once per batch and
    chunk; per head and chunk P = dy u^T and the products of du, dB and
    dC over the causal pairs. The state terms are counted only where the
    function needs them: at each of the nc - 1 boundaries between chunks
    the state leaving one, H dy and the state's gradient dH in the next,
    and dS^T B and dS u in the one before (10 q n p a head); with dstate,
    dS^T B and dS u in the last chunk as well (4 q n p). With one chunk
    and no dstate the state entering it and dS are zero: none."""
    e = torch.empty((), dtype=dtype).element_size()
    q, nc, pairs = _ssd_chunks(s, chunk)
    state = 10 * (nc - 1) * q * n * p + (4 * q * n * p if with_state else 0)
    nops = b * (nc * 2 * n * pairs
                + h * (nc * 4 * (p + n) * pairs + state))
    nbytes = (e * (3 * b * s * h * p + 4 * b * s * n) + 8 * b * s * h
              + 16 * h + (4 * b * h * p * n if with_state else 0))
    return Cost(nbytes, nops, dtype)


def int8_matmul(m: int, k: int, n: int, out_dtype: torch.dtype) -> Cost:
    """Read x_q, w_q and both scales, write the output."""
    e = torch.empty((), dtype=out_dtype).element_size()
    return Cost(m * k + k * n + 4 * (m + n) + m * n * e, 2 * m * k * n,
                torch.int8)
