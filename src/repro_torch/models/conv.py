"""XLA's "SAME" padding for the vision models' convolutions and max pools
(``jax.lax.conv_general_dilated`` and ``jax.lax.reduce_window`` with
``"SAME"`` in the JAX package's ``models/resnet.py`` and ``models/yolo.py``).

Along each spatial axis XLA pads ``total = max((ceil(n / s) - 1) * s + k -
n, 0)``: ``lo = total // 2`` before and the rest after. Under stride 2
``total`` is often odd, and then the extra row and column go at the end,
where PyTorch's ``padding=k // 2`` pads both sides alike: the output shape
agrees and every window is shifted by one pixel. Symmetric pads go to the
op's own ``padding`` (no copy); asymmetric ones through ``F.pad`` first,
with ``-inf`` for a max pool, ``reduce_window``'s init value there.

Tensors are NCHW in shape; the models hand in NHWC storage
(``channels_last`` strides), which every op here keeps.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """(lo, hi) padding of one axis of size ``n``, window ``k``, stride
    ``s``, as XLA computes "SAME"."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, kh: int, kw: int, s: int):
    return same_pads(x.shape[2], kh, s), same_pads(x.shape[3], kw, s)


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (b, cin, h, w); w: (cout, cin, kh, kw)."""
    (ht, hb), (wl, wr) = _pads(x, w.shape[2], w.shape[3], stride)
    if ht == hb and wl == wr:
        return F.conv2d(x, w, bias, stride=stride, padding=(ht, wl))
    return F.conv2d(F.pad(x, (wl, wr, ht, hb)), w, bias, stride=stride)


def max_pool2d_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """A ``k`` x ``k`` max pool; padding counts as ``-inf``."""
    (ht, hb), (wl, wr) = _pads(x, k, k, stride)
    if ht == hb and wl == wr:       # the pool's own padding is -inf
        return F.max_pool2d(x, k, stride, padding=(ht, wl))
    return F.max_pool2d(F.pad(x, (wl, wr, ht, hb), value=float("-inf")),
                        k, stride)
