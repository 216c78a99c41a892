"""YOLOv5x-style detector backbone and head of the port: the JAX package's
``models/yolo.py`` (paper workload, §3) in PyTorch.

CSP bottleneck blocks and SPPF at YOLOv5x's widths and depths (w = 1.25,
d = 1.33); no NMS, as in the reference, which measures the network's
forward pass. Plain functions on a dict laid out as the JAX pytree
(``stem``, ``stages[i]`` with ``down`` and ``c3`` (``cv1``, ``cv2``,
``cv3``, ``m[j]`` with ``cv1``, ``cv2``), ``sppf``, ``head``), each conv a
``{"w", "b"}`` with ``w`` OIHW (stored ``channels_last``), where the JAX
package's is HWIO. Every conv but the head's is followed by SiLU; "SAME"
padding as XLA pads (``models/conv.py``); fp32.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.config.torch_env import resolve_device
from repro_torch.models.conv import conv2d_same, max_pool2d_same

Params = Dict[str, Any]


def _conv_init(gen, k, cin, cout, device):
    scale = (2.0 / (k * k * cin)) ** 0.5
    w = torch.randn((cout, cin, k, k), generator=gen, device=device) * scale
    return {"w": w.contiguous(memory_format=torch.channels_last),
            "b": torch.zeros(cout, device=device)}


def _conv(x, p, stride=1):
    return F.silu(conv2d_same(x, p["w"], stride, bias=p["b"]))


def _c3_init(gen, cin, cout, n, device):
    cmid = cout // 2
    return {
        "cv1": _conv_init(gen, 1, cin, cmid, device),
        "cv2": _conv_init(gen, 1, cin, cmid, device),
        "cv3": _conv_init(gen, 1, 2 * cmid, cout, device),
        "m": [{"cv1": _conv_init(gen, 1, cmid, cmid, device),
               "cv2": _conv_init(gen, 3, cmid, cmid, device)}
              for _ in range(n)],
    }


def _c3(x, p):
    a = _conv(x, p["cv1"])
    for m in p["m"]:
        a = a + _conv(_conv(a, m["cv1"]), m["cv2"])
    b = _conv(x, p["cv2"])
    return _conv(torch.cat([a, b], dim=1), p["cv3"])


def _sppf_init(gen, c, device):
    return {"cv1": _conv_init(gen, 1, c, c // 2, device),
            "cv2": _conv_init(gen, 1, c * 2, c, device)}


def _sppf(x, p):
    h = _conv(x, p["cv1"])
    pools = [h]
    for _ in range(3):
        pools.append(max_pool2d_same(pools[-1], 5, 1))
    return _conv(torch.cat(pools, dim=1), p["cv2"])


# YOLOv5x widths/depths.
_WIDTHS = [80, 160, 320, 640, 1280]
_DEPTHS = [4, 8, 12, 4]


def yolo_init(gen: torch.Generator, num_outputs: int = 255,
              device: str | torch.device = "cuda") -> Params:
    """Random weights at the reference's scales (convs normal at
    ``sqrt(2 / fan_in)``, biases 0), drawn from ``gen``, which must live
    on ``device``."""
    device = resolve_device(device)
    p: Params = {"stem": _conv_init(gen, 6, 3, _WIDTHS[0], device)}
    p["stages"] = [{
        "down": _conv_init(gen, 3, _WIDTHS[i], _WIDTHS[i + 1], device),
        "c3": _c3_init(gen, _WIDTHS[i + 1], _WIDTHS[i + 1], _DEPTHS[i],
                       device),
    } for i in range(4)]
    p["sppf"] = _sppf_init(gen, _WIDTHS[4], device)
    p["head"] = _conv_init(gen, 1, _WIDTHS[4], num_outputs, device)
    return p


def yolo_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (b, 640, 640, 3) -> (b, 20, 20, 255) coarse head, NHWC."""
    h = _conv(x.permute(0, 3, 1, 2), params["stem"], 2)
    for st in params["stages"]:
        h = _conv(h, st["down"], 2)
        h = _c3(h, st["c3"])
    h = _sppf(h, params["sppf"])
    h = conv2d_same(h, params["head"]["w"], bias=params["head"]["b"])
    return h.permute(0, 2, 3, 1)
