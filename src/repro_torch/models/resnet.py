"""ResNet-50/152 of the port: the JAX package's ``models/resnet.py``, the
paper's primary DL-serving workload (§3, Fig. 11), in PyTorch.

Plain functions on a dict of tensors, laid out as the JAX pytree (``stem``,
``stem_bn``, ``stages[stage][block]`` with ``conv1..3``, ``bn1..3`` and, in
a block that changes shape, ``proj`` and ``bn_proj``; ``fc``), so that
``repro_torch.convert.from_jax_resnet_params`` maps one onto the other leaf
by leaf. Conv weights are OIHW (stored ``channels_last``), where the JAX
package's are HWIO. ``resnet_apply`` takes NHWC images, as the reference
does, and computes on their NCHW view, whose strides are ``channels_last``:
cuDNN's convolutions on the card, "SAME" padding as XLA pads
(``models/conv.py``), batch norm in the reference's inference form, fp32
throughout (the reference's only dtype).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config.torch_env import resolve_device
from repro_torch.models.conv import conv2d_same, max_pool2d_same

Params = Dict[str, Any]

RESNET_LAYOUT = {
    "resnet-50": (3, 4, 6, 3),
    "resnet-152": (3, 8, 36, 3),
}


def _conv_init(gen, kh, kw, cin, cout, device):
    scale = (2.0 / (kh * kw * cin)) ** 0.5
    w = torch.randn((cout, cin, kh, kw), generator=gen, device=device) * scale
    return w.contiguous(memory_format=torch.channels_last)


def _bn_init(c, device):
    return {"scale": torch.ones(c, device=device),
            "bias": torch.zeros(c, device=device),
            "mean": torch.zeros(c, device=device),
            "var": torch.ones(c, device=device)}


def _bn(x, p, eps=1e-5):
    inv = torch.rsqrt(p["var"] + eps) * p["scale"]
    return x * inv[:, None, None] + (p["bias"] - p["mean"] * inv)[:, None,
                                                                  None]


def _bottleneck_init(gen, cin, cmid, cout, stride, device):
    p = {
        "conv1": _conv_init(gen, 1, 1, cin, cmid, device),
        "bn1": _bn_init(cmid, device),
        "conv2": _conv_init(gen, 3, 3, cmid, cmid, device),
        "bn2": _bn_init(cmid, device),
        "conv3": _conv_init(gen, 1, 1, cmid, cout, device),
        "bn3": _bn_init(cout, device),
    }
    if stride != 1 or cin != cout:
        p["proj"] = _conv_init(gen, 1, 1, cin, cout, device)
        p["bn_proj"] = _bn_init(cout, device)
    return p


def _bottleneck(x, p, stride):
    h = torch.relu(_bn(conv2d_same(x, p["conv1"]), p["bn1"]))
    h = torch.relu(_bn(conv2d_same(h, p["conv2"], stride), p["bn2"]))
    h = _bn(conv2d_same(h, p["conv3"]), p["bn3"])
    if "proj" in p:
        x = _bn(conv2d_same(x, p["proj"], stride), p["bn_proj"])
    return torch.relu(x + h)


def resnet_init(gen: torch.Generator, variant: str = "resnet-50",
                num_classes: int = 1000,
                device: str | torch.device = "cuda") -> Params:
    """Random weights at the reference's scales, drawn from ``gen``, which
    must live on ``device``: convs normal at ``sqrt(2 / fan_in)``, ``fc``
    at 0.01, batch norm at scale 1, bias 0, mean 0, var 1."""
    device = resolve_device(device)
    blocks = RESNET_LAYOUT[variant]
    params: Params = {
        "stem": _conv_init(gen, 7, 7, 3, 64, device),
        "stem_bn": _bn_init(64, device),
        "stages": [],
    }
    cin = 64
    for stage, n in enumerate(blocks):
        cmid = 64 * (2 ** stage)
        cout = cmid * 4
        stage_p = []
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            stage_p.append(_bottleneck_init(gen, cin, cmid, cout, stride,
                                            device))
            cin = cout
        params["stages"].append(stage_p)
    params["fc"] = torch.randn((cin, num_classes), generator=gen,
                               device=device) * 0.01
    return params


def resnet_apply(params: Params, x: torch.Tensor,
                 variant: str = "resnet-50") -> torch.Tensor:
    """x: (b, 224, 224, 3) -> (b, classes), on the device of ``params``."""
    blocks = RESNET_LAYOUT[variant]
    h = x.permute(0, 3, 1, 2)       # NCHW shape, channels_last strides
    h = torch.relu(_bn(conv2d_same(h, params["stem"], 2), params["stem_bn"]))
    h = max_pool2d_same(h, 3, 2)
    for stage, n in enumerate(blocks):
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            h = _bottleneck(h, params["stages"][stage][b], stride)
    h = torch.mean(h, dim=(2, 3))
    return h @ params["fc"]


def resnet_flops(variant: str = "resnet-50", image: int = 224) -> float:
    """Analytic MACs x2 (published: ~4.1 GFLOPs R50, ~11.6 GFLOPs R152)."""
    return {"resnet-50": 4.1e9, "resnet-152": 11.6e9}[variant] * 2 / 2
