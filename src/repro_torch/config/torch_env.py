"""Device selection for the port's entry points.

Entry points default to ``device="cuda"``. A CUDA device that is not there
is an error, never a silent move to the CPU: the CPU runs the plain
PyTorch versions of the kernels, and only a caller that asks for it
(``device="cpu"``, as the tests do) gets them.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
