"""Arch configs of the port (importing this package registers them)."""
from repro_torch.configs import (  # noqa: F401
    internlm2_1p8b,
    mamba2_130m,
    qwen2_72b,
)

PORTED_ARCHS = (
    "internlm2-1.8b",
    "mamba2-130m",
    "qwen2-72b",
)
