"""Arch configs of the port (importing this package registers them)."""
from repro_torch.configs import (  # noqa: F401
    granite_moe_1b_a400m,
    internlm2_1p8b,
    jamba_1p5_large_398b,
    llama4_maverick_400b_a17b,
    mamba2_130m,
    qwen2_72b,
)

PORTED_ARCHS = (
    "granite-moe-1b-a400m",
    "internlm2-1.8b",
    "jamba-1.5-large-398b",
    "llama4-maverick-400b-a17b",
    "mamba2-130m",
    "qwen2-72b",
)
