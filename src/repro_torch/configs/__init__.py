"""Arch configs of the port (importing this package registers them): each
an own copy of the JAX package's ``src/repro/configs/<name>.py``, all
eleven of them."""
from repro_torch.configs import (  # noqa: F401
    bert_base,
    granite_moe_1b_a400m,
    internlm2_1p8b,
    internvl2_1b,
    jamba_1p5_large_398b,
    llama4_maverick_400b_a17b,
    mamba2_130m,
    musicgen_large,
    phi3_medium_14b,
    qwen2_72b,
    stablelm_12b,
)

PORTED_ARCHS = (
    "bert-base",
    "granite-moe-1b-a400m",
    "internlm2-1.8b",
    "internvl2-1b",
    "jamba-1.5-large-398b",
    "llama4-maverick-400b-a17b",
    "mamba2-130m",
    "musicgen-large",
    "phi3-medium-14b",
    "qwen2-72b",
    "stablelm-12b",
)
