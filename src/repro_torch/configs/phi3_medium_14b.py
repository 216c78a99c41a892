"""phi3-medium-14b [dense]: 40L d=5120 40H (GQA kv=10) d_ff=17920
vocab=100352; RoPE SwiGLU GQA. [arXiv:2404.14219; unverified]
"""
from repro_torch.config.base import ModelConfig, register


@register("phi3-medium-14b")
def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=10,
        d_ff=17920,
        vocab_size=100352,
        head_dim=128,
        source="arXiv:2404.14219",
    )
