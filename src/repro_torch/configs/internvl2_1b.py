"""internvl2-1b [vlm]: 24L d=896 14H (GQA kv=2) d_ff=4864 vocab=151655;
InternViT + InternLM2/Qwen2-0.5B backbone. [arXiv:2404.16821; hf]

Backbone only per spec: the InternViT frontend is a STUB — input_specs()
provides precomputed patch embeddings (frontend_tokens positions of
frontend_dim) that are prepended to the token sequence.
"""
from repro_torch.config.base import ModelConfig, register


@register("internvl2-1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        d_ff=4864,
        vocab_size=151655,
        head_dim=64,
        qkv_bias=True,           # Qwen2-family backbone
        frontend_tokens=256,     # one ViT tile worth of patch embeddings
        frontend_dim=896,
        source="arXiv:2404.16821 / hf:OpenGVLab/InternVL2-1B",
    )
