"""llama4-maverick-400b-a17b [moe]: 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128 experts top-1; early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Implemented literally as assigned (every layer MoE, 128e top-1, no shared
expert); the resulting ~0.78T total parameters are recorded in DESIGN.md §6.
"""
from repro_torch.config.base import ModelConfig, MoEConfig, register


@register("llama4-maverick-400b-a17b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=0,
        vocab_size=202048,
        head_dim=128,
        moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192, period=1),
        rope_theta=500000.0,
        source="hf:meta-llama/Llama-4-Scout-17B-16E (shape-assigned variant)",
    )
