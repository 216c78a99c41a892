"""granite-moe-1b-a400m [moe]: 24L d=1024 16H (GQA kv=8) d_ff(expert)=512
vocab=49155, MoE 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.config.base import ModelConfig, MoEConfig, register


@register("granite-moe-1b-a400m")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        d_ff=0,  # every layer is MoE; no dense FFN
        vocab_size=49155,
        head_dim=64,
        moe=MoEConfig(num_experts=32, top_k=8, d_ff_expert=512, period=1),
        tie_embeddings=True,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )
