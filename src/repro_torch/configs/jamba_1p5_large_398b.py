"""jamba-1.5-large-398b [hybrid]: 72L d=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2; Mamba+attn 1:7 interleave.
[arXiv:2403.19887; hf]

Layer pattern: blocks of 8 with attention at position 4 (1 attn : 7 mamba,
per the Jamba paper); MoE every 2nd layer (period=2 reproduces the 398B
headline — derivation in DESIGN.md §6).
"""
from repro_torch.config.base import ATTN, MAMBA, MambaConfig, ModelConfig, MoEConfig, register


@register("jamba-1.5-large-398b")
def config() -> ModelConfig:
    pattern = []
    for i in range(72):
        pattern.append(ATTN if i % 8 == 4 else MAMBA)
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        head_dim=128,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576,
                      period=2, offset=1),
        mamba=MambaConfig(d_state=128, d_conv=4, expand=2, headdim=128),
        layer_pattern=tuple(pattern),
        source="arXiv:2403.19887 / hf:ai21labs/AI21-Jamba-1.5-Large",
    )
