"""internlm2-1.8b [dense]: 24L d=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
[arXiv:2403.17297; hf]
"""
from repro_torch.config.base import ModelConfig, register


@register("internlm2-1.8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b",
        family="dense",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=92544,
        head_dim=128,
        source="arXiv:2403.17297 / hf:internlm/internlm2-1_8b",
    )
