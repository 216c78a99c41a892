"""stablelm-12b [dense]: 40L d=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
[hf:stabilityai/stablelm-2-1_6b; hf]
"""
from repro_torch.config.base import ModelConfig, register


@register("stablelm-12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        d_ff=13824,
        vocab_size=100352,
        head_dim=160,
        source="hf:stabilityai/stablelm-2-12b",
    )
