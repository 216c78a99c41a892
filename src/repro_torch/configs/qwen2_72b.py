"""qwen2-72b [dense]: 80L d=8192 64H (GQA kv=8) d_ff=29568 vocab=152064;
GQA with QKV bias. [arXiv:2407.10671; hf]
"""
from repro_torch.config.base import ModelConfig, register


@register("qwen2-72b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=29568,
        vocab_size=152064,
        head_dim=128,
        qkv_bias=True,
        rope_theta=1000000.0,
        source="arXiv:2407.10671 / hf:Qwen/Qwen2-72B",
    )
