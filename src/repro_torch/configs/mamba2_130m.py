"""mamba2-130m [ssm]: 24L d=768 attention-free, vocab=50280, ssm_state=128;
SSD (state-space duality). [arXiv:2405.21060; unverified]

Mamba-2 defaults: expand=2 => d_inner=1536, headdim=64 => 24 SSD heads,
d_conv=4.
"""
from repro_torch.config.base import MambaConfig, ModelConfig, register


@register("mamba2-130m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        num_layers=24,
        d_model=768,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        mamba=MambaConfig(d_state=128, d_conv=4, expand=2, headdim=64),
        tie_embeddings=True,
        source="arXiv:2405.21060 / hf:state-spaces/mamba2-130m",
    )
