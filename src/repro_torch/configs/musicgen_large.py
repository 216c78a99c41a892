"""musicgen-large [audio]: 48L d=2048 32H (kv=32 => MHA) d_ff=8192
vocab=2048; decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

Backbone only per spec: the EnCodec frontend is a STUB — input_specs()
provides precomputed frame embeddings / token ids in the 2048-entry codebook
vocabulary.
"""
from repro_torch.config.base import ModelConfig, register


@register("musicgen-large")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        head_dim=64,
        frontend_tokens=0,      # tokens come pre-quantized (EnCodec stub)
        source="arXiv:2306.05284 / hf:facebook/musicgen-large",
    )
