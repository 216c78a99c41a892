"""bert-base (the paper's own DL-serving workload, §3/§5): 12L d=768 12H
(MHA) d_ff=3072 vocab=30522; encoder-only.
[arXiv:1810.04805; hf:tfhub bert_en_uncased_L-12_H-768_A-12]

Encoder-only => no decode shapes; used by the paper-reproduction benchmark
suite (Fig 11/12, Table 5), not by the 40-cell dry-run table.
"""
from repro_torch.config.base import ModelConfig, register


@register("bert-base")
def config() -> ModelConfig:
    return ModelConfig(
        name="bert-base",
        family="dense",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=30522,
        head_dim=64,
        source="arXiv:1810.04805 (paper workload, encoder-only)",
    )
