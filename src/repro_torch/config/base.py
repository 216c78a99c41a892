"""Config system of the PyTorch port.

An own copy of ``ModelConfig``, ``MoEConfig``, ``MambaConfig``,
``ShapeSpec`` with the assigned shapes and ``shape_applicable``,
``TrainConfig``, ``ServeConfig``, the arch registry and
``smoke_config`` from the JAX
package's ``config/base.py``: plain dataclasses, no external deps. Field
names, defaults and the smoke reduction are kept identical so that a
config of either package describes the same model
(``tests/test_torch_hygiene.py`` holds the copies equal).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Layer kinds for hybrid stacks.
# ---------------------------------------------------------------------------
ATTN = "attn"
MAMBA = "mamba"


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings for a (subset of) layers."""

    num_experts: int
    top_k: int
    d_ff_expert: int                    # per-expert hidden width
    # Every `period`-th layer (offset `offset`) is MoE; others use dense FFN.
    period: int = 1
    offset: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    # dispatch variant: "v1" (padded buffer + extra overflow row) or
    # "v2" (drop-mode scatter into an expert-flat buffer that shards
    # cleanly over the model axis — the EP-collective hillclimb lever)
    dispatch: str = "v1"

    def is_moe_layer(self, layer_idx: int) -> bool:
        return layer_idx % self.period == self.offset


@dataclass(frozen=True)
class MambaConfig:
    """Mamba-2 (SSD) mixer settings."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclass(frozen=True)
class ModelConfig:
    """A decoder-style LM backbone configuration.

    Covers dense / MoE / SSM / hybrid / modality-stub families with one
    schema. ``layer_pattern`` expands to a per-layer kind list for hybrids.
    """

    name: str
    family: str                         # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                      # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int                           # dense FFN hidden (0 if no dense FFN)
    vocab_size: int
    head_dim: int = 0                   # 0 => d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_seq_len: int = 1 << 20
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    # 'attn'/'mamba' pattern; None => all-attn (or all-mamba for family=ssm).
    layer_pattern: Optional[Tuple[str, ...]] = None
    # attention implementation on the XLA (non-Pallas) path:
    # "ref" (materialized scores) | "chunked" (online-softmax q-chunks,
    # native-dtype dots — flash-attention access pattern in pure jnp)
    attn_impl: str = "ref"
    attn_chunk: int = 512
    # compute activation nonlinearities in the storage dtype (bf16) instead
    # of upcasting to fp32 (halves elementwise HBM traffic in the FFN)
    mlp_lowp: bool = False
    # Modality frontend stub: number of prepended embedding positions the
    # frontend contributes (patch/frame embeddings come precomputed via
    # input_specs()).
    frontend_tokens: int = 0
    frontend_dim: int = 0               # dim of precomputed frontend embeds
    dtype: str = "bfloat16"
    # Notes carried into DESIGN/EXPERIMENTS.
    source: str = ""

    # ----- derived -----
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    def layer_kinds(self) -> Tuple[str, ...]:
        if self.layer_pattern is not None:
            assert len(self.layer_pattern) == self.num_layers
            return self.layer_pattern
        if self.family == "ssm":
            return tuple([MAMBA] * self.num_layers)
        return tuple([ATTN] * self.num_layers)

    def is_moe_layer(self, layer_idx: int) -> bool:
        return self.moe is not None and self.moe.is_moe_layer(layer_idx)

    @property
    def uses_attention(self) -> bool:
        return any(k == ATTN for k in self.layer_kinds())

    @property
    def uses_mamba(self) -> bool:
        return any(k == MAMBA for k in self.layer_kinds())

    @property
    def subquadratic(self) -> bool:
        """True if the arch can run 500k-context decode per the spec
        (SSM/hybrid/linear-attention)."""
        return self.family in ("ssm", "hybrid")

    # ----- parameter counting (analytic; used for roofline MODEL_FLOPS) ----
    def param_counts(self) -> Dict[str, float]:
        d, hd = self.d_model, self.resolved_head_dim
        counts: Dict[str, float] = {}
        counts["embed"] = self.vocab_size * d
        counts["unembed"] = 0 if self.tie_embeddings else self.vocab_size * d
        attn_p = d * (self.num_heads * hd) * 2  # Wq + Wo
        attn_p += d * (self.num_kv_heads * hd) * 2  # Wk + Wv
        if self.qkv_bias:
            attn_p += (self.num_heads + 2 * self.num_kv_heads) * hd
        dense_ffn_p = 3 * d * self.d_ff  # SwiGLU: gate, up, down
        mamba_p = 0.0
        if self.mamba is not None:
            di = self.mamba.d_inner(d)
            nh = self.mamba.n_heads(d)
            # in_proj -> (z, x, B, C, dt): 2*di + 2*d_state*? (heads share B,C
            # in SSD: B,C are (n_groups=1, d_state)); out_proj di->d.
            mamba_p = d * (2 * di + 2 * self.mamba.d_state + nh) + di * d
            mamba_p += di * self.mamba.d_conv + di  # conv + skip D
        total = counts["embed"] + counts["unembed"]
        active = total
        per_layer_total, per_layer_active = 0.0, 0.0
        for i, kind in enumerate(self.layer_kinds()):
            lt, la = 0.0, 0.0
            if kind == ATTN:
                lt += attn_p
                la += attn_p
            else:
                lt += mamba_p
                la += mamba_p
            if self.is_moe_layer(i):
                assert self.moe is not None
                e_p = 3 * d * self.moe.d_ff_expert
                lt += self.moe.num_experts * e_p + d * self.moe.num_experts
                la += self.moe.top_k * e_p + d * self.moe.num_experts
            elif self.d_ff:
                lt += dense_ffn_p
                la += dense_ffn_p
            lt += 2 * d  # norms
            la += 2 * d
            per_layer_total += lt
            per_layer_active += la
        counts["layers_total"] = per_layer_total
        counts["layers_active"] = per_layer_active
        counts["total"] = total + per_layer_total
        counts["active"] = active + per_layer_active
        return counts

    @property
    def num_params(self) -> float:
        return self.param_counts()["total"]

    @property
    def num_active_params(self) -> float:
        return self.param_counts()["active"]

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Shapes (assigned input-shape set).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES: Dict[str, ShapeSpec] = {s.name: s for s in ALL_SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Per-spec applicability: (sanctioned, note).

    long_500k is sanctioned only for sub-quadratic archs; for pure
    full-attention archs we may still compile it as a *bonus* cell.
    """
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("spec-sanctioned skip: pure full-attention arch; "
                       "compiled as bonus cell (decode attention is O(S))")
    return True, ""


# ---------------------------------------------------------------------------
# Training config.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    # remat: "none" | "full" | "dots" (checkpoint_dots policy)
    remat: str = "full"
    scan_layers: bool = True
    # optimizer state compression: "fp32" | "int8"
    opt_state_dtype: str = "fp32"
    # gradient compression on the DP all-reduce: "none" | "int8"
    grad_compression: str = "none"
    microbatches: int = 1               # grad accumulation
    # chunked cross-entropy: sequence-chunk size (0 = full logits)
    loss_chunk: int = 0
    seed: int = 0


# ---------------------------------------------------------------------------
# Serving config.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 128
    quantize_weights: bool = False       # int8 weight-only serving path
    kv_cache_dtype: str = "bfloat16"
    serve_fsdp: bool = False             # shard serve weights over data too
    max_seq_len: int = 32768


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str) -> Callable[[Callable[[], ModelConfig]], Callable[[], ModelConfig]]:
    def deco(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers registration)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs() -> List[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Reduced ("smoke") configs: same family, tiny dims, CPU-runnable.
# ---------------------------------------------------------------------------
def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config to a CPU-runnable variant of the same family."""
    n_layers = min(cfg.num_layers, 4)
    d_model = 64
    n_heads = 4
    n_kv = max(1, min(cfg.num_kv_heads, 2)) if cfg.num_heads else 0
    if cfg.num_heads and cfg.num_kv_heads == cfg.num_heads:
        n_kv = n_heads  # preserve MHA-ness (musicgen)
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(
            num_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=32,
            period=cfg.moe.period, offset=cfg.moe.offset,
            capacity_factor=cfg.moe.capacity_factor,
        )
    mamba = None
    if cfg.mamba is not None:
        mamba = MambaConfig(d_state=16, d_conv=4, expand=2, headdim=16,
                            chunk_size=32)
    pattern = None
    if cfg.layer_pattern is not None:
        # Preserve the interleave flavor within the reduced depth.
        kinds = cfg.layer_kinds()
        # Keep at least one of each kind present in the original.
        pattern = tuple(kinds[i % len(kinds)] for i in range(n_layers))
        if MAMBA in kinds and MAMBA not in pattern:
            pattern = (MAMBA, *pattern[1:])
        if ATTN in kinds and ATTN not in pattern:
            pattern = (*pattern[:-1], ATTN)
    return cfg.replace(
        num_layers=n_layers, d_model=d_model, num_heads=n_heads if cfg.num_heads else 0,
        num_kv_heads=n_kv, d_ff=128 if cfg.d_ff else 0, vocab_size=512,
        head_dim=16 if cfg.num_heads else 0, moe=moe, mamba=mamba,
        layer_pattern=pattern, frontend_tokens=min(cfg.frontend_tokens, 8),
        frontend_dim=d_model if cfg.frontend_dim else 0,
        max_seq_len=4096,
    )
