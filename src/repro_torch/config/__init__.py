from repro_torch.config.base import (
    ATTN, MAMBA,
    ALL_SHAPES, SHAPES,
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
    MambaConfig, ModelConfig, MoEConfig, ServeConfig, ShapeSpec,
    TrainConfig, get_config, list_configs, register, shape_applicable,
    smoke_config,
)
from repro_torch.config.torch_env import resolve_device

__all__ = [
    "ATTN", "MAMBA", "ALL_SHAPES", "SHAPES",
    "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
    "MambaConfig", "ModelConfig", "MoEConfig",
    "ServeConfig", "ShapeSpec", "TrainConfig", "get_config", "list_configs",
    "register", "resolve_device", "shape_applicable", "smoke_config",
]
