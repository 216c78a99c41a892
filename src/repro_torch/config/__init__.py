from repro_torch.config.base import (
    ATTN, MAMBA,
    MambaConfig, ModelConfig, MoEConfig, ServeConfig, ShapeSpec,
    TrainConfig, get_config, list_configs, register, smoke_config,
)
from repro_torch.config.torch_env import resolve_device

__all__ = [
    "ATTN", "MAMBA", "MambaConfig", "ModelConfig", "MoEConfig",
    "ServeConfig", "ShapeSpec", "TrainConfig", "get_config", "list_configs",
    "register", "resolve_device", "smoke_config",
]
