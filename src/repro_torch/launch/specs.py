"""Per-arch training policy, as the JAX package's ``launch/specs.py``
chooses it (its input specs and sharding resolution wait for the
distributed slice)."""
from __future__ import annotations

from repro_torch.config import ModelConfig, TrainConfig


def default_train_config(cfg: ModelConfig) -> TrainConfig:
    """Per-arch training policy: bigger models get full remat, gradient
    accumulation, and int8 Adam moments (the state-compression trick that
    lets the 398B/778B configs approach 16 GB/chip HBM)."""
    n = cfg.num_params
    big = n > 30e9
    if n > 100e9:
        mb = 16
    elif n > 3e9:
        mb = 8
    else:
        mb = 1
    return TrainConfig(
        # 4k-seq training materializes O(s^2) attention scores on the
        # reference path — remat pays for itself from ~0.1B up.
        remat="full" if n > 0.1e9 else "none",
        scan_layers=True,
        opt_state_dtype="int8" if big else "fp32",
        microbatches=mb,
    )
