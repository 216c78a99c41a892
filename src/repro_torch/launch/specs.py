"""Meta-tensor input stand-ins + sharding resolution for every
(arch x shape x step-kind) cell. No device allocation happens here: a
stand-in is a tensor on the ``meta`` device (the counterpart of JAX's
``ShapeDtypeStruct``), and a sharding is the ``(mesh, placements)`` pair
of ``distributed.sharding``.

The port keeps one parameter, optimizer and cache tree a layer where the
JAX package stacks each block position (``models/transformer.py``); each
sharding here is of the port's layout."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.config import (ModelConfig, ServeConfig, ShapeSpec,
                                TrainConfig)
from repro_torch.distributed.sharding import (Mesh, RuleSet,
                                              tree_shardings)
from repro_torch.models import model as lm
from repro_torch.training.optimizer import init_opt_state, opt_state_specs

META = torch.device("meta")
Params = Any

BATCH_LOGICAL = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "mask": ("batch", "seq"),
    "vision_embeds": ("batch", "seq", "embed_act"),
}


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


def default_serve_config(cfg: ModelConfig, shape: ShapeSpec) -> ServeConfig:
    return ServeConfig(
        max_batch=shape.global_batch,
        serve_fsdp=cfg.num_params > 30e9,
        max_seq_len=shape.seq_len,
    )


# ---------------------------------------------------------------------------
# Batch stand-ins.
# ---------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec
                      ) -> Dict[str, torch.Tensor]:
    ft = cfg.frontend_tokens
    b, s = shape.global_batch, shape.seq_len - ft
    batch = {
        "tokens": _meta((b, s), torch.int32),
        "labels": _meta((b, s), torch.int32),
        "mask": _meta((b, s), torch.float32),
    }
    if ft:
        batch["vision_embeds"] = _meta(
            (b, ft, cfg.frontend_dim or cfg.d_model), torch.float32)
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeSpec
                        ) -> Dict[str, torch.Tensor]:
    ft = cfg.frontend_tokens
    b, s = shape.global_batch, shape.seq_len - ft
    batch = {"tokens": _meta((b, s), torch.int32)}
    if ft:
        batch["vision_embeds"] = _meta(
            (b, ft, cfg.frontend_dim or cfg.d_model), torch.float32)
    return batch


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec,
                       cache_dtype=None
                       ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """(tokens, caches, pos) stand-ins for one serve_step: a single new
    token against a seq_len-deep cache."""
    b = shape.global_batch
    caches = lm.init_caches(cfg, b, shape.seq_len, META, cache_dtype)
    return _meta((b, 1), torch.int32), caches, _meta((), torch.int32)


# ---------------------------------------------------------------------------
# Sharding resolution over stand-in trees.
# ---------------------------------------------------------------------------
def params_shardings(cfg: ModelConfig, mesh: Mesh, rules: RuleSet):
    return tree_shardings(lm.param_shapes(cfg), lm.param_specs(cfg), mesh,
                          rules)


def opt_shardings(cfg: ModelConfig, tcfg: TrainConfig, mesh: Mesh,
                  rules: RuleSet):
    """(shardings, stand-ins) of the optimizer state."""
    opt_meta = init_opt_state(lm.param_shapes(cfg), tcfg)
    specs = opt_state_specs(lm.param_specs(cfg), tcfg)
    return tree_shardings(opt_meta, specs, mesh, rules), opt_meta


def batch_shardings(batch_meta, mesh: Mesh, rules: RuleSet):
    return tree_shardings(batch_meta,
                          {k: BATCH_LOGICAL[k] for k in batch_meta},
                          mesh, rules)


def cache_shardings(cfg: ModelConfig, caches_meta, mesh: Mesh,
                    rules: RuleSet):
    return tree_shardings(caches_meta, lm.cache_specs(cfg), mesh, rules)
