"""Convert the JAX package's parameter pytree into the port's parameters.

``from_jax_params`` takes what ``jax.tree.map(np.asarray, params)`` gives
for the JAX package's ``init_params``: nested dicts and lists of numpy
arrays. Its ``blocks`` entry is a list of per-position dicts, each leaf
stacked over ``num_layers // period`` repeats
(``src/repro/models/transformer.py:131-142``); layer ``i`` is repeat
``i // period`` of position ``i % period``. The port keeps one dict per
layer under ``layers``.

JAX's bf16 arrays arrive as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses; their bits are taken through an int16 view.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.tree import tree_map


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy that torch may share
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def from_jax_params(tree: Dict[str, Any], cfg: ModelConfig,
                    device: torch.device | str) -> Dict[str, Any]:
    device = torch.device(device)
    blocks = tree["blocks"]
    period = len(blocks)
    if cfg.num_layers % period:
        raise ValueError(f"{len(blocks)} block positions do not divide "
                         f"{cfg.num_layers} layers")
    layers = [tree_map(lambda a, r=i // period:
                       _tensor(np.asarray(a)[r], device), blocks[i % period])
              for i in range(cfg.num_layers)]
    to_t = lambda a: _tensor(a, device)
    return {"embed": tree_map(to_t, tree["embed"]), "layers": layers,
            "final_norm": tree_map(to_t, tree["final_norm"])}
