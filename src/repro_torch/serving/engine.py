"""Serving engine: prefill / decode with full-length caches.

Decode caches live at ``max_seq_len`` from the start; prefill writes the
first ``s`` positions and pads. Weight-only int8 serving is applied at load
time via ``ServeConfig.quantize_weights`` and dequantized on use, as in the
JAX package's ``serving/engine.py`` (no int8 matmul kernel on this path).

Where the JAX engine donates the caches to its jitted decode, this engine
updates them in place (see ``models/attention.py``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.config.base import ModelConfig, ServeConfig
from repro_torch.config.torch_env import resolve_device
from repro_torch.kernels.ref import quantize_int8
from repro_torch.models import model as lm
from repro_torch.tree import tree_map

Params = Any


def _is_q(leaf: Any) -> bool:
    return isinstance(leaf, dict) and "__int8__" in leaf


def quantize_params_int8(params: Params) -> Params:
    """Weight-only int8: store int8 payload + per-output-channel scales,
    dequantized on use. Every leaf of two or more dims is quantized (the
    embedding, attention and MLP weights, the MoE router and the 3-D
    expert weights, per (expert, column) as the JAX engine's stacked 4-D
    leaves are, Mamba's ``w_in``, ``conv_w`` and ``w_out``); 1-D leaves
    (norm scales, ``conv_b``, the fp32 ``A_log``, ``dt_bias`` and ``D``)
    stay as they are. The JAX engine applies the
    same rule to its layer-stacked tree, where those 1-D leaves are 2-D
    and so are quantized across the layer axis; the port's per-layer tree
    keeps them exact."""
    def q(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.dim() >= 2 and \
                leaf.dtype in (torch.bfloat16, torch.float32):
            qv, s = quantize_int8(leaf, axis=-2)  # per-column of last dim
            return {"__int8__": qv, "scale": s}
        return leaf
    return tree_map(q, params)


def dequantize_params(params: Params) -> Params:
    def dq(leaf):
        if _is_q(leaf):
            return (leaf["__int8__"].float()
                    * leaf["scale"][..., None, :]).to(torch.bfloat16)
        return leaf
    return tree_map(dq, params, is_leaf=_is_q)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, scfg: Optional[ServeConfig] = None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.scfg = scfg or ServeConfig()
        self.device = resolve_device(device)
        self.params: Optional[Params] = None

    def _weights(self, params: Params) -> Params:
        if self.scfg.quantize_weights:
            return dequantize_params(params)
        return params

    @torch.no_grad()
    def prefill_fn(self, params: Params, batch: Dict[str, Any]):
        return lm.prefill(self._weights(params), self.cfg, batch,
                          max_len=self.scfg.max_seq_len)

    @torch.no_grad()
    def decode_fn(self, params: Params, tokens: torch.Tensor, caches, pos):
        return lm.decode_step(self._weights(params), self.cfg, tokens,
                              caches, pos)

    # ------------------------------------------------------------------
    def load(self, params: Params) -> None:
        if self.scfg.quantize_weights:
            params = quantize_params_int8(params)
        self.params = params

    def init_random(self, seed: int = 0) -> None:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.load(lm.init_params(self.cfg, gen, self.device))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate(self, tokens: torch.Tensor, max_new_tokens: int,
                 vision_embeds: Optional[torch.Tensor] = None,
                 greedy: bool = True,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """tokens: (b, s) -> (b, max_new_tokens) generated ids. Sampling
        (``greedy=False``) draws from ``generator``, which must be given."""
        if self.params is None:
            raise RuntimeError("call load()/init_random() first")
        if not greedy and generator is None:
            raise ValueError("sampling needs an explicit torch.Generator")
        tokens = tokens.to(self.device)
        b, s = tokens.shape
        batch: Dict[str, Any] = {"tokens": tokens}
        if vision_embeds is not None:
            batch["vision_embeds"] = vision_embeds.to(self.device)
            s = s + vision_embeds.shape[1]
        logits, caches = self.prefill_fn(self.params, batch)
        out = []
        pos = s
        for _ in range(max_new_tokens):
            if greedy:
                nxt = torch.argmax(logits, dim=-1)
            else:
                probs = torch.softmax(logits.float(), dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            out.append(nxt)
            logits, caches = self.decode_fn(self.params, nxt[:, None],
                                            caches, pos)
            pos += 1
        return torch.stack(out, dim=1)
