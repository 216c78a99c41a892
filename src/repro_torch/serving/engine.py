"""Serving engine: prefill / decode with full-length caches.

Decode caches live at ``max_seq_len`` from the start; prefill writes the
first ``s`` positions and pads. Weight-only int8 serving is applied at load
time via ``ServeConfig.quantize_weights`` and dequantized on use, as in the
JAX package's ``serving/engine.py`` (no int8 matmul kernel on this path).

Where the JAX engine donates the caches to its jitted decode, this engine
updates them in place (see ``models/attention.py``).

On a ``mesh`` (``ServingEngine(cfg, scfg, mesh, rules)``, rules default
``serve_rules(scfg.serve_fsdp)``), ``load`` lays the params out by
``launch/specs.py::params_shardings`` and ``prefill_fn``/``decode_fn`` run
under ``use_sharding(mesh, rules)``, as the JAX engine's jitted functions
trace under it. Token inputs (the same on every rank) enter as replicated
DTensors; the logits come back as DTensors (vocab-sharded), and the
caches are DTensors laid out by ``cache_specs``
(``models/model.py::init_caches``). Weight-only int8 quantizes the laid
out params, each leaf on local shards whole along its columns, so that a
scale is the max over its whole column (``quantize_params_int8``); the
payload keeps the leaf's placements, and it is dequantized on the same
shards.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from repro_torch.config.base import ModelConfig, ServeConfig
from repro_torch.config.torch_env import resolve_device
from repro_torch.distributed.sharding import (RuleSet, check_mesh_device,
                                              distribute_tree,
                                              on_local_shards,
                                              row_placements, serve_rules,
                                              use_sharding)
from repro_torch.kernels.ref import quantize_int8
from repro_torch.launch.specs import params_shardings
from repro_torch.models import model as lm
from repro_torch.tree import tree_map

Params = Any


def _is_q(leaf: Any) -> bool:
    return isinstance(leaf, dict) and "__int8__" in leaf


def _scale_placements(plc: Sequence[Placement], ndim: int
                      ) -> Tuple[Placement, ...]:
    """The placements of the per-column scale (dim -2 reduced away) of a
    payload laid out in ``plc`` with that dim whole."""
    def one(p):
        if not isinstance(p, Shard):
            return Replicate()
        d = p.dim % ndim
        assert d != ndim - 2, plc
        return Shard(ndim - 2) if d == ndim - 1 else p
    return tuple(one(p) for p in plc)


def _quantize(leaf: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One leaf's int8 payload and per-column scale. A DTensor leaf is
    quantized on local shards with its columns (dim -2) whole, then its
    payload laid out as the leaf is."""
    if not isinstance(leaf, DTensor):
        qv, s = quantize_int8(leaf, axis=-2)  # per-column of last dim
        return {"__int8__": qv, "scale": s}
    mesh, wp = leaf.device_mesh, row_placements(leaf, [-2])
    qv, s = on_local_shards(lambda t: quantize_int8(t, axis=-2), mesh,
                            (wp,), (wp, _scale_placements(wp, leaf.ndim)),
                            None)(leaf)
    return {"__int8__": qv.redistribute(mesh, leaf.placements), "scale": s}


def _dequantize(qv: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (qv.float() * scale[..., None, :]).to(torch.bfloat16)


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
            return _quantize(leaf)
        return leaf
    return tree_map(q, params)


def dequantize_params(params: Params) -> Params:
    def dq(leaf):
        if not _is_q(leaf):
            return leaf
        qv, s = leaf["__int8__"], leaf["scale"]
        if isinstance(qv, DTensor):
            return on_local_shards(_dequantize, qv.device_mesh,
                                   (qv.placements, s.placements),
                                   qv.placements, None)(qv, s)
        return _dequantize(qv, s)
    return tree_map(dq, params, is_leaf=_is_q)


def whole(t: torch.Tensor) -> torch.Tensor:
    """A step's output as one tensor: a DTensor gathered (outside the
    step, as the JAX engine's caller reads a sharded array)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


class ServingEngine:
    def __init__(self, cfg: ModelConfig, scfg: Optional[ServeConfig] = None,
                 mesh=None, rules: Optional[RuleSet] = None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.scfg = scfg or ServeConfig()
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rules = rules or serve_rules(self.scfg.serve_fsdp)
        self.params: Optional[Params] = None
        if mesh is not None:
            check_mesh_device(mesh, self.device, "an engine")

    def _weights(self, params: Params) -> Params:
        if self.scfg.quantize_weights:
            return dequantize_params(params)
        return params

    def _input(self, t: Optional[torch.Tensor]):
        """A token input as the step takes it: on a mesh, a DTensor
        replicated over it (every rank passes the same)."""
        if self.mesh is None or t is None or isinstance(t, DTensor):
            return t
        return DTensor.from_local(t.to(self.device), self.mesh,
                                  [Replicate()] * self.mesh.ndim,
                                  run_check=False)

    @torch.no_grad()
    def prefill_fn(self, params: Params, batch: Dict[str, Any]):
        with use_sharding(self.mesh, self.rules):
            return lm.prefill(self._weights(params), self.cfg,
                              {k: self._input(v) for k, v in batch.items()},
                              max_len=self.scfg.max_seq_len)

    @torch.no_grad()
    def decode_fn(self, params: Params, tokens: torch.Tensor, caches, pos):
        with use_sharding(self.mesh, self.rules):
            return lm.decode_step(self._weights(params), self.cfg,
                                  self._input(tokens), caches, pos)

    def init_caches(self, batch: int):
        """Zeroed caches of ``batch`` slots at ``max_seq_len``, laid out on
        the engine's mesh where it has one."""
        return lm.init_caches(self.cfg, batch, self.scfg.max_seq_len,
                              self.device, mesh=self.mesh, rules=self.rules)

    # ------------------------------------------------------------------
    def load(self, params: Params) -> None:
        if self.mesh is not None:
            params = distribute_tree(tree_map(lambda t: t, params),
                                     params_shardings(self.cfg, self.mesh,
                                                      self.rules))
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
            logits = whole(logits)
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
