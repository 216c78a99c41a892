"""AdamW with optional row-wise int8 moment compression: the JAX package's
``training/optimizer.py`` on the port's parameter trees.

The int8 state path stores both Adam moments as (int8 payload, fp32
per-row scales), m linearly and v in log space: 4x smaller optimizer
state. The update is elementwise PyTorch on each leaf in the JAX order of
operations (clip, then m and v, bias correction, decay on every float
leaf, one rounding to the parameter's dtype); it is not a Pallas kernel in
the JAX package and has no kernel here.

Unlike JAX's pure function, :func:`adamw_update` writes the new parameters
and fp32 moments into the given tensors (and replaces int8 moments in the
given state's trees): at full width a second copy of 15 GB of fp32 moments
would otherwise be alive during the update.

On a mesh the parameters and moments are DTensors. Each gradient is first
redistributed to its parameter's placements (the reduce-scatter, or
all-reduce, that GSPMD inserts for FSDP and for the ``Partial`` gradients
of whole inputs to sharded work); the global norm then sums every shard;
each update keeps its leaf's placements, the int8 payloads and scales
included.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.config import TrainConfig
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = Any


class QTensor:
    """Row-wise (last-axis) int8 tensor: shape-preserving payload, fp32
    scale of shape ``shape[:-1] + (1,)``."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q              # int8, same shape as the source
        self.scale = scale      # fp32, shape[:-1] + (1,)

    def dequant(self) -> torch.Tensor:
        return self.q.to(torch.float32) * self.scale

    def children(self) -> Tuple[torch.Tensor, ...]:
        """The leaves in the JAX pytree's order (checkpoint keys 0, 1)."""
        return self.q, self.scale

    def __repr__(self):  # pragma: no cover
        return f"QTensor(shape={tuple(self.q.shape)})"


class QTensorLog:
    """Row-wise log-space uint8 tensor for non-negative data (Adam v):
    per-row (min, range) of log(v+tiny) mapped to [0, 255] — bounded
    *relative* error, so 1/sqrt(v) stays sane where linear int8 would
    collapse small entries to zero."""

    TINY = 1e-30

    def __init__(self, q, log_min, log_scale):
        self.q = q                     # uint8, source shape
        self.log_min = log_min         # fp32, shape[:-1] + (1,)
        self.log_scale = log_scale     # fp32, shape[:-1] + (1,)

    def dequant(self) -> torch.Tensor:
        logs = self.q.to(torch.float32) * self.log_scale + self.log_min
        return torch.clamp_min(torch.exp(logs) - self.TINY, 0.0)

    def children(self) -> Tuple[torch.Tensor, ...]:
        """The leaves in the JAX pytree's order (checkpoint keys 0-2)."""
        return self.q, self.log_min, self.log_scale

    def __repr__(self):  # pragma: no cover
        return f"QTensorLog(shape={tuple(self.q.shape)})"


def is_q(x: Any) -> bool:
    return isinstance(x, (QTensor, QTensorLog))


def _quant_rowwise(x: torch.Tensor) -> QTensor:
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.where(amax == 0, 1.0, amax / 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale)


def _quant_rowwise_log(x: torch.Tensor) -> QTensorLog:
    logs = torch.log(x + QTensorLog.TINY)
    lo = torch.amin(logs, dim=-1, keepdim=True)
    hi = torch.amax(logs, dim=-1, keepdim=True)
    scale = torch.clamp_min(hi - lo, 1e-12) / 255.0
    q = torch.clamp(torch.round((logs - lo) / scale), 0, 255).to(torch.uint8)
    return QTensorLog(q, lo, scale)


def _maybe_quant(x: torch.Tensor, dtype: str, log_space: bool = False):
    if dtype == "int8":
        return _quant_rowwise_log(x) if log_space else _quant_rowwise(x)
    return x.to(torch.float32)


def _maybe_dequant(x) -> torch.Tensor:
    if is_q(x):
        return x.dequant()
    return x


def placed_like(t: Any, like: Any) -> Any:
    """``t`` redistributed to ``like``'s placements where both are
    DTensors; ``t`` otherwise."""
    if isinstance(t, DTensor) and isinstance(like, DTensor) and \
            tuple(t.placements) != tuple(like.placements):
        return t.redistribute(like.device_mesh, like.placements)
    return t


class OptState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    m: Params
    v: Params


def init_opt_state(params: Params, cfg: TrainConfig) -> OptState:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
    device = tree_leaves(params)[0].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(lambda p: _maybe_quant(zeros(p), cfg.opt_state_dtype),
                   params),
        v=tree_map(lambda p: _maybe_quant(zeros(p), cfg.opt_state_dtype,
                                          log_space=True), params))


def opt_state_specs(param_specs: Params, cfg: TrainConfig) -> OptState:
    """Logical sharding specs matching init_opt_state's structure. Row-wise
    payloads inherit the param's logical spec; scales drop the last axis."""
    def leaf_m(spec):
        t = tuple(spec)
        if cfg.opt_state_dtype == "int8":
            return QTensor(q=t, scale=(*t[:-1], None))
        return t

    def leaf_v(spec):
        t = tuple(spec)
        if cfg.opt_state_dtype == "int8":
            return QTensorLog(q=t, log_min=(*t[:-1], None),
                              log_scale=(*t[:-1], None))
        return t

    is_t = lambda t: isinstance(t, tuple)
    return OptState(
        step=(),
        m=tree_map(leaf_m, param_specs, is_leaf=is_t),
        v=tree_map(leaf_v, param_specs, is_leaf=is_t),
    )


def lr_schedule(cfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """fp32 learning rate at ``step`` (an int32 tensor or an int)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp_max((step + 1) / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Params) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in leaves))


@torch.no_grad()
def adamw_update(grads: Params, state: OptState, params: Params,
                 cfg: TrainConfig) -> Tuple[Params, OptState, Dict[str, Any]]:
    """One AdamW step; ``grads`` is a tree (or the flat leaf list) of
    ``params``. Updates ``params`` and fp32 moments in place and returns
    them with the new state and {"lr", "grad_norm"}."""
    flat_g = [placed_like(g, p) for g, p in zip(tree_leaves(grads),
                                                 tree_leaves(params))]
    step = state.step + 1
    lr = lr_schedule(cfg, state.step)
    gnorm = global_norm(flat_g)
    clip = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)

    b1, b2, eps = cfg.beta1, cfg.beta2, cfg.eps
    step_f = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=step.device), step_f)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=step.device), step_f)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * clip
        m_f = _maybe_dequant(m)
        v_f = _maybe_dequant(v)
        m_n = b1 * m_f + (1 - b1) * g
        v_n = b2 * v_f + (1 - b2) * g * g
        update = (m_n / bc1) / (torch.sqrt(v_n / bc2) + eps)
        if p.dtype in (torch.float32, torch.bfloat16, torch.float16):
            update = update + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * update).to(p.dtype))
        if cfg.opt_state_dtype == "int8":
            return tuple(type(old)(*(placed_like(c, o) for c, o in zip(
                new.children(), old.children()))) for new, old in (
                    (_maybe_quant(m_n, "int8"), m),
                    (_maybe_quant(v_n, "int8", log_space=True), v)))
        m.copy_(m_n)
        v.copy_(v_n)
        return m, v

    flat_p = tree_leaves(params)
    flat_m = tree_leaves(state.m, is_leaf=is_q)
    flat_v = tree_leaves(state.v, is_leaf=is_q)
    new_m: List[Any] = []
    new_v: List[Any] = []
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        mn, vn = upd(p, g, m, v)
        new_m.append(mn)
        new_v.append(vn)
    m_tree = tree_unflatten(state.m, new_m, is_leaf=is_q)
    v_tree = tree_unflatten(state.v, new_v, is_leaf=is_q)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, OptState(step, m_tree, v_tree), metrics


def opt_state_bytes(params: Params, cfg: TrainConfig) -> int:
    leaves = tree_leaves(params)
    n = sum(l.numel() for l in leaves)
    if cfg.opt_state_dtype == "int8":
        # payloads (m int8 + v uint8) + row scales (1 + 2 fp32 per row)
        rows = sum(l.numel() // max(l.shape[-1], 1) for l in leaves)
        return 2 * n + 3 * rows * 4
    return 2 * n * 4
