"""The LM wrapper: init / specs / forward / prefill / decode.

``batch`` dict convention, as in the JAX package's ``models/model.py``:
  tokens : (b, s) integer tensor
  vision_embeds : (b, ft, d)  (optional; VLM/audio frontend stubs)

``loss_fn`` (with ``_ce_terms``) is the JAX package's training loss
(``src/repro/models/model.py:83-153``): masked next-token cross-entropy
plus a z-loss and the MoE aux loss, optionally over sequence chunks whose
logits are recomputed in the backward, so the ``(b, s, vocab)`` fp32
logits never exist at once.

Parameters are a dict ``{"embed": {...}, "layers": [per-layer dicts],
"final_norm": {...}}``; ``repro_torch.convert.from_jax_params`` builds one
from the JAX package's ``init_params`` pytree. Dense, SSM (Mamba-2), MoE
and hybrid stacks run. ``forward`` returns (logits, caches, aux) as the
JAX package's does; aux, the MoE load-balancing loss, is computed in train
mode only (None otherwise), and ``prefill``/``decode_step`` drop it as
JAX's do. A layer's cache is ``{"k", "v"}`` for attention and
``{"conv", "ssd"}`` for Mamba.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.config.base import ModelConfig
from repro_torch.distributed.sharding import (RuleSet, local_slice,
                                              map_shardings,
                                              on_local_shards, shard,
                                              tree_shardings, zeros)
from repro_torch.models import transformer as stack
from repro_torch.models.layers import (embed_apply, embed_init,
                                       embed_specs, pad_seq, rmsnorm_apply,
                                       rmsnorm_init, rmsnorm_specs,
                                       unembed_apply)

Params = Dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# ---------------------------------------------------------------------------
# Params.
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, gen: torch.Generator,
                device: torch.device) -> Params:
    """Random weights (normal, scale 0.02, as the JAX package's
    ``dense_init``) drawn from ``gen``, which must live on ``device``."""
    dtype = torch_dtype(cfg.dtype)
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                            cfg.tie_embeddings, device),
        "layers": stack.stack_init(gen, cfg, dtype, device),
        "final_norm": rmsnorm_init(cfg.d_model, device),
    }


def param_specs(cfg: ModelConfig) -> Params:
    """Each leaf's logical sharding spec, in ``init_params``' layout."""
    return {
        "embed": embed_specs(cfg.tie_embeddings),
        "layers": stack.stack_specs(cfg),
        "final_norm": rmsnorm_specs(),
    }


def param_shapes(cfg: ModelConfig) -> Params:
    """The params as meta tensors: shapes and dtypes, no allocation."""
    return init_params(cfg, torch.Generator(), torch.device("meta"))


# ---------------------------------------------------------------------------
# Forward passes.
# ---------------------------------------------------------------------------
def _embed_inputs(params: Params, batch: Dict[str, Any]) -> torch.Tensor:
    x = embed_apply(params["embed"], batch["tokens"])
    ve = batch.get("vision_embeds")
    if ve is not None:
        x = shard(torch.cat([ve.to(x.dtype), x], dim=1),
                  ("batch", "seq", "embed_act"))
    return x


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, Any], *,
            mode: str = "train", caches: Optional[List[Params]] = None,
            pos=None, max_len: Optional[int] = None, remat: str = "none"
            ) -> Tuple[torch.Tensor, Optional[List[Params]],
                       Optional[torch.Tensor]]:
    """Returns (logits, caches, aux); aux is None outside train."""
    x = _embed_inputs(params, batch)
    x, new_caches, aux = stack.stack_apply(
        params["layers"], cfg, x, mode=mode, caches=caches, pos=pos,
        max_len=max_len, remat=remat)
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps,
                      lowp=cfg.mlp_lowp)
    return unembed_apply(params["embed"], x), new_caches, aux


def _pick(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``gather(logits, -1, idx)``. On vocab-sharded DTensor logits each
    rank picks from its own vocab shard, 0 where the label lies in
    another's, a partial sum over the vocab's mesh dims; through DTensor's
    gather the backward would make a zero gradient of the logits' global
    shape on every rank."""
    last = logits.ndim - 1
    vocab = [i for i, p in enumerate(getattr(logits, "placements", ()))
             if isinstance(p, Shard) and p.dim % logits.ndim == last]
    if not vocab:
        return torch.gather(logits, -1, idx)
    lp = tuple(logits.placements)
    rows = tuple(Replicate() if i in vocab else p for i, p in enumerate(lp))
    out = tuple(Partial() if i in vocab else p for i, p in enumerate(lp))
    off, n = local_slice(logits, lp, last)

    def local(lg, ix):
        j = ix - off
        got = torch.gather(lg, -1, torch.clamp(j, 0, n - 1))
        return torch.where((j >= 0) & (j < n), got, 0.0)

    return on_local_shards(local, logits.device_mesh, (lp, rows), out,
                           (lp, rows))(logits, idx)


def _ce_terms(logits_f32: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of masked NLL, sum of masked lse^2). The picked logit keeps its
    trailing dim until the subtraction: on vocab-sharded DTensor logits it
    is a partial sum over the shards (:func:`_pick`), reduced there. The
    log-sum-exp is written out as max, exp and sum
    (``jax.nn.logsumexp``'s form, the max held constant), each of which
    DTensor reduces across vocab shards; it has no rule for
    ``torch.logsumexp`` over a sharded dim and would gather the whole
    logits on every rank first."""
    m = torch.amax(logits_f32, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits_f32 - m), dim=-1)) + m[..., 0]
    picked = _pick(logits_f32, labels.long()[..., None])
    nll = (lse[..., None] - picked)[..., 0] * mask
    return torch.sum(nll), torch.sum((lse * mask) ** 2)


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, Any], *,
            remat: str = "none", z_loss: float = 1e-4, loss_chunk: int = 0
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (total, {"ce", "aux", "z_loss", "tokens"}), as the JAX
    package's ``loss_fn``: total = ce + aux + z_loss, each a mean over the
    masked tokens (and aux the MoE layers' sum)."""
    labels = batch["labels"]
    mask = batch["mask"].to(torch.float32)
    denom = torch.clamp(torch.sum(mask), min=1.0)

    if loss_chunk:
        x = _embed_inputs(params, batch)
        x, _, aux = stack.stack_apply(params["layers"], cfg, x, mode="train",
                                      remat=remat)
        x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps,
                          lowp=cfg.mlp_lowp)
        ft = x.shape[1] - labels.shape[1]
        if ft:
            x = x[:, ft:]
        s = labels.shape[1]
        chunk = min(loss_chunk, s)
        pad = (-s) % chunk
        if pad:
            x = pad_seq(x, 0, pad)
            labels = pad_seq(labels, 0, pad)
            mask = pad_seq(mask, 0, pad)

        def chunk_ce(xc, lc, mc):
            logits = unembed_apply(params["embed"], xc).to(torch.float32)
            return _ce_terms(logits, lc, mc)

        nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        z_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, x.shape[1], chunk):
            nll_c, z_c = stack.remat_call(
                "full", chunk_ce, x[:, c0:c0 + chunk],
                labels[:, c0:c0 + chunk], mask[:, c0:c0 + chunk])
            nll_sum = nll_sum + nll_c
            z_sum = z_sum + z_c
    else:
        logits, _, aux = forward(params, cfg, batch, mode="train",
                                 remat=remat)
        if logits.shape[1] != labels.shape[1]:
            # Frontend stub prepends embeddings; score text positions only.
            logits = logits[:, logits.shape[1] - labels.shape[1]:]
        nll_sum, z_sum = _ce_terms(logits.to(torch.float32), labels, mask)
    ce = nll_sum / denom
    zl = z_loss * z_sum / denom
    total = ce + aux + zl
    return total, {"ce": ce, "aux": aux, "z_loss": zl,
                   "tokens": torch.sum(mask)}


# ---------------------------------------------------------------------------
# Serving entry points.
# ---------------------------------------------------------------------------
def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Any], *,
            max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, List[Params]]:
    """Returns (last-position logits, caches padded to max_len)."""
    logits, caches, _ = forward(params, cfg, batch, mode="prefill",
                                max_len=max_len)
    return logits[:, -1], caches


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                caches: List[Params], pos
                ) -> Tuple[torch.Tensor, List[Params]]:
    """tokens: (b, 1). Returns (logits (b, vocab), caches), the caches
    updated in place."""
    logits, new_caches, _ = forward(params, cfg, {"tokens": tokens},
                                    mode="decode", caches=caches, pos=pos)
    return logits[:, 0], new_caches


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device: torch.device, dtype: Optional[torch.dtype] = None,
                *, mesh=None, rules: Optional[RuleSet] = None
                ) -> List[Params]:
    """Zeroed decode caches; with a ``mesh`` (and ``rules``), DTensors laid
    out by ``cache_specs``, each rank allocating only its shard."""
    dtype = dtype or torch_dtype(cfg.dtype)
    if mesh is None:
        return stack.stack_caches(cfg, batch, max_len, dtype, device)
    meta = stack.stack_caches(cfg, batch, max_len, dtype,
                              torch.device("meta"))
    return map_shardings(lambda t, ns: zeros(t.shape, t.dtype, ns), meta,
                         tree_shardings(meta, cache_specs(cfg), mesh, rules))


def cache_specs(cfg: ModelConfig) -> List[Params]:
    return stack.stack_cache_specs(cfg)
