"""Deterministic synthetic LM data pipeline with prefetch + straggler
backup.

Sequences mix a Zipf unigram stream with copy/repeat motifs so a small LM
has real structure to learn (the end-to-end example shows the loss curve).
Batches are keyed by (seed, step) — bitwise deterministic, which is what
makes the checkpoint-resume test exact.

Straggler mitigation (paper §8: single-unit failures must not stall the
job): the prefetcher runs fetches on worker threads with a deadline; a
fetch that misses its deadline is *hedged* — the batch for that step is
regenerated inline (generation is deterministic, so the hedge is
bit-identical) and the slow worker's late result is discarded.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig, ShapeSpec


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    copy_prob: float = 0.35
    frontend_tokens: int = 0
    frontend_dim: int = 0


def _gen_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, 0xC0FFEE]))
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    base = rng.zipf(cfg.zipf_a, size=(b, s + 1)) % v
    # Copy motif: with prob copy_prob, token t repeats token t-3.
    copy_mask = rng.random((b, s + 1)) < cfg.copy_prob
    shifted = np.roll(base, 3, axis=1)
    seq = np.where(copy_mask, shifted, base).astype(np.int32)
    out: Dict[str, np.ndarray] = {
        "tokens": seq[:, :-1],
        "labels": seq[:, 1:].astype(np.int32),
        "mask": np.ones((b, s), np.float32),
    }
    if cfg.frontend_tokens:
        out["vision_embeds"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return out


def data_config_for(model: ModelConfig, shape: ShapeSpec,
                    seed: int = 0) -> DataConfig:
    ft = model.frontend_tokens
    return DataConfig(
        vocab_size=model.vocab_size,
        seq_len=shape.seq_len - ft,
        global_batch=shape.global_batch,
        seed=seed,
        frontend_tokens=ft,
        frontend_dim=model.frontend_dim or model.d_model,
    )


class PrefetchingLoader:
    """Background prefetch with per-fetch deadline + deterministic hedging.
    """

    def __init__(self, cfg: DataConfig, prefetch: int = 2,
                 fetch_deadline_s: float = 30.0,
                 place_fn: Optional[Callable[[Dict[str, np.ndarray]], Any]]
                 = None,
                 delay_injector: Optional[Callable[[int], float]] = None):
        self.cfg = cfg
        self.prefetch = prefetch
        self.deadline = fetch_deadline_s
        self.place_fn = place_fn or (lambda b: b)
        self.delay_injector = delay_injector  # tests inject stragglers
        self.hedge_count = 0
        self._results: Dict[int, Any] = {}
        self._lock = threading.Lock()
        self._next_to_start = 0

    def _fetch(self, step: int) -> None:
        if self.delay_injector is not None:
            time.sleep(self.delay_injector(step))
        batch = _gen_batch(self.cfg, step)
        with self._lock:
            self._results.setdefault(step, batch)

    def _ensure_started(self, upto: int) -> None:
        while self._next_to_start <= upto:
            s = self._next_to_start
            threading.Thread(target=self._fetch, args=(s,),
                             daemon=True).start()
            self._next_to_start += 1

    def get(self, step: int) -> Any:
        self._ensure_started(step + self.prefetch)
        deadline = time.monotonic() + self.deadline
        while True:
            with self._lock:
                if step in self._results:
                    batch = self._results.pop(step)
                    break
            if time.monotonic() > deadline:
                # Hedge: regenerate deterministically inline.
                self.hedge_count += 1
                batch = _gen_batch(self.cfg, step)
                with self._lock:
                    self._results.pop(step, None)
                break
            time.sleep(0.001)
        return self.place_fn(batch)

    def __iter__(self) -> Iterator[Any]:
        step = 0
        while True:
            yield self.get(step)
            step += 1


def place_on_device(device: torch.device | str):
    """Returns a place_fn moving each array of a batch to ``device`` as a
    tensor (the one-device counterpart of ``place_on_mesh``)."""
    device = torch.device(device)

    def place(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(arr).to(device)
                for k, arr in batch.items()}

    return place


def place_on_mesh(mesh, rules):
    """Returns a place_fn putting each array with its logical sharding: a
    DTensor on ``mesh`` (every rank passes the same batch), or a plain
    tensor without a mesh or rules."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import named_sharding

    logical = {
        "tokens": ("batch", "seq"),
        "labels": ("batch", "seq"),
        "mask": ("batch", "seq"),
        "vision_embeds": ("batch", "seq", "embed_act"),
    }

    def place(batch: Dict[str, np.ndarray]):
        out = {}
        for k, arr in batch.items():
            ns = named_sharding(arr.shape, logical[k], mesh, rules)
            t = torch.as_tensor(arr)
            out[k] = (distribute_tensor(t.to(ns.mesh.device_type), ns.mesh,
                                        list(ns.placements))
                      if ns is not None else t)
        return out

    return place
