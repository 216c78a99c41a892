"""Slot-based continuous batching.

Fixed B decode slots; finished slots are refilled from the queue without
draining the batch (per-slot sequence positions: the attention layer takes
a (b,) position tensor). Prefill runs per request at batch 1 and the fresh
cache is copied into the batched cache at the slot index, in place (the
JAX package does this with a vmapped, donated ``dynamic_update_index``).
On an engine's mesh the caches are DTensors on it; the rank whose local
shard holds the slot copies the prefill cache into it (``_insert``).
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.sharding import local_slice
from repro_torch.serving.engine import ServingEngine, whole


@dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (s,) int32
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    def __init__(self, engine: ServingEngine, slots: int):
        self.engine = engine
        self.cfg = engine.cfg
        self.device = engine.device
        self.slots = slots
        self.queue: Deque[Request] = deque()   # O(1) FIFO admission
        self.active: List[Optional[Request]] = [None] * slots
        self.finished: List[Request] = []
        self.positions = np.zeros(slots, np.int64)
        self.tokens = np.zeros(slots, np.int64)
        self.caches = None
        self._rid = itertools.count()

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16) -> int:
        rid = next(self._rid)
        self.queue.append(Request(rid, np.asarray(prompt, np.int32),
                                  max_new_tokens))
        return rid

    def _ensure_caches(self) -> None:
        if self.caches is None:
            self.caches = self.engine.init_caches(self.slots)

    def _insert(self, cache1, slot: int) -> None:
        """Copy every leaf of each layer's batch-1 cache (attention k/v,
        Mamba conv/ssd) into the batched cache at ``slot``. A DTensor leaf
        is written through the local shard of the data rank that holds the
        slot, from the prefill cache laid out as that shard is (whole
        along the batch)."""
        for big, small in zip(self.caches, cache1):
            for name, leaf in big.items():
                one = small[name]
                if not isinstance(leaf, DTensor):
                    leaf[slot].copy_(one[0])
                    continue
                plc = leaf.placements
                one = one.redistribute(leaf.device_mesh, [
                    Replicate() if p == Shard(0) else p for p in plc])
                off, n = local_slice(leaf, plc, 0)
                if off <= slot < off + n:
                    leaf.to_local()[slot - off].copy_(one.to_local()[0])

    def _admit(self, max_slots: Optional[int] = None) -> None:
        limit = self.slots if max_slots is None else min(max_slots,
                                                         self.slots)
        busy = sum(a is not None for a in self.active)
        for slot in range(self.slots):
            if busy >= limit or not self.queue:
                break
            if self.active[slot] is not None:
                continue
            busy += 1
            req = self.queue.popleft()
            tokens = torch.as_tensor(req.prompt[None, :], dtype=torch.long,
                                     device=self.device)
            logits, cache1 = self.engine.prefill_fn(self.engine.params,
                                                    {"tokens": tokens})
            self._ensure_caches()
            self._insert(cache1, slot)
            nxt = int(whole(torch.argmax(logits[0])))
            req.generated.append(nxt)
            self.active[slot] = req
            self.positions[slot] = len(req.prompt)
            self.tokens[slot] = nxt

    def step(self, max_slots: Optional[int] = None) -> int:
        """One engine tick: admit (up to ``max_slots`` concurrent) + one
        batched decode. Returns number of active slots. Requests already in
        flight keep decoding even if ``max_slots`` drops below the current
        occupancy; the cap throttles admission only."""
        self._admit(max_slots)
        live = [s for s in range(self.slots) if self.active[s] is not None]
        if not live:
            return 0
        self._ensure_caches()
        toks = torch.as_tensor(self.tokens[:, None], dtype=torch.long,
                               device=self.device)
        pos = torch.as_tensor(self.positions, dtype=torch.int32,
                              device=self.device)
        logits, self.caches = self.engine.decode_fn(
            self.engine.params, toks, self.caches, pos)
        nxt = whole(torch.argmax(logits, dim=-1)).cpu().numpy()
        for s in live:
            req = self.active[s]
            req.generated.append(int(nxt[s]))
            self.positions[s] += 1
            if len(req.generated) >= req.max_new_tokens:
                req.done = True
                self.active[s] = None
                self.finished.append(req)
            else:
                self.tokens[s] = int(nxt[s])
        return len(live)

    def run_to_completion(self, max_ticks: int = 10000) -> List[Request]:
        start = len(self.finished)
        for _ in range(max_ticks):
            if not self.queue and all(a is None for a in self.active):
                break
            self.step()
        return self.finished[start:]
