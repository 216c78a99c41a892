"""Fault tolerance: failure detection, retries, and elastic re-meshing.

The paper (§8, "Killer applications") calls fault tolerance "crucial for
the success of SoC Cluster" — single-SoC failures must not take down the
job. At pod scale the equivalents are: (a) checkpoint/restart (see
``training.checkpoint``), (b) detecting dead/straggling units, (c) elastic
re-meshing — continuing on a smaller (or larger) healthy mesh by restoring
the last checkpoint with new shardings.
"""
from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Heartbeats / straggler detection.
# ---------------------------------------------------------------------------
@dataclass
class UnitHealth:
    unit_id: int
    last_heartbeat: float
    # bounded O(1) ring of recent step times (was list.pop(0) — O(n))
    step_times: Deque[float] = field(
        default_factory=lambda: deque(maxlen=64))
    failed: bool = False

    def record(self, t_now: float, step_time: float) -> None:
        self.last_heartbeat = t_now
        self.step_times.append(step_time)


class HealthTracker:
    """Tracks per-unit liveness and step-time distribution.

    A unit is *failed* if it missed ``timeout_s`` of heartbeats, and a
    *straggler* if its recent step time exceeds ``straggler_factor`` x the
    cluster median (the mitigation hooks — hedged dispatch, backup fetch —
    live in the scheduler and data pipeline).
    """

    def __init__(self, unit_ids: Sequence[int], timeout_s: float = 60.0,
                 straggler_factor: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        now = clock()
        self.units: Dict[int, UnitHealth] = {
            u: UnitHealth(u, now) for u in unit_ids}
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor

    def heartbeat(self, unit_id: int, step_time: float) -> None:
        self.units[unit_id].record(self._clock(), step_time)

    def mark_failed(self, unit_id: int) -> None:
        self.units[unit_id].failed = True

    def failed_units(self) -> List[int]:
        now = self._clock()
        out = []
        for u in self.units.values():
            if u.failed or now - u.last_heartbeat > self.timeout_s:
                out.append(u.unit_id)
        return sorted(out)

    def healthy_units(self) -> List[int]:
        bad = set(self.failed_units())
        return sorted(u for u in self.units if u not in bad)

    def stragglers(self) -> List[int]:
        times = {u.unit_id: np.mean(list(u.step_times)[-8:])
                 for u in self.units.values() if u.step_times}
        if len(times) < 2:
            return []
        med = float(np.median(list(times.values())))
        return sorted(u for u, t in times.items()
                      if t > self.straggler_factor * med)


# ---------------------------------------------------------------------------
# Retries.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RetryPolicy:
    """The single copy of the exponential-backoff math.

    ``with_retries`` (wall clock) and the fleet's deterministic retry
    mechanism (``repro_torch.fleet.degrade``, sim clock) both delay attempt
    ``a`` by :meth:`delay_s` — there is deliberately no second
    implementation of ``backoff * 2**attempt`` anywhere in the repo.

    The jitter path is *seeded and clock-free*: :meth:`jitter_u` is a
    pure function of ``(seed, key)`` (the fleet uses the global tick
    index as ``key``), so two engines replaying the same schedule draw
    bit-identical jitter — wall-clock ``random.random()`` jitter would
    make retry timing, and therefore telemetry, irreproducible.
    """

    max_attempts: int = 3
    backoff_s: float = 0.1
    jitter: float = 0.0  # fraction of the base delay added at u=1
    seed: int = 0

    def __post_init__(self) -> None:
        assert self.max_attempts >= 1, "need at least one attempt"
        assert self.backoff_s >= 0.0, "backoff must be non-negative"
        assert 0.0 <= self.jitter, "jitter fraction must be >= 0"

    def delay_s(self, attempt: int, u: float = 0.0) -> float:
        """Backoff before retrying after failed attempt ``attempt``
        (0-based): ``backoff_s * 2**attempt * (1 + jitter * u)`` with
        ``u`` in [0, 1) from :meth:`jitter_u` (or 0 for no jitter)."""
        return self.backoff_s * (2 ** attempt) * (1.0 + self.jitter * u)

    def jitter_u(self, key: int) -> float:
        """Deterministic jitter draw in [0, 1) for ``key`` — seeded,
        independent of call order, identical across engines."""
        return float(np.random.default_rng([self.seed, int(key)]).random())

    @property
    def max_delay_s(self) -> float:
        """Upper bound on any single backoff delay (jitter maxed)."""
        return self.delay_s(self.max_attempts - 1, 1.0)


def with_retries(fn: Callable, max_attempts: int = 3,
                 backoff_s: float = 0.1,
                 retriable: Tuple[type, ...] = (RuntimeError,)):
    """Wrap a step function with bounded retries (transient XLA/runtime
    failures; non-retriable exceptions propagate). Delays come from
    :class:`RetryPolicy` — jitter-free here for backward compatibility."""
    policy = RetryPolicy(max_attempts=max_attempts, backoff_s=backoff_s)

    def wrapped(*a, **kw):
        last = None
        for attempt in range(policy.max_attempts):
            try:
                return fn(*a, **kw)
            except retriable as e:  # pragma: no cover - timing dependent
                last = e
                log.warning("step failed (attempt %d/%d): %s",
                            attempt + 1, policy.max_attempts, e)
                time.sleep(policy.delay_s(attempt))
        raise last
    return wrapped


# ---------------------------------------------------------------------------
# Elastic re-meshing.
# ---------------------------------------------------------------------------
def shrink_mesh_shape(shape: Tuple[int, ...], axes: Tuple[str, ...],
                      n_failed: int, shrink_axis: str = "data"
                      ) -> Tuple[int, ...]:
    """Compute the largest healthy mesh after losing ``n_failed`` units:
    the elastic policy drops whole slices along ``shrink_axis`` (each slice
    = prod(other axes) units), mirroring the SoC Cluster's PCB-granular
    fail-out."""
    sizes = dict(zip(axes, shape))
    other = 1
    for a, s in sizes.items():
        if a != shrink_axis:
            other *= s
    lost_slices = -(-n_failed // other)  # ceil
    new = max(1, sizes[shrink_axis] - lost_slices)
    return tuple(new if a == shrink_axis else sizes[a] for a in axes)


def remesh_arrays(tree, new_shardings):
    """Re-shard a tree of DTensors onto a new mesh (e.g. the one
    ``shrink_mesh_shape`` gives). DTensor redistributes only within one
    mesh, so each tensor goes through its full value (a collective on its
    old mesh: every rank of that mesh calls this) and is distributed onto
    the new mesh by ``distribute_tensor``; a rank outside the new mesh
    gets an empty local shard. ``new_shardings`` is a tree of
    ``distributed.sharding.NamedSharding`` (mesh, placements) pairs with
    the tree's structure; from a checkpoint this is a plain sharded
    load."""
    # deferred: failure detection (HealthTracker) must stay importable
    # without torch.distributed — the scalar/vector chaos path composes
    # with it
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.tree import tree_leaves, tree_unflatten

    is_sharding = lambda s: hasattr(s, "placements")
    leaves = tree_leaves(new_shardings, is_leaf=is_sharding)
    moved = [distribute_tensor(x.full_tensor(), s.mesh, list(s.placements))
             for x, s in zip(tree_leaves(tree), leaves, strict=True)]
    return tree_unflatten(new_shardings, moved, is_leaf=is_sharding)


def elastic_step_scale(global_batch: int, old_data: int, new_data: int
                       ) -> Tuple[int, float]:
    """Keep the *global* batch when the data axis shrinks by raising the
    per-replica microbatch count; returns (microbatches, lr_scale)."""
    assert global_batch % old_data == 0
    per_replica = global_batch // old_data
    micro = -(-global_batch // (new_data * per_replica))
    return micro, 1.0  # same global batch => same LR
