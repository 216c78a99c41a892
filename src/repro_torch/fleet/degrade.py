"""Graceful-degradation control plane for the fleet (ROADMAP: SLO-tiered
admission control when the pool saturates).

The chaos layer (``chaos.py``) injects faults; this module is the
self-protection layer that rides them out. Four composable mechanisms,
each declarative and seeded like :class:`~repro_torch.fleet.chaos.ChaosSchedule`:

* **SLO-tiered admission control** — offered load is split into tiers
  (:class:`TierSpec`: gold/silver/bulk by default) with per-tier
  deadline budgets. When the fleet's estimated queueing delay
  (queued cost over breaker-scaled live capacity) exceeds a tier's
  budget, that tier is *shed at the door*: counted, scheduled for
  retry, never silently dropped. Conservation becomes
  ``injected = served + queued + shed + dropped + respilled``.
* **Deadline-aware load shedding** — queued work older than
  ``queue_deadline_s`` is abandoned inside the fluid drain
  (:meth:`repro_torch.runtime.workload.QueueWorkload.expire`) instead of
  being served uselessly, reclaiming capacity during flash crowds.
* **Per-rack circuit breakers** — a rack trips open on queue delay or
  on the chaos liveness signal (router stops sending), half-opens
  after a cooldown with ``probe_fraction`` traffic, and closes on
  recovery. All transitions run on the *sim clock* in whole ticks
  (integer tick arithmetic, so every engine agrees on transition
  instants by construction).
* **Deterministic retry** — shed mass is re-submitted through the
  router after exponential backoff with seeded jitter. The backoff
  math is :class:`repro_torch.distributed.fault.RetryPolicy` (the single
  copy in the repo); the retry budget (``max_attempts``) makes retry
  storms impossible by construction, and the bounded ring buffer the
  mass waits in makes that visible in the types.

Parity contract: the scalar and vector engines are driven by **one**
:class:`DegradeDriver` instance per run — admission, breaker, and
retry decisions are literally the same Python objects, so the two
engines stay bitwise-identical (the same trick ``router.py`` uses).
Deadline expiry runs inside the shared ``QueueWorkload`` deque, again
one code path. The jax engine lowers the same policy to branchless
per-tick rows inside its ``lax.scan`` (`repro_torch.fleet.jax_engine`) and
rides the documented tolerance budgets; decision thresholds compared
against float queue state can flip a tick under XLA float semantics,
which is the same quantized-decision caveat the governor lowering
carries. The jax engine also emits per-tick per-tier admitted rows
(``dg_adm`` / ``dg_respill``) and rebuilds the hosts'
``_tier_requests`` sub-request split host-side — slice existence is
a ``frac > 0`` predicate on both sides, never cost rounding dust —
so response/queued/void *counts* match the hosts exactly and
tier-tagged latencies (:func:`tier_latency_percentiles`) agree
within the tolerance budgets on all three backends.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.distributed.fault import RetryPolicy

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from repro_torch.fleet.router import FleetView
    from repro_torch.fleet.telemetry import FleetTelemetry

__all__ = [
    "TierSpec",
    "BreakerConfig",
    "DegradePolicy",
    "LoweredDegrade",
    "DegradeDriver",
    "tier_latency_percentiles",
    "BRK_CLOSED",
    "BRK_OPEN",
    "BRK_HALF",
]

# breaker states (int codes shared with the jax lowering's carry)
BRK_CLOSED, BRK_OPEN, BRK_HALF = 0, 1, 2

#: floor for capacity denominators in delay estimates (all racks dead /
#: all breakers open -> delay saturates instead of dividing by zero)
_CAP_EPS = 1e-12


@dataclass(frozen=True)
class TierSpec:
    """One admission tier: its share of offered load and its budget.

    ``share`` is the tier's fraction of every tick's fresh offered rps
    (shares must sum to 1); ``deadline_budget_s`` is the estimated
    queueing delay above which the tier is shed at the door. Gold gets
    a generous budget, bulk a tight one — under saturation the bulk
    tier sheds first and gold keeps its latency."""

    name: str
    share: float
    deadline_budget_s: float

    def __post_init__(self) -> None:
        if not 0.0 <= self.share <= 1.0:
            raise ValueError(f"tier {self.name!r}: share must be in [0, 1]")
        if self.deadline_budget_s <= 0.0:
            raise ValueError(
                f"tier {self.name!r}: deadline budget must be positive")


def default_tiers() -> List[TierSpec]:
    """The gold/silver/bulk split used when a policy gives none."""
    return [
        TierSpec("gold", 0.2, 600.0),
        TierSpec("silver", 0.3, 300.0),
        TierSpec("bulk", 0.5, 120.0),
    ]


@dataclass(frozen=True)
class BreakerConfig:
    """Per-rack circuit breaker thresholds (sim-clock seconds).

    A rack opens when its queue delay (queued cost / chaos-degraded
    capacity) exceeds ``open_after_s`` or — with ``use_chaos_signal``
    — when it has been fully dead for more than ``fail_timeout_s``
    (the :class:`~repro_torch.fleet.chaos.ChaosMonitor` liveness timeout, in
    whole ticks so every engine agrees). After ``cooldown_s`` it
    half-opens and receives ``probe_fraction`` of its normal routing
    share; it closes once delay recovers below ``close_below_s``."""

    open_after_s: float = 600.0
    close_below_s: float = 120.0
    cooldown_s: float = 600.0
    probe_fraction: float = 0.1
    use_chaos_signal: bool = True
    fail_timeout_s: float = 120.0

    def __post_init__(self) -> None:
        if self.open_after_s <= self.close_below_s:
            raise ValueError("breaker must open above where it closes")
        if not 0.0 < self.probe_fraction <= 1.0:
            raise ValueError("probe_fraction must be in (0, 1]")
        if self.cooldown_s <= 0.0:
            raise ValueError("cooldown_s must be positive")


@dataclass(frozen=True)
class DegradePolicy:
    """A declarative, seeded degradation plan for one fleet run.

    Any mechanism can be disabled: an empty ``tiers`` list turns off
    admission control, ``queue_deadline_s=None`` turns off deadline
    shedding, ``breaker=None`` turns off the circuit breakers, and a
    ``retry`` budget of one attempt turns shed mass straight into
    ``retry_dropped`` (no re-submission). ``seed`` feeds the retry
    jitter only — everything else is deterministic already."""

    tiers: Tuple[TierSpec, ...] = field(
        default_factory=lambda: tuple(default_tiers()))
    queue_deadline_s: Optional[float] = None
    breaker: Optional[BreakerConfig] = None
    retry: RetryPolicy = field(
        default_factory=lambda: RetryPolicy(
            max_attempts=3, backoff_s=120.0, jitter=0.5))
    seed: int = 0

    def __post_init__(self) -> None:
        if self.tiers:
            total = 0.0
            for t in self.tiers:
                total += t.share
            if abs(total - 1.0) > 1e-9:
                raise ValueError(
                    f"tier shares must sum to 1, got {total!r}")
        if self.queue_deadline_s is not None and self.queue_deadline_s <= 0:
            raise ValueError("queue_deadline_s must be positive")

    @property
    def retry_policy(self) -> RetryPolicy:
        """The retry policy with this plan's seed folded in (a policy
        constructed with an explicit seed keeps it)."""
        if self.retry.seed == 0 and self.seed != 0:
            return RetryPolicy(
                max_attempts=self.retry.max_attempts,
                backoff_s=self.retry.backoff_s,
                jitter=self.retry.jitter,
                seed=self.seed,
            )
        return self.retry

    def lower(self, n_units: Sequence[int], dt_s: float) -> "LoweredDegrade":
        """Bind the policy to a fleet shape + tick width: precompute
        the integer tick constants every engine shares (deadline lag,
        breaker cooldown/fail-timeout ticks, retry ring size)."""
        return LoweredDegrade(self, np.asarray(n_units, np.int64), dt_s)


def _ceil_ticks(seconds: float, dt_s: float) -> int:
    """Whole-tick count covering ``seconds`` (with an epsilon so an
    exact multiple of ``dt`` does not round up an extra tick)."""
    return max(1, int(math.ceil(seconds / dt_s - 1e-9)))


class LoweredDegrade:
    """A :class:`DegradePolicy` bound to a fleet: static tick constants
    plus the per-tick retry-delay rows both the host driver and the
    jax ``lax.scan`` consume (one backoff computation, two engines)."""

    def __init__(
        self, policy: DegradePolicy, n_units: np.ndarray, dt_s: float
    ) -> None:
        self.policy = policy
        self.n_units = np.asarray(n_units, np.int64)
        self.dt_s = float(dt_s)
        self.n_racks = len(self.n_units)
        self.tiers = list(policy.tiers)
        self.n_tiers = len(self.tiers)
        self.shares = np.asarray([t.share for t in self.tiers], float)
        self.budgets = np.asarray(
            [t.deadline_budget_s for t in self.tiers], float)
        self.retry = policy.retry_policy
        # deadline lag in ticks: a request injected at tick j (arrival
        # j*dt + dt/2) expires at the first tick start i*dt with
        # i*dt - arrival >= deadline, i.e. i - j >= ceil(deadline/dt + 1/2)
        self.deadline_lag = (
            _ceil_ticks(policy.queue_deadline_s + 0.5 * dt_s, dt_s)
            if policy.queue_deadline_s is not None
            else 0
        )
        # retry ring size: the longest possible backoff (jitter maxed)
        # in ticks, plus the release slot itself
        self.max_dticks = _ceil_ticks(
            max(self.retry.max_delay_s, dt_s), dt_s)
        self.ring_slots = self.max_dticks + 2
        brk = policy.breaker
        self.cooldown_ticks = (
            _ceil_ticks(brk.cooldown_s, dt_s) if brk is not None else 0)
        self.fail_timeout_ticks = (
            _ceil_ticks(brk.fail_timeout_s, dt_s) if brk is not None else 0)

    @property
    def admission_on(self) -> bool:
        return self.n_tiers > 0

    @property
    def breaker_on(self) -> bool:
        return self.policy.breaker is not None

    def retry_dticks(self, tick: int) -> np.ndarray:
        """Backoff delays in whole ticks for mass shed at global tick
        ``tick``, one entry per failed attempt index — the seeded
        jitter draw keyed by the tick, through the one
        :class:`RetryPolicy` implementation."""
        u = self.retry.jitter_u(tick)
        out = np.empty(self.retry.max_attempts, np.int64)
        for a in range(self.retry.max_attempts):
            out[a] = _ceil_ticks(
                max(self.retry.delay_s(a, u), self.dt_s), self.dt_s)
        return out

    def retry_rows(self, tick0: int, n_ticks: int) -> np.ndarray:
        """``(n_ticks, max_attempts)`` int64 retry-delay rows for the
        jax lowering (block-resamplable: row ``k`` depends only on the
        absolute tick index ``tick0 + k``)."""
        rows = np.empty((n_ticks, self.retry.max_attempts), np.int64)
        for k in range(n_ticks):
            rows[k] = self.retry_dticks(tick0 + k)
        return rows


class DegradeDriver:
    """The host-side control loop: admission + breakers + retry.

    One instance drives **both** the scalar and the vector engine in a
    run (the fleet constructs it per :meth:`play_trace`), so their
    degradation decisions are bitwise-identical by construction. All
    state advances in :meth:`pre_route`, called once per tick *after*
    chaos masks/deadline expiry and *before* routing.
    """

    def __init__(self, lowered: LoweredDegrade) -> None:
        self.lowered = lowered
        lw = lowered
        self.dt_s = lw.dt_s
        # retry ring: mass waiting to re-enter, by (slot, tier, attempt)
        self.ring = np.zeros(
            (lw.ring_slots, max(lw.n_tiers, 1), lw.retry.max_attempts))
        # breaker state/since/last-live, all in whole ticks
        n = lw.n_racks
        self.breaker_state = np.zeros(n, np.int64)
        self._since = np.zeros(n, np.int64)
        self._last_live = np.full(n, -1, np.int64)
        # cumulative counters (the telemetry reads these at run end)
        self.shed_by_tier = np.zeros(max(lw.n_tiers, 1))
        self.retried_cost = 0.0
        self.retry_dropped_cost = 0.0
        self.breaker_opens = 0
        # per-tick series (telemetry + shed_storm SLO rule)
        self.shed_cost_t: List[float] = []
        self.breaker_state_t: List[np.ndarray] = []

    # -- derived -------------------------------------------------------
    @property
    def shed_cost(self) -> float:
        total = 0.0
        for v in self.shed_by_tier:
            total += float(v)
        return total

    def ring_mass(self) -> float:
        """Mass still waiting for a retry slot (drain runs until 0)."""
        total = 0.0
        for v in self.ring.ravel():
            total += float(v)
        return total

    def breaker_scale(self) -> np.ndarray:
        """Per-rack routing multiplier for the current breaker state."""
        lw = self.lowered
        if not lw.breaker_on:
            return np.ones(lw.n_racks)
        brk = lw.policy.breaker
        assert brk is not None
        scale = np.ones(lw.n_racks)
        scale[self.breaker_state == BRK_OPEN] = 0.0
        scale[self.breaker_state == BRK_HALF] = brk.probe_fraction
        return scale

    # -- per-tick control ---------------------------------------------
    def _update_breakers(
        self,
        tick: int,
        queued_cost: np.ndarray,
        cap_rps: np.ndarray,
        dead: Optional[np.ndarray],
    ) -> None:
        lw = self.lowered
        brk = lw.policy.breaker
        assert brk is not None
        n = lw.n_racks
        full_dead = np.zeros(n, bool)
        if dead is not None:
            full_dead = np.asarray(dead, np.int64) >= lw.n_units
        self._last_live[~full_dead] = tick
        failed = np.zeros(n, bool)
        if brk.use_chaos_signal:
            failed = (tick - self._last_live) > lw.fail_timeout_ticks
        delay = queued_cost / np.maximum(cap_rps, _CAP_EPS)
        trip = (delay > brk.open_after_s) | failed
        for r in range(n):
            st = int(self.breaker_state[r])
            if st == BRK_CLOSED:
                if trip[r]:
                    self.breaker_state[r] = BRK_OPEN
                    self._since[r] = tick
                    self.breaker_opens += 1
            elif st == BRK_OPEN:
                if tick - self._since[r] >= lw.cooldown_ticks:
                    self.breaker_state[r] = BRK_HALF
                    self._since[r] = tick
            else:  # half-open
                if trip[r]:
                    self.breaker_state[r] = BRK_OPEN
                    self._since[r] = tick
                    self.breaker_opens += 1
                elif delay[r] <= brk.close_below_s and not failed[r]:
                    self.breaker_state[r] = BRK_CLOSED

    def pre_route(
        self,
        tick: int,
        rps: float,
        respill_rps: float,
        queued_cost: np.ndarray,
        cap_rps: np.ndarray,
        dead: Optional[np.ndarray],
    ) -> Tuple[float, Optional[np.ndarray]]:
        """Advance one tick of the control plane.

        ``queued_cost``/``cap_rps`` are the post-expiry backlog and the
        chaos-degraded (not breaker-scaled) per-rack capacities;
        ``dead`` the chaos down-unit counts (None without chaos).
        Returns ``(total_rps, tier_frac)``: the admitted fleet load to
        route this tick and the tier fractions of it (length
        ``n_tiers + 1``, last entry = untiered respill; ``None`` when
        admission is off or nothing flows)."""
        lw = self.lowered
        if lw.breaker_on:
            self._update_breakers(tick, queued_cost, cap_rps, dead)
        self.breaker_state_t.append(self.breaker_state.copy())
        scale = self.breaker_scale()
        if not lw.admission_on:
            self.shed_cost_t.append(0.0)
            return rps + respill_rps, None
        # fresh per-tier offered rps (last tier takes the exact
        # remainder so the split conserves the trace bitwise)
        fresh = np.empty(lw.n_tiers)
        acc = 0.0
        for k in range(lw.n_tiers - 1):
            fresh[k] = lw.shares[k] * rps
            acc += fresh[k]
        fresh[lw.n_tiers - 1] = rps - acc
        # release this tick's retry slot (mass -> rps)
        slot = tick % lw.ring_slots
        released = self.ring[slot].copy()
        self.ring[slot] = 0.0
        # estimated fleet queueing delay on breaker-scaled capacity
        cap_total = 0.0
        for r in range(lw.n_racks):
            cap_total += float(cap_rps[r] * scale[r])
        queued_total = 0.0
        for r in range(lw.n_racks):
            queued_total += float(queued_cost[r])
        est_delay = queued_total / max(cap_total, _CAP_EPS)
        # the jitter draw is lazy: a tick that sheds nothing never
        # touches the rng (the no-shed fast path stays cheap)
        dticks: Optional[np.ndarray] = None
        admitted = np.zeros(lw.n_tiers)
        shed_now = 0.0
        for k in range(lw.n_tiers):
            rel_rps = 0.0
            for a in range(lw.retry.max_attempts):
                rel_rps += float(released[k, a]) / self.dt_s
            if est_delay <= lw.budgets[k] and cap_total > _CAP_EPS:
                admitted[k] = fresh[k] + rel_rps
                continue
            if dticks is None:
                dticks = lw.retry_dticks(tick)
            # shed at the door: fresh mass at attempt 0, released mass
            # at its own attempt; schedule retries within the budget
            shed_mass = fresh[k] * self.dt_s
            self.shed_by_tier[k] += shed_mass
            shed_now += shed_mass
            self._schedule(tick, k, 0, shed_mass, dticks)
            for a in range(lw.retry.max_attempts):
                mass = float(released[k, a])
                if mass > 0.0:
                    self.shed_by_tier[k] += mass
                    shed_now += mass
                    self._schedule(tick, k, a, mass, dticks)
        self.shed_cost_t.append(shed_now)
        total = 0.0
        for k in range(lw.n_tiers):
            total += float(admitted[k])
        total += respill_rps
        if total <= 0.0:
            return 0.0, None
        frac = np.empty(lw.n_tiers + 1)
        for k in range(lw.n_tiers):
            frac[k] = admitted[k] / total
        frac[lw.n_tiers] = respill_rps / total
        return total, frac

    def _schedule(
        self,
        tick: int,
        tier: int,
        attempt: int,
        mass: float,
        dticks: np.ndarray,
    ) -> None:
        """Queue shed ``mass`` (whose submission attempt ``attempt``
        just failed) for its next attempt, or drop it when the retry
        budget is spent — the budget is what makes retry storms
        impossible by construction."""
        lw = self.lowered
        if mass <= 0.0:
            return
        if attempt + 1 >= lw.retry.max_attempts:
            self.retry_dropped_cost += mass
            return
        slot = (tick + int(dticks[attempt])) % lw.ring_slots
        self.ring[slot, tier, attempt + 1] += mass
        self.retried_cost += mass


def tier_latency_percentiles(
    tel: "FleetTelemetry", tier: str, qs: Sequence[float] = (50.0, 99.0)
) -> Dict[float, float]:
    """Latency percentiles over one tier's completions. Scalar/vector
    backends tag each sub-request's payload with its tier name; the
    jax backend rebuilds the same tier-tagged sub-requests host-side
    and agrees within its documented tolerances (see module
    docstring). Returns ``{q: percentile_s}``; zeros when the tier
    completed nothing."""
    lats: List[float] = []
    for rack_tel in tel.per_rack:
        for resp in rack_tel.responses:
            if resp.output == tier:
                lats.append(float(resp.latency_s))
    if not lats:
        return {float(q): 0.0 for q in qs}
    arr = np.asarray(lats, float)
    return {float(q): float(np.percentile(arr, q)) for q in qs}
