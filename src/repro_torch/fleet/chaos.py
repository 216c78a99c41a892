"""Correlated fault injection for the fleet — chaos engineering (§8).

The paper calls fault tolerance "crucial for the success of SoC
Cluster": a 60-SoC rack must survive single-SoC death, and the
architecture is uniquely exposed to *correlated* failures no per-unit
model captures — a shared fan rail feeding a whole rack, a site power
cap forcing every die to the floor OPP at once. This module injects
exactly those faults mid-trace, identically into all three fleet
engines:

  * ``kill`` — a rack, a PCB group, or a fraction of units goes dark.
    Killed units are power-gated (they keep drawing the gated floor
    ``p_base``; chassis/shared/fan power stays up — an SoC-level
    failure, not a site outage). Kills are *count-granular*: the
    engines model units as interchangeable prefix counts, so "kill 20
    units" caps the rack's activation at ``n_units - 20`` rather than
    naming physical dies.
  * ``fan_fail`` — the rack's shared fan rail dies: airflow drops to
    zero (``fan_frac = 0``), the PCB-to-ambient resistance snaps to its
    no-airflow value, and throttling cascades through the RC network
    exactly as the thermal model dictates.
  * ``power_cap`` — a rack-level power cap pins every die at the floor
    OPP for the duration (the frequency governor keeps running but its
    choice is overridden, so state-free governors resume correctly on
    release).

Queue policy on a *full-rack* kill (``ChaosSchedule.on_kill``):

  * ``"respill"`` (default) — the dead rack's queue is evacuated and
    its cost re-offered through the router in the same tick, merged
    into the fleet-level offered load. Respilled requests restart their
    latency clock (the fluid queues aggregate per-tick arrivals, so
    original arrival stamps are not recoverable per request — and an
    operator-visible retry restarts the clock anyway). If no rack is
    alive to take them, the router assigns ~0 and the cost is lost.
  * ``"drop"`` — the queue is discarded and counted.

Either way the evacuated cost is credited in the sanitizer's
conservation check, and a dead rack serving requests is an invariant
violation ("resurrection") the sanitizer traps.

Parity contract: the masks produced here drive the scalar and vector
engines through the *same* schedule object, so scalar/vector stay
bitwise-identical under chaos; the jax engine lowers the schedule to
per-tick mask rows (``LoweredChaos.rows``) consumed inside
``lax.scan`` and rides the documented tolerance budgets.

Seed workflow: ``ChaosSchedule.random(..., seed=chaos_seed())`` reads
``REPRO_CHAOS_SEED`` (CI derives it from ``github.run_id`` and echoes
it to the step summary), so any red chaos run reproduces locally with
``REPRO_CHAOS_SEED=<n> pytest tests/test_chaos.py``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from repro_torch.distributed.fault import HealthTracker
    from repro_torch.fleet.fleet import RackConfig
    from repro_torch.fleet.router import Router
    from repro_torch.fleet.telemetry import FleetTelemetry

__all__ = [
    "ChaosEvent",
    "ChaosSchedule",
    "LoweredChaos",
    "ChaosMonitor",
    "RecoveryReport",
    "chaos_seed",
    "recovery_report",
    "recovery_window_p99",
    "hedging_delta",
]

KILL = "kill"
FAN_FAIL = "fan_fail"
POWER_CAP = "power_cap"
_KINDS = (KILL, FAN_FAIL, POWER_CAP)
_ON_KILL = ("respill", "drop")


def chaos_seed(default: int = 0) -> int:
    """The chaos seed for this process: ``REPRO_CHAOS_SEED`` env var
    (set by the CI chaos job from ``github.run_id``) or ``default``."""
    return int(os.environ.get("REPRO_CHAOS_SEED", default))


@dataclass(frozen=True)
class ChaosEvent:
    """One fault window ``[start_s, end_s)`` on one rack.

    ``units`` applies to ``kill`` events only: how many units are down
    (0 = the whole rack). Restoration is implicit at ``end_s``
    (``math.inf`` = never restored)."""

    kind: str
    rack: int
    start_s: float
    end_s: float = math.inf
    units: int = 0

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown chaos event kind {self.kind!r}")
        if not self.end_s > self.start_s:
            raise ValueError(
                f"empty chaos window [{self.start_s}, {self.end_s})"
            )

    def active(self, t: float) -> bool:
        return self.start_s <= t < self.end_s

    def to_record(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class ChaosSchedule:
    """A seeded, declarative fault plan; lower it against a fleet's
    per-rack unit counts to get tick-sampled masks."""

    events: List[ChaosEvent] = field(default_factory=list)
    on_kill: str = "respill"

    def __post_init__(self) -> None:
        if self.on_kill not in _ON_KILL:
            raise ValueError(
                f"on_kill must be one of {_ON_KILL}, got {self.on_kill!r}"
            )

    # -- builders ------------------------------------------------------
    def add(self, event: ChaosEvent) -> "ChaosSchedule":
        self.events.append(event)
        return self

    def kill_rack(
        self, rack: int, start_s: float, end_s: float = math.inf
    ) -> "ChaosSchedule":
        """The whole rack goes dark (queue evacuated per ``on_kill``)."""
        return self.add(ChaosEvent(KILL, rack, start_s, end_s, units=0))

    def kill_units(
        self, rack: int, units: int, start_s: float, end_s: float = math.inf
    ) -> "ChaosSchedule":
        """``units`` of the rack go dark (count-granular, see module
        docstring); the rack keeps serving on what is left."""
        if units <= 0:
            raise ValueError("kill_units needs units >= 1")
        return self.add(ChaosEvent(KILL, rack, start_s, end_s, units=units))

    def kill_group(
        self,
        rack: int,
        group_units: int,
        start_s: float,
        end_s: float = math.inf,
        groups: int = 1,
    ) -> "ChaosSchedule":
        """Kill ``groups`` PCB groups' worth of units (the paper's
        board-granular fail-out: one PCB takes its SoCs with it)."""
        return self.kill_units(rack, groups * group_units, start_s, end_s)

    def fail_fan(
        self, rack: int, start_s: float, end_s: float = math.inf
    ) -> "ChaosSchedule":
        """Shared fan rail failure: zero airflow into the rack's RC
        network for the window (no-op on racks without a thermal model)."""
        return self.add(ChaosEvent(FAN_FAIL, rack, start_s, end_s))

    def power_cap(
        self, rack: int, start_s: float, end_s: float = math.inf
    ) -> "ChaosSchedule":
        """Rack power cap: every die pinned at the floor OPP for the
        window (no-op on racks without an OPP table)."""
        return self.add(ChaosEvent(POWER_CAP, rack, start_s, end_s))

    # -- derived -------------------------------------------------------
    @property
    def fault_t(self) -> float:
        """Start of the earliest fault (``inf`` on an empty schedule)."""
        t = math.inf
        for ev in self.events:
            t = min(t, ev.start_s)
        return t

    def lower(self, n_units: Sequence[int]) -> "LoweredChaos":
        """Bind the schedule to a fleet (per-rack unit counts); kills
        clamp to the rack size, rack indices are validated here."""
        nu = np.asarray(n_units, np.int64)
        for ev in self.events:
            if not 0 <= ev.rack < len(nu):
                raise ValueError(
                    f"chaos event rack {ev.rack} out of range "
                    f"(fleet has {len(nu)} racks)"
                )
        return LoweredChaos(nu, list(self.events), self.on_kill)

    @classmethod
    def random(
        cls,
        n_racks: int,
        horizon_s: float,
        *,
        seed: int,
        n_events: int = 3,
        on_kill: str = "respill",
        kinds: Sequence[str] = _KINDS,
    ) -> "ChaosSchedule":
        """A seeded random schedule: ``n_events`` fault windows in the
        middle ~[10%, 90%] of the horizon so pre-fault baselines and
        post-fault recovery are both observable. Same seed, same
        schedule — the CI chaos job prints its seed for replay."""
        rng = np.random.default_rng(seed)
        sched = cls(on_kill=on_kill)
        for _ in range(n_events):
            kind = str(kinds[int(rng.integers(len(kinds)))])
            rack = int(rng.integers(n_racks))
            start = float(rng.uniform(0.1, 0.6) * horizon_s)
            dur = float(rng.uniform(0.05, 0.3) * horizon_s)
            end = min(start + dur, 0.9 * horizon_s)
            if kind == KILL:
                # half whole-rack kills, half partial (fraction of units,
                # resolved against the rack size at lower() time)
                units = 0 if rng.random() < 0.5 else int(rng.integers(1, 64))
                sched.add(ChaosEvent(KILL, rack, start, end, units=units))
            else:
                sched.add(ChaosEvent(kind, rack, start, end))
        return sched


class LoweredChaos:
    """A schedule bound to a fleet: pure time -> mask functions.

    Masks are sampled at tick *start* (the engines apply them before
    routing), so an event is visible on the first tick whose start
    falls inside its window. ``masks_at`` is what the scalar/vector
    drivers consume per tick; ``rows`` pre-samples a whole block of
    ticks for the jax engine's ``lax.scan``.
    """

    def __init__(
        self, n_units: np.ndarray, events: List[ChaosEvent], on_kill: str
    ) -> None:
        self.n_units = np.asarray(n_units, np.int64)
        self.events = list(events)
        self.on_kill = on_kill

    def masks_at(
        self, t: float
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(dead_units, fan_failed, power_capped)`` at sim time ``t``:
        int64 down-unit counts and two bool masks, each length
        n_racks. Overlapping kills take the max, not the sum — two
        events naming the same units must not double-kill."""
        n = len(self.n_units)
        dead = np.zeros(n, np.int64)
        fan = np.zeros(n, bool)
        cap = np.zeros(n, bool)
        for ev in self.events:
            if not ev.active(t):
                continue
            if ev.kind == KILL:
                d = (
                    int(self.n_units[ev.rack])
                    if ev.units <= 0
                    else min(ev.units, int(self.n_units[ev.rack]))
                )
                dead[ev.rack] = max(int(dead[ev.rack]), d)
            elif ev.kind == FAN_FAIL:
                fan[ev.rack] = True
            else:
                cap[ev.rack] = True
        return dead, fan, cap

    def rows(
        self, t0: float, n_ticks: int, dt_s: float
    ) -> Dict[str, np.ndarray]:
        """Per-tick mask rows for ticks ``t0, t0+dt, ...`` (the jax
        lowering): dead counts, fan/power-cap masks, plus the full-kill
        edge (newly fully-dead vs the previous tick) that triggers
        queue evacuation in-scan."""
        n = len(self.n_units)
        dead = np.zeros((n_ticks, n), np.int64)
        fan = np.zeros((n_ticks, n), bool)
        cap = np.zeros((n_ticks, n), bool)
        edge = np.zeros((n_ticks, n), bool)
        prev_full = self.masks_at(t0 - dt_s)[0] >= self.n_units
        for k in range(n_ticks):
            d, f, c = self.masks_at(t0 + k * dt_s)
            dead[k] = d
            fan[k] = f
            cap[k] = c
            full = d >= self.n_units
            edge[k] = full & ~prev_full
            prev_full = full
        return {"dead": dead, "fan_fail": fan, "power_cap": cap,
                "kill_edge": edge}

    def any_events(self) -> bool:
        return bool(self.events)


# ---------------------------------------------------------------------------
# Recovery metrics.
# ---------------------------------------------------------------------------
@dataclass
class RecoveryReport:
    """How the fleet rode out a chaos schedule.

    Re-convergence: ticks from the first fault until the rolling p95
    latency returns within ``within`` (default 10%) of its pre-fault
    baseline. ``p99_blowup`` is the worst rolling p99 during the
    recovery window over the pre-fault p99. ``None`` re-convergence
    means the run ended still degraded."""

    fault_t: float
    baseline_p95_s: float
    baseline_p99_s: float
    reconverged_t: Optional[float]
    reconvergence_ticks: Optional[int]
    p99_blowup: float
    dropped_requests: int = 0
    dropped_cost: float = 0.0
    respilled_requests: int = 0
    respilled_cost: float = 0.0

    def to_record(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _rolling_pct(
    times: np.ndarray,
    dt_s: float,
    fins: np.ndarray,
    lats: np.ndarray,
    window_ticks: int,
    q: float,
) -> np.ndarray:
    """Rolling latency percentile per tick: completions whose finish
    falls in the trailing ``window_ticks``-tick window ending at each
    tick's end. NaN where the window holds no completions."""
    out = np.full(len(times), np.nan)
    order = np.argsort(fins, kind="stable")
    fins = fins[order]
    lats = lats[order]
    for i, t in enumerate(times):
        hi = float(t) + dt_s
        lo = hi - window_ticks * dt_s
        a = int(np.searchsorted(fins, lo, side="left"))
        b = int(np.searchsorted(fins, hi, side="right"))
        if b > a:
            out[i] = float(np.percentile(lats[a:b], q))
    return out


def _completions(tel: "FleetTelemetry") -> Tuple[np.ndarray, np.ndarray]:
    fins: List[float] = []
    lats: List[float] = []
    for rack_tel in tel.per_rack:
        for resp in rack_tel.responses:
            fins.append(float(resp.finish_s))
            lats.append(float(resp.latency_s))
    return np.asarray(fins, float), np.asarray(lats, float)


def recovery_window_p99(tel: "FleetTelemetry", fault_t: float) -> float:
    """p99 latency over completions finishing at/after the first fault
    — the recovery-window tail the hedging-benefit delta compares."""
    fins, lats = _completions(tel)
    sel = lats[fins >= fault_t]
    if len(sel) == 0:
        return 0.0
    return float(np.percentile(sel, 99))


def recovery_report(
    tel: "FleetTelemetry",
    fault_t: float,
    *,
    within: float = 0.10,
    window_ticks: int = 5,
    dropped_requests: int = 0,
    dropped_cost: float = 0.0,
    respilled_requests: int = 0,
    respilled_cost: float = 0.0,
) -> RecoveryReport:
    """Post-hoc recovery metrics from finished telemetry (engine
    agnostic: only completions and tick times are consulted, so one
    implementation serves all three backends)."""
    times = np.asarray(tel.time_s, float)
    dt = float(times[1] - times[0]) if len(times) > 1 else 1.0
    fins, lats = _completions(tel)
    p95 = _rolling_pct(times, dt, fins, lats, window_ticks, 95.0)
    p99 = _rolling_pct(times, dt, fins, lats, window_ticks, 99.0)
    i_fault = int(np.searchsorted(times, fault_t, side="left"))
    base95 = base99 = math.nan
    for i in range(min(i_fault, len(times)) - 1, -1, -1):
        if not math.isnan(p95[i]):
            base95 = float(p95[i])
            base99 = float(p99[i])
            break
    reconverged_t: Optional[float] = None
    reconvergence_ticks: Optional[int] = None
    blowup = 1.0
    if not math.isnan(base95) and i_fault < len(times):
        thresh = base95 * (1.0 + within)
        # re-converged = the first tick after which the rolling p95
        # STAYS within tolerance. Scanning for the first in-tolerance
        # tick instead would report ~0 whenever the damage is lagged —
        # a fault's backlog only surfaces in completions finishing
        # (much) later, so the tick right after the fault often still
        # looks clean.
        i_conv: Optional[int] = i_fault
        for i in range(len(times) - 1, i_fault - 1, -1):
            if not math.isnan(p95[i]) and p95[i] > thresh:
                i_conv = i + 1 if i + 1 < len(times) else None
                break
        if i_conv is not None:
            reconverged_t = float(times[i_conv])
            reconvergence_ticks = i_conv - i_fault
        hi = (i_conv + 1) if i_conv is not None else len(times)
        window = p99[i_fault:hi]
        if len(window) and not bool(np.all(np.isnan(window))):
            worst = float(np.nanmax(window))
            if base99 > 0.0:
                blowup = worst / base99
    return RecoveryReport(
        fault_t=float(fault_t),
        baseline_p95_s=0.0 if math.isnan(base95) else base95,
        baseline_p99_s=0.0 if math.isnan(base99) else base99,
        reconverged_t=reconverged_t,
        reconvergence_ticks=reconvergence_ticks,
        p99_blowup=blowup,
        dropped_requests=dropped_requests,
        dropped_cost=dropped_cost,
        respilled_requests=respilled_requests,
        respilled_cost=respilled_cost,
    )


def hedging_delta(
    racks: Sequence["RackConfig"],
    trace: np.ndarray,
    schedule: ChaosSchedule,
    *,
    router: Optional["Router"] = None,
    dt_s: float = 60.0,
    backend: str = "vector",
) -> Dict[str, float]:
    """The hedging-benefit delta: the same chaos trace with hedging as
    configured vs ``hedge_after_s=None``, compared on recovery-window
    p99. Positive ``hedging_benefit_s`` = hedging cut the tail."""
    from repro_torch.fleet.fleet import Fleet

    def run(hedge: bool) -> "FleetTelemetry":
        cfgs = []
        for rc in racks:
            pol = rc.policy
            if not hedge and pol is not None and pol.hedge_after_s is not None:
                pol = dataclasses.replace(pol, hedge_after_s=None)
            cfgs.append(dataclasses.replace(rc, policy=pol))
        fleet = Fleet(
            cfgs, router=router, dt_s=dt_s, backend=backend, chaos=schedule
        )
        return fleet.play_trace(np.asarray(trace, float))

    fault_t = schedule.fault_t
    p_with = recovery_window_p99(run(True), fault_t)
    p_without = recovery_window_p99(run(False), fault_t)
    return {
        "recovery_p99_with_hedge_s": p_with,
        "recovery_p99_without_hedge_s": p_without,
        "hedging_benefit_s": p_without - p_with,
    }


# ---------------------------------------------------------------------------
# Sim-clocked failure detection (composes distributed.fault).
# ---------------------------------------------------------------------------
class ChaosMonitor:
    """Rack-level failure detection on the *simulation* clock.

    Wraps :class:`repro_torch.distributed.fault.HealthTracker` (one "unit"
    per rack) with an injected clock driven by the fleet's tick times —
    ``HealthTracker``'s default ``time.monotonic`` would silently mix
    wall time into sim-time timeout detection, making failed-rack sets
    depend on host speed. Racks that are not fully dead heartbeat every
    observed tick; a fully-dead rack stops heartbeating and crosses
    ``timeout_s`` of *sim* time later — tick-deterministic by
    construction (``tests/test_chaos.py``)."""

    def __init__(
        self,
        n_racks: int,
        timeout_s: float,
        straggler_factor: float = 2.0,
    ) -> None:
        # deferred import: keeps repro_torch.fleet importable without the
        # distributed subpackage and breaks a potential import cycle
        from repro_torch.distributed.fault import HealthTracker

        self._t = 0.0
        self.tracker: "HealthTracker" = HealthTracker(
            list(range(n_racks)),
            timeout_s=timeout_s,
            straggler_factor=straggler_factor,
            clock=lambda: self._t,
        )

    def observe(
        self, t: float, dead: np.ndarray, n_units: np.ndarray
    ) -> None:
        """One tick's liveness: advance the sim clock, heartbeat every
        rack that still has live units."""
        self._t = float(t)
        for r in range(len(n_units)):
            if int(dead[r]) < int(n_units[r]):
                self.tracker.heartbeat(r, 0.0)

    def failed_racks(self) -> List[int]:
        return self.tracker.failed_units()

    def failed_mask(self, n_racks: int) -> np.ndarray:
        """Boolean per-rack failure mask — the array form the
        degradation layer's circuit breakers consume (``degrade.py``
        mirrors this timeout in whole ticks so every engine agrees on
        the transition instant)."""
        mask = np.zeros(n_racks, bool)
        for r in self.failed_racks():
            if r < n_racks:
                mask[r] = True
        return mask
