"""SLO burn-rate alerting over fleet telemetry, streaming or post-hoc.

Rules consume one tick at a time (``SloPolicy.on_tick``) so a live
driver can alert mid-run; ``SloPolicy.evaluate`` replays a finished
:class:`~repro_torch.fleet.telemetry.FleetTelemetry` through the *same*
streaming path, so both modes share one code path and produce
identical alerts. ``Fleet`` attaches the post-hoc result to
``FleetTelemetry.alerts`` when an :class:`~repro_torch.obs.FleetObs` with an
``slo`` policy is configured.

Consecutive violating ticks merge into one :class:`Alert` window
carrying the worst observed value. Rules are deterministic functions
of the telemetry — no wall clock, no randomness — so alert lists are
reproducible run to run.
"""
from __future__ import annotations

from bisect import insort
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Alert", "SloRule", "LatencyBurnRule", "EnergyBudgetRule",
           "ThrottleStormRule", "QueueBlowupRule", "ShedStormRule",
           "SloPolicy"]


@dataclass
class Alert:
    """One violation window of one rule."""

    rule: str
    severity: str
    t_start: float
    t_end: float          # end of the last violating tick
    worst_value: float
    threshold: float
    message: str

    def to_record(self) -> Dict[str, Any]:
        return {"rule": self.rule, "severity": self.severity,
                "t_start": self.t_start, "t_end": self.t_end,
                "worst_value": self.worst_value,
                "threshold": self.threshold, "message": self.message}


class SloRule:
    """Streaming rule: ``observe`` one tick, return the violating
    ``(value, threshold)`` pair or ``None``. ``reset`` clears run
    state so one rule instance can evaluate many runs."""

    name = "rule"
    severity = "warning"
    #: human-readable unit of ``value`` for alert messages
    unit = ""

    def reset(self) -> None:
        """Clear per-run state (override when the rule keeps any)."""

    def observe(self, t: float, dt_s: float,
                tick: Mapping[str, Any]) -> Optional[Tuple[float, float]]:
        raise NotImplementedError


class LatencyBurnRule(SloRule):
    """Rolling p95 request latency vs target over a sliding window.

    Completions stream in via ``tick["responses"]``; the window holds
    ``(finish_s, latency_s)`` of every completion in the last
    ``window_s`` seconds. Fires once at least ``min_count`` requests
    are in the window and their p95 exceeds ``target_s``.
    """

    name = "latency_burn"
    severity = "critical"
    unit = "s"

    def __init__(self, target_s: float, window_s: float = 3600.0,
                 min_count: int = 10) -> None:
        self.target_s = float(target_s)
        self.window_s = float(window_s)
        self.min_count = int(min_count)
        self._win: List[Tuple[float, float]] = []

    def reset(self) -> None:
        self._win = []

    def observe(self, t: float, dt_s: float,
                tick: Mapping[str, Any]) -> Optional[Tuple[float, float]]:
        for resp in tick.get("responses", ()):
            # keep the window sorted by finish time: responses from
            # different racks arrive interleaved
            insort(self._win, (float(resp.finish_s), float(resp.latency_s)))
        horizon = t + dt_s - self.window_s
        drop = 0
        for fin, _lat in self._win:
            if fin >= horizon:
                break
            drop += 1
        if drop:
            del self._win[:drop]
        if len(self._win) < self.min_count:
            return None
        lats = np.array([lat for _fin, lat in self._win])
        p95 = float(np.percentile(lats, 95))
        if p95 > self.target_s:
            return p95, self.target_s
        return None


class EnergyBudgetRule(SloRule):
    """Energy-budget burn rate: cumulative joules vs the prorated
    budget. A burn rate of 1.0 means "on budget for the horizon";
    fires when it exceeds ``max_burn`` after ``min_elapsed_s``."""

    name = "energy_budget_burn"
    severity = "warning"
    unit = "x budget"

    def __init__(self, budget_j: float, horizon_s: float,
                 max_burn: float = 1.0, min_elapsed_s: float = 0.0) -> None:
        self.budget_j = float(budget_j)
        self.horizon_s = float(horizon_s)
        self.max_burn = float(max_burn)
        self.min_elapsed_s = float(min_elapsed_s)
        self._energy_j = 0.0
        self._elapsed_s = 0.0

    def reset(self) -> None:
        self._energy_j = 0.0
        self._elapsed_s = 0.0

    def observe(self, t: float, dt_s: float,
                tick: Mapping[str, Any]) -> Optional[Tuple[float, float]]:
        power = np.asarray(tick["power_w"], float)
        self._energy_j += float(power.sum()) * dt_s  # reprolint: ok[RPL001] alerting roll-up, never enters the parity-compared telemetry
        self._elapsed_s += dt_s
        if self._elapsed_s < max(self.min_elapsed_s, dt_s):
            return None
        prorated = self.budget_j * (self._elapsed_s / self.horizon_s)
        burn = self._energy_j / prorated if prorated > 0 else 0.0
        if burn > self.max_burn:
            return burn, self.max_burn
        return None


class ThrottleStormRule(SloRule):
    """Fleet-wide trip-latched die count above a ceiling — a thermal
    storm where capacity silently degrades to the floor OPP."""

    name = "throttle_storm"
    severity = "critical"
    unit = "units"

    def __init__(self, max_throttled_units: int = 0) -> None:
        self.max_throttled_units = int(max_throttled_units)

    def observe(self, t: float, dt_s: float,
                tick: Mapping[str, Any]) -> Optional[Tuple[float, float]]:
        thr = tick.get("throttled_units")
        if thr is None:
            return None
        total = int(np.asarray(thr).sum())  # reprolint: ok[RPL001] int64 counts: integer addition is exact in any order
        if total > self.max_throttled_units:
            return float(total), float(self.max_throttled_units)
        return None


class QueueBlowupRule(SloRule):
    """Total queued requests above a ceiling — offered load outrunning
    activation (or a router hot-spotting one rack)."""

    name = "queue_blowup"
    severity = "warning"
    unit = "requests"

    def __init__(self, max_queued: int) -> None:
        self.max_queued = int(max_queued)

    def observe(self, t: float, dt_s: float,
                tick: Mapping[str, Any]) -> Optional[Tuple[float, float]]:
        queued = tick.get("queued")
        if queued is None:
            return None
        total = int(np.asarray(queued).sum())  # reprolint: ok[RPL001] int64 counts: integer addition is exact in any order
        if total > self.max_queued:
            return float(total), float(self.max_queued)
        return None


class ShedStormRule(SloRule):
    """Admission-shed burn rate above a ceiling: mean shed rps over a
    sliding window vs ``max_shed_rps``. Graceful degradation is
    supposed to shed *briefly* under a flash crowd — a sustained shed
    rate means the fleet is underprovisioned (or a breaker is stuck
    open) and operators should know. Reads the per-tick ``shed_cost``
    the degrade control plane emits; inert on fleets without one."""

    name = "shed_storm"
    severity = "critical"
    unit = "rps"

    def __init__(self, max_shed_rps: float, window_s: float = 3600.0) -> None:
        self.max_shed_rps = float(max_shed_rps)
        self.window_s = float(window_s)
        self._win: List[Tuple[float, float]] = []

    def reset(self) -> None:
        self._win = []

    def observe(self, t: float, dt_s: float,
                tick: Mapping[str, Any]) -> Optional[Tuple[float, float]]:
        shed = tick.get("shed_cost")
        if shed is None:
            return None
        self._win.append((t, float(shed)))
        horizon = t + dt_s - self.window_s
        drop = 0
        for tw, _mass in self._win:
            if tw >= horizon:
                break
            drop += 1
        if drop:
            del self._win[:drop]
        span = len(self._win) * dt_s
        if span <= 0.0:
            return None
        total = 0.0
        for _tw, mass in self._win:
            total += mass
        rate = total / span
        if rate > self.max_shed_rps:
            return rate, self.max_shed_rps
        return None


class _OpenWindow:
    __slots__ = ("t_start", "t_end", "worst", "threshold")

    def __init__(self, t: float, dt_s: float, value: float,
                 threshold: float) -> None:
        self.t_start = t
        self.t_end = t + dt_s
        self.worst = value
        self.threshold = threshold


class SloPolicy:
    """A set of rules evaluated in lockstep, merging violation windows.

    Streaming: call ``on_tick`` per tick, then ``finalize`` to close
    any still-open windows. Post-hoc: ``evaluate(telemetry)`` replays
    a finished run through the same path.
    """

    def __init__(self, rules: Sequence[SloRule]) -> None:
        self.rules = list(rules)
        self._open: Dict[str, _OpenWindow] = {}
        self._alerts: List[Alert] = []

    def reset(self) -> None:
        for rule in self.rules:
            rule.reset()
        self._open = {}
        self._alerts = []

    def _close(self, rule: SloRule, win: _OpenWindow) -> None:
        self._alerts.append(Alert(
            rule=rule.name, severity=rule.severity,
            t_start=win.t_start, t_end=win.t_end,
            worst_value=win.worst, threshold=win.threshold,
            message=(f"{rule.name}: worst {win.worst:.4g} {rule.unit} "
                     f"vs threshold {win.threshold:.4g} {rule.unit} over "
                     f"[{win.t_start:.0f}s, {win.t_end:.0f}s)"),
        ))

    def on_tick(self, t: float, dt_s: float,
                tick: Mapping[str, Any]) -> None:
        """Feed one tick. ``tick`` carries per-rack arrays (power_w,
        queued, throttled_units where available) plus the tick's newly
        completed ``responses``."""
        for rule in self.rules:
            hit = rule.observe(t, dt_s, tick)
            win = self._open.get(rule.name)
            if hit is not None:
                value, threshold = hit
                if win is None:
                    self._open[rule.name] = _OpenWindow(
                        t, dt_s, value, threshold)
                else:
                    win.t_end = t + dt_s
                    win.worst = max(win.worst, value)
            elif win is not None:
                self._close(rule, self._open.pop(rule.name))

    def finalize(self) -> List[Alert]:
        """Close open windows and return every alert, in time order."""
        for rule in self.rules:
            win = self._open.pop(rule.name, None)
            if win is not None:
                self._close(rule, win)
        self._alerts.sort(key=lambda a: (a.t_start, a.rule))
        return list(self._alerts)

    def evaluate(self, tel: Any) -> List[Alert]:
        """Post-hoc: replay a :class:`FleetTelemetry` through the
        streaming path (responses bucketed into their finish tick)."""
        self.reset()
        times = np.asarray(tel.time_s, float)
        ticks = len(times)
        if ticks == 0:
            return []
        dt = float(times[1] - times[0]) if ticks > 1 else 1.0
        # bucket completions by finish tick; clamp strays into range
        buckets: List[List[Any]] = [[] for _ in range(ticks)]
        for rack_tel in tel.per_rack:
            for resp in rack_tel.responses:
                i = int(np.searchsorted(times, resp.finish_s, side="right")) - 1
                buckets[min(max(i, 0), ticks - 1)].append(resp)
        thr_rows: Optional[np.ndarray] = None
        thr_cols = [
            (r, rack_tel.throttled_units)
            for r, rack_tel in enumerate(tel.per_rack)
            if len(rack_tel.throttled_units)
        ]
        if thr_cols:
            thr_rows = np.zeros((ticks, tel.n_racks))
            for r, col in thr_cols:
                thr_rows[:, r] = col
        shed_t = np.asarray(getattr(tel, "shed_cost_t", []), float)
        degrade_on = bool(getattr(tel, "degrade_on", False))
        for i in range(ticks):
            tick: Dict[str, Any] = {
                "power_w": tel.power_w[:, i],
                "queued": tel.queued[:, i],
                "responses": buckets[i],
            }
            if thr_rows is not None:
                tick["throttled_units"] = thr_rows[i]
            if degrade_on and i < len(shed_t):
                tick["shed_cost"] = float(shed_t[i])
            self.on_tick(float(times[i]), dt, tick)
        return self.finalize()
