"""Fleet-level telemetry roll-ups.

:class:`FleetTelemetry` aggregates per-rack
:class:`~repro_torch.runtime.result.Telemetry` into the fleet view the paper's
claims are made at — total power tracking total offered load — and
feeds the existing energy/TCO models: :meth:`energy_report` produces a
:class:`repro_torch.core.energy.EnergyReport` and
:meth:`monthly_electricity_usd` prices the run with the
``repro_torch.core.tco`` constants (EIA rate x PUE).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, List, Optional

import numpy as np

from repro_torch.core.energy import EnergyReport
from repro_torch.core.tco import ELECTRICITY_USD_PER_KWH, PUE_EDGE
from repro_torch.runtime.result import Telemetry

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from repro_torch.fleet.chaos import RecoveryReport

__all__ = ["FleetTelemetry", "empirical_proportionality"]


def empirical_proportionality(offered: np.ndarray, power_w: np.ndarray) -> float:
    """1 - mean |P/P_max - load/load_max| over a run's per-tick series —
    the trace-driven analogue of
    :func:`repro_torch.core.energy.proportionality_index` (which scores the
    *model* curve; this scores what a run actually did)."""
    offered = np.asarray(offered, float)
    power_w = np.asarray(power_w, float)
    if len(offered) == 0 or power_w.max() <= 0 or offered.max() <= 0:
        return 0.0
    load = offered / offered.max()
    p = power_w / power_w.max()
    return float(1.0 - np.mean(np.abs(p - load)))  # reprolint: ok[RPL001] post-hoc analysis metric over finished telemetry; not part of the bitwise parity surface


@dataclass
class FleetTelemetry:
    """One fleet run: per-rack series plus fleet roll-ups."""

    time_s: np.ndarray  # (ticks,)
    offered_rps: np.ndarray  # (ticks,) fleet offered load
    assigned_rps: np.ndarray  # (racks, ticks) router shards
    active_units: np.ndarray  # (racks, ticks)
    power_w: np.ndarray  # (racks, ticks) rack power incl. shared rail
    queued: np.ndarray  # (racks, ticks) requests waiting after the tick
    served: float
    energy_j: float
    p50_latency_s: float
    p95_latency_s: float
    p99_latency_s: float
    per_rack: List[Telemetry] = field(default_factory=list)
    rack_names: List[str] = field(default_factory=list)
    router: str = ""
    backend: str = "scalar"
    wall_s: float = 0.0
    # False when the post-trace drain hit its safety cap with backlog
    # still queued (sustained overload): served < offered and the
    # latency percentiles cover completed requests only.
    drained: bool = True
    # SLO alert windows (repro_torch.obs.slo.Alert), filled by Fleet when an
    # obs config with an slo policy is attached; empty otherwise
    alerts: List[Any] = field(default_factory=list)
    # chaos (filled by Fleet when a ChaosSchedule is wired; defaults
    # otherwise): the schedule's event records, the full-rack-kill queue
    # accounting (drop/respill per ChaosSchedule.on_kill), and the
    # post-hoc recovery metrics (repro_torch.fleet.chaos.recovery_report)
    chaos_events: List[Dict[str, Any]] = field(default_factory=list)
    dropped_requests: int = 0
    dropped_cost: float = 0.0
    respilled_requests: int = 0
    respilled_cost: float = 0.0
    recovery: Optional["RecoveryReport"] = None
    # graceful degradation (filled by Fleet when a DegradePolicy is
    # wired; defaults otherwise). Conservation with degradation on:
    # injected = served + queued + expired + retry_dropped + dropped.
    degrade_on: bool = False
    shed_cost: float = 0.0  # total mass shed at the admission door
    shed_by_tier: Dict[str, float] = field(default_factory=dict)
    shed_cost_t: np.ndarray = field(  # (ticks,) per-tick shed mass
        default_factory=lambda: np.zeros(0))
    expired_requests: int = 0  # queued work abandoned past deadline
    expired_cost: float = 0.0
    retried_cost: float = 0.0  # shed mass re-submitted after backoff
    retry_dropped_cost: float = 0.0  # retry budget exhausted
    breaker_opens: int = 0
    breaker_state_t: np.ndarray = field(  # (racks, ticks) int state codes
        default_factory=lambda: np.zeros((0, 0), np.int64))
    breaker_events: List[Dict[str, Any]] = field(default_factory=list)

    # ----- derived ---------------------------------------------------------
    @property
    def n_racks(self) -> int:
        return int(self.power_w.shape[0])

    @property
    def ticks(self) -> int:
        return int(len(self.time_s))

    @property
    def duration_s(self) -> float:
        """Covered time: span of tick starts plus the final tick's width
        (taken from the last *actual* delta, so non-uniform tick spacing
        — e.g. stitched traces — is measured correctly)."""
        if self.ticks < 1:
            return 0.0
        if self.ticks == 1:
            return 1.0
        last_dt = self.time_s[-1] - self.time_s[-2]
        return float(self.time_s[-1] - self.time_s[0] + last_dt)

    @property
    def total_power_w(self) -> np.ndarray:
        """Fleet power per tick (sum over racks)."""
        return self.power_w.sum(axis=0)  # reprolint: ok[RPL001] roll-up over *finished* per-rack series; both engines produce identical power_w, so identical inputs give identical sums

    @property
    def mean_power_w(self) -> float:
        return float(self.total_power_w.mean()) if self.ticks else 0.0  # reprolint: ok[RPL001] roll-up-only display metric computed after the run; identical inputs in both engines

    @property
    def peak_power_w(self) -> float:
        return float(self.total_power_w.max()) if self.ticks else 0.0

    @property
    def mean_active_units(self) -> float:
        if not self.ticks:
            return 0.0
        return float(self.active_units.sum(axis=0).mean())  # reprolint: ok[RPL001] roll-up-only display metric; active_units is an integer-valued series, the sum is exact

    @property
    def throughput(self) -> float:
        return self.served / max(self.duration_s, 1e-9)

    @property
    def tpe(self) -> float:
        """Requests per joule — the paper's TpE, fleet-wide."""
        return self.served / max(self.energy_j, 1e-9)

    @property
    def energy_kwh(self) -> float:
        return self.energy_j / 3.6e6

    def proportionality(self) -> float:
        """How closely fleet power tracked fleet offered load."""
        return empirical_proportionality(self.offered_rps, self.total_power_w)

    # ----- bridges into the existing energy/TCO models ---------------------
    def energy_report(self) -> EnergyReport:
        return EnergyReport(
            joules=self.energy_j,
            avg_power_w=self.mean_power_w,
            peak_power_w=self.peak_power_w,
            items=self.served,
            tpe=self.tpe,
            proportionality=self.proportionality(),
        )

    def monthly_electricity_usd(self, pue: float = PUE_EDGE) -> float:
        """Extrapolate the run's average power to a 30-day electricity
        bill at the ``core.tco`` EIA rate, including PUE overhead."""
        monthly_kwh = self.mean_power_w * 24 * 30 / 1000.0
        return monthly_kwh * ELECTRICITY_USD_PER_KWH * pue

    def summary(self) -> Dict[str, float]:
        out = {
            "racks": self.n_racks,
            "ticks": self.ticks,
            "served": self.served,
            "energy_kwh": self.energy_kwh,
            "tpe": self.tpe,
            "mean_power_w": self.mean_power_w,
            "peak_power_w": self.peak_power_w,
            "mean_active_units": self.mean_active_units,
            "p50_latency_s": self.p50_latency_s,
            "p95_latency_s": self.p95_latency_s,
            "p99_latency_s": self.p99_latency_s,
            "proportionality": self.proportionality(),
            "monthly_electricity_usd": self.monthly_electricity_usd(),
            "wall_s": self.wall_s,
            "drained": float(self.drained),
            "alerts": float(len(self.alerts)),
        }
        if self.chaos_events:
            out["chaos_events"] = float(len(self.chaos_events))
            out["dropped_requests"] = float(self.dropped_requests)
            out["respilled_requests"] = float(self.respilled_requests)
            rec = self.recovery
            if rec is not None:
                out["recovery_p99_blowup"] = rec.p99_blowup
                out["reconvergence_ticks"] = (
                    float(rec.reconvergence_ticks)
                    if rec.reconvergence_ticks is not None
                    else -1.0
                )
        if self.degrade_on:
            out["shed_cost"] = self.shed_cost
            out["expired_cost"] = self.expired_cost
            out["retried_cost"] = self.retried_cost
            out["retry_dropped_cost"] = self.retry_dropped_cost
            out["breaker_opens"] = float(self.breaker_opens)
            for tier, cost in self.shed_by_tier.items():
                out[f"shed_{tier}"] = cost
        return out
