"""Unified request/response/telemetry model for the cluster runtime.

One result vocabulary for everything that serves requests on a
:class:`~repro_torch.core.cluster.ClusterSpec` — the discrete-event scheduler
simulation, the live continuous-batching LM engine, and the data-driven
DL-serving/transcoding workloads. Replaces the two near-duplicate structs
the seed repo grew (``core.scheduler.SimResult`` and
``serving.autoscaler.AutoscalerReport``), which survive as aliases /
thin shims of :class:`Telemetry`.

Paper mapping: ``Telemetry.tpe`` is the paper's headline
throughput-per-energy metric (Fig 6, Fig 11b); ``active_units`` /
``mean_active`` is the §5.2 per-unit activation trace (Fig 12).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class Request:
    """A unit of offered work, workload-agnostic.

    ``payload`` is interpreted by the workload adapter (an LM prompt, a
    batch of inference samples, a video segment, ...); ``cost`` is the
    abstract amount of work in the workload's own capacity units (tokens,
    samples, stream-seconds).
    """

    payload: Any = None
    cost: float = 1.0
    # None = unset; stamped by the runtime (or the workload) at submit.
    # 0.0 is a valid timestamp, not a sentinel.
    arrival_s: Optional[float] = None
    rid: int = -1
    meta: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Response:
    """Completion record for one request."""

    rid: int
    arrival_s: float
    finish_s: float
    output: Any = None
    ok: bool = True

    @property
    def latency_s(self) -> float:
        return max(self.finish_s - self.arrival_s, 0.0)


@dataclass
class StepStats:
    """What one runtime tick did.

    The workload fills in the work-side fields from ``step()``; the
    runtime augments with the activation / power side before handing the
    tick back to the caller.
    """

    t: float = 0.0
    dt_s: float = 1.0
    # work side (from Workload.step)
    concurrency: int = 0          # requests actually in flight this tick
    admitted: int = 0             # requests newly admitted this tick
    completed: int = 0            # requests finished this tick
    queued: int = 0               # still waiting after the tick
    work_done: float = 0.0        # cost units processed this tick
    utilization: float = 0.0      # fraction of powered capacity used
    units_used: int = 0           # units the work actually occupied
    #   (0 = same as the granted target; can exceed it transiently when
    #   in-flight requests outlive a scale-down — the runtime then powers
    #   and charges the overflow units too)
    responses: List[Response] = field(default_factory=list)
    #   per-tick observational view only: the runtime delivers responses
    #   into Telemetry exactly once, via Workload.drain()
    # activation / power side (from the runtime tick)
    target_units: int = 0         # policy's activation target
    active_units: int = 0         # units actually powered this tick
    hedge_units: int = 0          # units borrowed for straggler hedging
    perf_scale: float = 1.0       # mean DVFS perf multiplier of the
    #   tenant's active units (1.0 when no OPP table is configured)
    power_w: float = 0.0
    energy_j: float = 0.0         # cumulative runtime energy after the tick


@dataclass
class Telemetry:
    """The one result struct for a serving run (real or simulated).

    Superset of the seed repo's ``SimResult`` (trace arrays, latency
    percentiles, hedging) and ``AutoscalerReport`` (tick counts, scale
    events, TpE), so both survive as aliases of this class.
    """

    time_s: np.ndarray = field(default_factory=lambda: np.zeros(0))
    offered_load: np.ndarray = field(default_factory=lambda: np.zeros(0))
    active_units: np.ndarray = field(default_factory=lambda: np.zeros(0))
    power_w: np.ndarray = field(default_factory=lambda: np.zeros(0))
    utilization: np.ndarray = field(default_factory=lambda: np.zeros(0))
    served: float = 0.0           # requests completed
    dropped: float = 0.0
    hedged: int = 0
    scale_events: int = 0
    p50_latency_s: float = 0.0
    p99_latency_s: float = 0.0
    energy_j: float = 0.0
    responses: List[Response] = field(default_factory=list)
    workload: Dict[str, Any] = field(default_factory=dict)
    # multi-tenant views (paper §2/§4-5: one cluster, many workloads).
    # For a per-tenant Telemetry, `tenant` is the tenant name and
    # `energy_j` holds only the tenant-attributable unit energy (shared
    # infrastructure power is charged once, at the cluster roll-up).
    tenant: str = ""
    unit_energy_j: float = 0.0    # sum of tenant-attributed unit energy
    per_tenant: Dict[str, "Telemetry"] = field(default_factory=dict)
    # thermal per-tick series (empty unless a thermal model is attached):
    # hottest die, number of trip-latched units, and fan power per tick
    max_temp_c: np.ndarray = field(default_factory=lambda: np.zeros(0))
    throttled_units: np.ndarray = field(default_factory=lambda: np.zeros(0))
    fan_power_w: np.ndarray = field(default_factory=lambda: np.zeros(0))

    # ----- derived ---------------------------------------------------------
    @property
    def ticks(self) -> int:
        return int(len(self.time_s))

    @property
    def duration_s(self) -> float:
        """Covered time: span of tick starts plus the final tick's width
        (taken from the last *actual* delta, so non-uniform tick spacing
        — e.g. stitched traces — is measured correctly)."""
        if len(self.time_s) < 1:
            return 0.0
        if len(self.time_s) == 1:
            return 1.0
        last_dt = self.time_s[-1] - self.time_s[-2]
        return float(self.time_s[-1] - self.time_s[0] + last_dt)

    @property
    def mean_active(self) -> float:
        return float(np.mean(self.active_units)) if len(self.active_units) \
            else 0.0

    @property
    def mean_power_w(self) -> float:
        return float(np.mean(self.power_w)) if len(self.power_w) else 0.0

    @property
    def throughput(self) -> float:
        """Requests per second over the run."""
        return self.served / max(self.duration_s, 1e-9)

    @property
    def tpe(self) -> float:
        """Throughput per energy (requests/J) — the paper's TpE."""
        return self.served / max(self.energy_j, 1e-9)

    def summary(self) -> Dict[str, float]:
        return {
            "ticks": self.ticks,
            "served": self.served,
            "dropped": self.dropped,
            "mean_active": self.mean_active,
            "energy_j": self.energy_j,
            "tpe": self.tpe,
            "throughput_rps": self.throughput,
            "p50_latency_s": self.p50_latency_s,
            "p99_latency_s": self.p99_latency_s,
            "scale_events": self.scale_events,
            "hedged": self.hedged,
        }


def latency_percentiles(responses: List[Response]
                        ) -> "tuple[float, float]":
    """(p50, p99) request latency over a response list."""
    if not responses:
        return 0.0, 0.0
    lat = np.array([r.latency_s for r in responses])
    return (float(np.percentile(lat, 50)), float(np.percentile(lat, 99)))
