"""``repro_torch.fleet`` — fleet-scale simulation: N racks behind a router.

The paper measures one 60-SoC rack; this layer aggregates many such
racks behind a geo-routed load balancer so the energy-proportionality
claims can be evaluated at the scale public edge platforms run at
("millions of users"):

  * :class:`~repro_torch.fleet.fleet.Fleet` — N racks (mixed
    :class:`~repro_torch.core.cluster.ClusterSpec`\\ s allowed), one offered
    load, tick-by-tick routing + per-rack elastic unit governors; three
    engines behind ``backend="scalar" | "vector" | "jax"`` — the first
    two bitwise-identical, the jitted jax engine tolerance-matched;
  * :mod:`~repro_torch.fleet.jax_engine` — ``jax.lax.scan`` engine plus the
    batched :func:`~repro_torch.fleet.jax_engine.sweep` entry point that
    ``vmap``\\ s whole fig15-style config grids into one XLA program;
  * :mod:`~repro_torch.fleet.router` — round-robin, join-shortest-queue
    (water-fill), and power-aware (efficiency-packed) request routers;
  * :mod:`~repro_torch.fleet.chaos` — correlated fault injection (rack/unit
    kills, shared-fan-rail failure, rack power caps) with recovery
    metrics and seeded random schedules for the CI chaos gate;
  * :mod:`~repro_torch.fleet.degrade` — graceful-degradation control plane:
    SLO-tiered admission, deadline load shedding, per-rack circuit
    breakers, and deterministic seeded retry, wired identically
    through all three engines;
  * :mod:`~repro_torch.fleet.traces` — diurnal, flash-crowd, and replayed
    arrival traces, scalable to a target user population;
  * :class:`~repro_torch.fleet.telemetry.FleetTelemetry` — fleet roll-ups
    feeding the existing energy/TCO models.

Typical use::

    from repro_torch.core.cluster import soc_cluster
    from repro_torch.fleet import (Fleet, PowerAwareRouter, diurnal_trace,
                             homogeneous_fleet, scale_to_users)

    racks = homogeneous_fleet(soc_cluster(), n_racks=100, unit_rate=30.0)
    fleet = Fleet(racks, router=PowerAwareRouter(), dt_s=60.0)
    trace = scale_to_users(diurnal_trace(peak_rps=1.0, hours=24),
                           users=3e6, rps_per_user=0.05)
    tel = fleet.play_trace(trace)
    print(tel.summary())
"""
from typing import Any

from repro_torch.fleet.chaos import (
    ChaosEvent,
    ChaosMonitor,
    ChaosSchedule,
    RecoveryReport,
    chaos_seed,
    hedging_delta,
    recovery_report,
    recovery_window_p99,
)
from repro_torch.fleet.degrade import (
    BreakerConfig,
    DegradePolicy,
    TierSpec,
    default_tiers,
    tier_latency_percentiles,
)
from repro_torch.fleet.fleet import Fleet, RackConfig, homogeneous_fleet
from repro_torch.fleet.router import (
    ROUTERS,
    FleetView,
    JoinShortestQueueRouter,
    PowerAwareRouter,
    RoundRobinRouter,
    Router,
)
from repro_torch.fleet.telemetry import FleetTelemetry, empirical_proportionality
from repro_torch.fleet.traces import (
    diurnal_trace,
    flash_crowd_trace,
    replay_trace,
    save_trace,
    scale_to_users,
)

def __getattr__(name: str) -> Any:
    # lazy: the torch sweep surface pulls in torch, which the
    # scalar/vector backends must not depend on
    if name in ("SweepConfig", "sweep"):
        from repro_torch.fleet import torch_engine

        return getattr(torch_engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Fleet",
    "RackConfig",
    "homogeneous_fleet",
    "ChaosEvent",
    "ChaosSchedule",
    "ChaosMonitor",
    "RecoveryReport",
    "chaos_seed",
    "TierSpec",
    "BreakerConfig",
    "DegradePolicy",
    "default_tiers",
    "tier_latency_percentiles",
    "hedging_delta",
    "recovery_report",
    "recovery_window_p99",
    "SweepConfig",
    "sweep",
    "Router",
    "FleetView",
    "RoundRobinRouter",
    "JoinShortestQueueRouter",
    "PowerAwareRouter",
    "ROUTERS",
    "FleetTelemetry",
    "empirical_proportionality",
    "diurnal_trace",
    "flash_crowd_trace",
    "replay_trace",
    "save_trace",
    "scale_to_users",
]
