"""Unified request-lifecycle runtime (paper §2, §4-5.2, Fig 11/12).

The one serving surface for the SoC-Cluster reproduction:

  * :class:`Request` / :class:`Response` / :class:`StepStats` /
    :class:`Telemetry` — the shared result model (also aliased by the
    deprecated ``core.scheduler.SimResult`` and
    ``serving.autoscaler.AutoscalerReport``); ``Telemetry`` carries
    per-tenant views under ``per_tenant``;
  * :class:`Workload` protocol with adapters :class:`LMServingWorkload`
    (live engine + continuous batcher), :class:`DLServingWorkload`
    (Fig 11/12 measured serving points), and
    :class:`TranscodingWorkload` (§4 / Table 3 stream counts);
  * :class:`UnitPool` — per-unit ``off → waking → active`` state over a
    ``ClusterSpec`` with PCB-group-aligned allocations and the cluster's
    single power integral (shared power charged once);
  * :class:`UnitGovernor` / :class:`ScalePolicy` — the activation policy
    engine (windowed rate → group-quantized target → wake/cooldown);
    with an :mod:`repro_torch.power` OPP table on the pool,
    ``ScalePolicy.freq_governor`` adds the frequency axis (activation
    count × operating point co-optimized per tick, thermal throttling
    via the pool's trip latches);
  * :class:`MultiTenantRuntime` — N tenants on one pool, weighted-fair
    arbitration with ``min_units`` floors, runtime-level straggler
    hedging;
  * :class:`ClusterRuntime` — the single-tenant facade: one
    ``ClusterSpec`` + ``ScalePolicy`` + ``Workload``, with the
    activation target *actually gating* workload concurrency.
"""
from repro_torch.runtime.cluster_runtime import ClusterRuntime
from repro_torch.runtime.multi_tenant import (MultiTenantRuntime, Tenant,
                                        weighted_fair_share)
from repro_torch.runtime.policy import ScalePolicy, UnitGovernor
from repro_torch.runtime.pool import (UnitPool, UnitState, VectorUnitPool,
                                make_unit_pool)
from repro_torch.runtime.result import (Request, Response, StepStats, Telemetry,
                                  latency_percentiles)
from repro_torch.runtime.sanitize import (FleetSanitizer, InvariantViolation,
                                    PoolSanitizer, attach_fleet_sanitizer,
                                    attach_pool_sanitizer, check_pool,
                                    sanitizer_enabled)
from repro_torch.runtime.workload import (DLServingWorkload, LMServingWorkload,
                                    QueueWorkload, TranscodingWorkload,
                                    Workload)

__all__ = [
    "ClusterRuntime", "MultiTenantRuntime", "Tenant",
    "weighted_fair_share", "UnitPool", "VectorUnitPool", "make_unit_pool",
    "UnitState", "UnitGovernor", "ScalePolicy",
    "Request", "Response", "StepStats", "Telemetry",
    "latency_percentiles",
    "Workload", "QueueWorkload", "DLServingWorkload", "LMServingWorkload",
    "TranscodingWorkload",
    "InvariantViolation", "PoolSanitizer", "FleetSanitizer",
    "attach_pool_sanitizer", "attach_fleet_sanitizer", "check_pool",
    "sanitizer_enabled",
]
