"""`ClusterRuntime` — the canonical request-lifecycle loop (paper §5.2).

One loop, shared by every workload and benchmark:

  arrival recording → target-unit computation → **gating of workload
  concurrency to the activation target** → per-tick energy accounting.

Since the unit-allocation refactor this is a thin single-tenant facade
over :class:`~repro_torch.runtime.multi_tenant.MultiTenantRuntime`: the
activation state lives in a :class:`~repro_torch.runtime.pool.UnitPool`, the
wake/cooldown policy loop lives once in
:class:`~repro_torch.runtime.policy.UnitGovernor`, and straggler hedging
(``ScalePolicy.hedge_after_s``) is honored by the runtime proper — a
request stuck past the deadline borrows a free unit for the tick and is
charged for it.

Typical use::

    from repro_torch.core.cluster import soc_cluster
    from repro_torch.core.scheduler import ScalePolicy, diurnal_trace
    from repro_torch.runtime import ClusterRuntime, DLServingWorkload

    wl = DLServingWorkload.from_point("resnet-50", "fp32", "soc-gpu")
    rt = ClusterRuntime(soc_cluster(), wl, policy=ScalePolicy())
    tel = rt.play_trace(diurnal_trace(peak_rps=1500, hours=24), dt_s=60.0)
    print(tel.summary())          # energy_j, tpe, mean_active, p99, ...
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Union

from repro_torch.core.cluster import ClusterSpec
from repro_torch.power.opp import OPPTable
from repro_torch.power.thermal import ThermalModel, ThermalParams
from repro_torch.runtime.multi_tenant import MultiTenantRuntime, Tenant
from repro_torch.runtime.policy import ScalePolicy, UnitGovernor
from repro_torch.runtime.result import Request, StepStats, Telemetry
from repro_torch.runtime.workload import Workload

__all__ = ["ClusterRuntime", "UnitGovernor"]


class ClusterRuntime(MultiTenantRuntime):
    """Binds a :class:`ClusterSpec`, a :class:`ScalePolicy`, and a single
    :class:`Workload`; runs the canonical submit/tick/account loop as a
    one-tenant :class:`MultiTenantRuntime`."""

    _TENANT = "default"

    def __init__(self, spec: ClusterSpec, workload: Workload,
                 policy: Optional[ScalePolicy] = None,
                 unit_rate: Optional[float] = None,
                 window_s: float = 10.0, dt_s: float = 1.0,
                 idle_units_off: bool = True,
                 model_wake_latency: bool = False, group_units: int = 1,
                 opp_table: Optional[OPPTable] = None,
                 thermal: Union[ThermalParams, ThermalModel, None] = None,
                 backend: str = "scalar") -> None:
        # model_wake_latency matters only for sub-tick resolution
        # (wake_latency_s > dt_s); see UnitGovernor.apply_target.
        if unit_rate is None:
            unit_rate = workload.describe().get("unit_rate")
        if unit_rate is None:
            raise ValueError(
                "unit_rate not derivable from workload.describe(); pass "
                "unit_rate= (requests/s one unit sustains) explicitly")
        super().__init__(
            spec,
            [Tenant(self._TENANT, workload, policy=policy,
                    unit_rate=unit_rate, group_units=group_units)],
            dt_s=dt_s, window_s=window_s, idle_units_off=idle_units_off,
            model_wake_latency=model_wake_latency,
            opp_table=opp_table, thermal=thermal, backend=backend)
        self.workload = workload

    # ------------------------------------------------------------------
    @property
    def governor(self) -> UnitGovernor:
        return self._states[self._TENANT].governor

    @property
    def active_units(self) -> int:
        return self.governor.active_units

    def submit(self, payload: Any = None, *, cost: float = 1.0,
               count: float = 1.0, request: Optional[Request] = None,
               **meta: Any) -> int:
        """Record an arrival at the current runtime clock and hand the
        request to the workload. ``count`` weights the arrival-rate
        estimate (use ``count=cost`` for aggregated fluid requests)."""
        return super().submit(self._TENANT, payload=payload, cost=cost,
                              count=count, request=request, **meta)

    def tick(self, dt_s: Optional[float] = None) -> StepStats:
        """One canonical iteration: update activation target, let the
        workload advance under that concurrency cap, charge energy.
        ``power_w``/``energy_j`` on the returned stats are cluster-level
        (shared power included)."""
        stats = self._tick_all(dt_s)[self._TENANT]
        stats.power_w = self.pool.last_power_w
        stats.energy_j = self.pool.energy_j
        return stats

    def play_trace(self, trace_rps: Sequence[float],
                   dt_s: Optional[float] = None,
                   drain: bool = True) -> Telemetry:
        """Drive the runtime with an offered-load trace (requests/s per
        tick), e.g. :func:`repro_torch.core.scheduler.diurnal_trace`."""
        return self.play_traces({self._TENANT: trace_rps}, dt_s=dt_s,
                                drain=drain)

    # ------------------------------------------------------------------
    def telemetry(self) -> Telemetry:
        return self.cluster_telemetry()
