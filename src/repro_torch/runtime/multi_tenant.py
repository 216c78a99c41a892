"""``MultiTenantRuntime`` — N workloads, one :class:`UnitPool`.

The paper's deployed SoC Clusters are inherently multi-tenant: 60 SoCs
shared across cloud gaming, video transcoding, and DL inference (§2,
§4-5), and energy proportionality pays off when the *pool* is
partitioned per offered load. This runtime hosts any number of
:class:`~repro_torch.runtime.workload.Workload`\\ s on a single
:class:`~repro_torch.core.cluster.ClusterSpec`:

  * each tenant has its own :class:`UnitGovernor`-derived activation
    target (windowed offered rate, headroom, cooldown hysteresis,
    group quantization);
  * when total demand exceeds ``n_units``, grants are arbitrated by
    **weighted fair share** with per-tenant ``min_units`` floors
    (progressive filling, one unit at a time to the tenant with the
    least granted-beyond-floor capacity per unit of weight);
  * **straggler hedging** (§5.2) happens here, in the runtime proper: a
    tenant whose oldest queued request is older than its policy's
    ``hedge_after_s`` borrows one *free* pool unit for the tick — the
    borrowed unit serves backlog and its energy is charged to the
    tenant;
  * energy is one pool-level power integral: shared power
    (``ClusterSpec.p_shared``) is charged once per tick, never per
    tenant, and each tenant accrues only its own units' energy.

Typical use::

    from repro_torch.core.cluster import soc_cluster
    from repro_torch.runtime import (MultiTenantRuntime, Tenant, ScalePolicy,
                               DLServingWorkload, TranscodingWorkload)

    rt = MultiTenantRuntime(soc_cluster(), [
        Tenant("dl", DLServingWorkload.from_point("resnet-50", "fp32",
                                                  "soc-gpu")),
        Tenant("video", TranscodingWorkload(video, hw_codec=True),
               weight=2.0),
    ])
    tel = rt.play_traces({"dl": dl_trace, "video": video_trace}, dt_s=60.0)
    print(tel.per_tenant["dl"].summary())     # per-tenant roll-up
    print(tel.summary())                      # cluster roll-up
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.cluster import ClusterSpec
from repro_torch.power.opp import OPPTable
from repro_torch.power.thermal import ThermalModel, ThermalParams
from repro_torch.runtime.policy import ScalePolicy, UnitGovernor
from repro_torch.runtime.pool import make_unit_pool
from repro_torch.runtime.result import (Request, Response, StepStats, Telemetry,
                                  latency_percentiles)
from repro_torch.runtime.workload import Workload


@dataclass
class Tenant:
    """One workload's binding onto the shared pool."""

    name: str
    workload: Workload
    policy: Optional[ScalePolicy] = None
    unit_rate: Optional[float] = None    # req/s one unit sustains;
    #                                      from workload.describe() if None
    weight: float = 1.0                  # fair-share weight under contention
    group_units: int = 1                 # activation granularity (§5.3)


def weighted_fair_share(demands: Dict[str, int], floors: Dict[str, int],
                        weights: Dict[str, float], capacity: int,
                        groups: Optional[Dict[str, int]] = None
                        ) -> Dict[str, int]:
    """Arbitrate integer unit demands against a capacity.

    Every tenant first receives its floor (capped by its demand); the
    remaining capacity is granted in per-tenant ``groups`` chunks to the
    tenant with the smallest granted-beyond-floor per unit of weight
    (progressive filling — the discrete analogue of weighted max-min
    fairness). Beyond its floor a tenant only ever advances by whole
    groups: a tensor-parallel tenant is never handed a partial
    collaboration group, so demand left over below one group (from an
    unquantized demand) goes ungranted. When total demand fits and is
    group-aligned, everyone simply gets their demand.
    """
    groups = groups or {}
    grants = {m: min(demands[m], floors.get(m, 0)) for m in demands}
    # Uncontended fast path: when total demand fits the capacity and every
    # tenant's beyond-floor demand is a whole number of its groups, the
    # progressive fill below provably lands on the demands themselves —
    # skip the unit-at-a-time loop (it is O(capacity) and dominates the
    # single-tenant tick otherwise).
    if sum(demands.values()) <= capacity and all(
            (demands[m] - grants[m]) % groups.get(m, 1) == 0
            for m in demands):
        return dict(demands)
    order = {name: i for i, name in enumerate(demands)}
    remaining = capacity - sum(grants.values())
    while remaining > 0:
        cand = [m for m in demands
                if groups.get(m, 1) <= min(remaining,
                                           demands[m] - grants[m])]
        if not cand:
            break
        nxt = min(cand, key=lambda m: (
            (grants[m] - floors.get(m, 0)) / max(weights.get(m, 1.0), 1e-9),
            order[m]))
        grants[nxt] += groups.get(nxt, 1)
        remaining -= groups.get(nxt, 1)
    return grants


def _oldest_waiting_s(workload: Workload, t: float) -> Optional[float]:
    fn = getattr(workload, "oldest_waiting_s", None)
    return fn(t) if fn is not None else None


@dataclass
class _TenantState:
    tenant: Tenant
    governor: UnitGovernor
    responses: List[Response] = field(default_factory=list)
    accepts_perf: bool = False    # workload.step takes perf_scale=


class MultiTenantRuntime:
    """Hosts N tenants on one :class:`UnitPool` over one cluster.

    Pass ``opp_table`` (and optionally ``thermal``) to enable the
    frequency axis: each tenant's ``ScalePolicy.freq_governor`` then
    picks an operating point per tick, workload service rates scale by
    the active perf-scale, and hot units throttle down via the thermal
    trip latch. With no table (the default) the power layer is inert.
    """

    def __init__(self, spec: ClusterSpec, tenants: Sequence[Tenant],
                 dt_s: float = 1.0, window_s: float = 10.0,
                 idle_units_off: bool = True,
                 model_wake_latency: bool = False,
                 opp_table: Optional[OPPTable] = None,
                 thermal: Union[ThermalParams, ThermalModel, None] = None,
                 backend: str = "scalar") -> None:
        assert tenants, "need at least one tenant"
        names = [t.name for t in tenants]
        assert len(set(names)) == len(names), f"duplicate tenant names: {names}"
        self.spec = spec
        self.dt_s = dt_s
        self.backend = backend
        self.pool = make_unit_pool(spec, backend=backend,
                                   idle_units_off=idle_units_off,
                                   opp_table=opp_table, thermal=thermal)
        self._t = 0.0
        self._states: Dict[str, _TenantState] = {}
        floors = 0
        for ten in tenants:
            rate = ten.unit_rate
            if rate is None:
                rate = ten.workload.describe().get("unit_rate")
            if rate is None:
                raise ValueError(
                    f"tenant {ten.name!r}: unit_rate not derivable from "
                    "workload.describe(); pass Tenant(unit_rate=...) "
                    "(requests/s one unit sustains) explicitly")
            gov = UnitGovernor(
                spec, rate, ten.policy, window_s=window_s,
                idle_units_off=idle_units_off,
                model_wake_latency=model_wake_latency,
                group_units=ten.group_units,
                pool=self.pool, tenant=ten.name)
            try:
                sig = inspect.signature(ten.workload.step)
                accepts = "perf_scale" in sig.parameters
            except (TypeError, ValueError):
                accepts = False
            self._states[ten.name] = _TenantState(ten, gov,
                                                  accepts_perf=accepts)
            floors += gov._quantize(gov.policy.min_units)
        assert floors <= spec.n_units, \
            f"sum of per-tenant min_units floors ({floors}) exceeds the " \
            f"{spec.n_units}-unit pool"

    # ------------------------------------------------------------------
    @property
    def now(self) -> float:
        return self._t

    @property
    def tenant_names(self) -> List[str]:
        return list(self._states)

    def governor_of(self, tenant: str) -> UnitGovernor:
        return self._states[tenant].governor

    def workload_of(self, tenant: str) -> Workload:
        return self._states[tenant].tenant.workload

    # ------------------------------------------------------------------
    def submit(self, tenant: str, payload: Any = None, *, cost: float = 1.0,
               count: float = 1.0, request: Optional[Request] = None,
               **meta: Any) -> int:
        """Record an arrival for ``tenant`` at the current clock and hand
        the request to its workload. ``count`` weights the arrival-rate
        estimate (use ``count=cost`` for aggregated fluid requests)."""
        st = self._states[tenant]
        req = request or Request(payload=payload, cost=cost,
                                 arrival_s=self._t, meta=meta)
        if req.arrival_s is None:
            req.arrival_s = self._t
        st.governor.record_arrival(self._t, count)
        return st.tenant.workload.submit(req)

    # ------------------------------------------------------------------
    def _tick_all(self, dt_s: Optional[float] = None
                  ) -> Dict[str, StepStats]:
        """One canonical iteration for every tenant: per-tenant demand →
        weighted-fair arbitration → pool allocation → straggler hedging →
        gated workload step → single pool-level energy charge."""
        dt = self.dt_s if dt_s is None else dt_s
        t = self._t
        names = list(self._states)
        govs = {m: self._states[m].governor for m in names}
        desired = {m: govs[m].desired_units(t) for m in names}
        floors = {m: govs[m]._quantize(govs[m].policy.min_units)
                  for m in names}
        weights = {m: self._states[m].tenant.weight for m in names}
        groups = {m: govs[m].group_units for m in names}
        grants = weighted_fair_share(desired, floors, weights,
                                     self.spec.n_units, groups=groups)
        active = {m: govs[m].apply_target(grants[m], t, dt) for m in names}
        # straggler hedging (§5.2): a tenant whose oldest queued request
        # has waited past hedge_after_s borrows one free unit this tick
        free = self.pool.free_units()
        hedges: Dict[str, int] = {}
        for m in names:
            h = 0
            deadline = govs[m].policy.hedge_after_s
            wl = self._states[m].tenant.workload
            unit_cap = govs[m].unit_cap
            if deadline is not None and free > 0 \
                    and (unit_cap is None or active[m] < unit_cap):
                # a borrowed unit must add real capacity: skip when the
                # workload's own concurrency cap (e.g. batcher slots)
                # already binds; a chaos unit_cap (killed units look
                # free to the pool) gates the borrow the same way
                cap_fn = getattr(wl, "max_useful_units", None)
                capped = cap_fn is not None and active[m] + 1 > cap_fn()
                age = None if capped else _oldest_waiting_s(wl, t)
                if age is not None and age > deadline:
                    h = 1
                    free -= 1
                    govs[m].hedged += 1
            hedges[m] = h
        out: Dict[str, StepStats] = {}
        utils: Dict[str, float] = {}
        extras: Dict[str, int] = {}
        for m in names:
            st0 = self._states[m]
            wl = st0.tenant.workload
            # frequency axis: workload capacity scales by the tenant's
            # active perf-scale (throttled units drag it down)
            perf = self.pool.perf_scale(m)
            if st0.accepts_perf:
                s = wl.step(active[m] + hedges[m], dt, t, perf_scale=perf)
            else:
                s = wl.step(active[m] + hedges[m], dt, t)
            s.t, s.dt_s = t, dt
            s.target_units = active[m]
            s.hedge_units = hedges[m]
            s.perf_scale = perf
            govs[m].backlog = s.queued > 0
            # in-flight work that outlived a scale-down stays powered
            over = max(0, (s.units_used or 0) - active[m] - hedges[m])
            extras[m] = hedges[m] + over
            utils[m] = s.utilization
            out[m] = s
        total, p_tenant, powered = self.pool.charge(
            t, dt, utils, extras,
            offered=sum(govs[m]._tick_rate for m in names),
            served=sum(s.work_done for s in out.values()))
        for m in names:
            st = self._states[m]
            out[m].active_units = powered[m]
            out[m].power_w = p_tenant.get(m, 0.0)
            out[m].energy_j = self.pool.tenant_energy_j.get(m, 0.0)
            st.governor.note(t, powered[m], p_tenant.get(m, 0.0),
                             out[m].utilization, served=out[m].work_done)
            # drain() is the single delivery channel into Telemetry:
            # each response reaches a tenant's response log exactly once
            st.responses.extend(st.tenant.workload.drain())
        self._t = t + dt
        return out

    def tick_all(self, dt_s: Optional[float] = None
                 ) -> Dict[str, StepStats]:
        """Advance one tick; returns per-tenant stats. (Named distinctly
        from the single-tenant facade's ``ClusterRuntime.tick``, which
        returns one StepStats.)"""
        return self._tick_all(dt_s)

    @staticmethod
    def _all_idle(stats: Dict[str, StepStats]) -> bool:
        return all(s.queued == 0 and s.concurrency == 0
                   for s in stats.values())

    def _final_drain(self) -> None:
        for st in self._states.values():
            st.responses.extend(st.tenant.workload.drain())

    def run(self, max_ticks: int = 100000) -> Telemetry:
        """Tick until every tenant is fully drained (or ``max_ticks``)."""
        for _ in range(max_ticks):
            if self._all_idle(self._tick_all()):
                break
        self._final_drain()
        return self.cluster_telemetry()

    def play_traces(self, traces: Dict[str, Sequence[float]],
                    dt_s: Optional[float] = None,
                    drain: bool = True) -> Telemetry:
        """Drive every tenant with its own offered-load trace (requests/s
        per tick). Traces may differ in length; shorter ones offer zero
        load once exhausted. Each tick submits one aggregated request of
        ``rate * dt`` request-equivalents per tenant."""
        dt = self.dt_s if dt_s is None else dt_s
        n = max(len(tr) for tr in traces.values())
        # the rate estimator needs the window to cover at least one tick
        saved = {m: self._states[m].governor.window_s for m in self._states}
        for m in self._states:
            self._states[m].governor.window_s = max(saved[m], dt)
        try:
            for i in range(n):
                for m, tr in traces.items():
                    if i < len(tr):
                        work = float(tr[i]) * dt
                        if work > 0:
                            # arrivals spread across the tick; stamp the
                            # aggregate at the tick midpoint so fluid
                            # latency isn't inflated by a full tick width
                            self.submit(m, count=work, request=Request(
                                cost=work, arrival_s=self._t + 0.5 * dt))
                self._tick_all(dt)
            if drain:
                for _ in range(10 * n + 100):
                    if self._all_idle(self._tick_all(dt)):
                        break
        finally:
            for m in self._states:
                self._states[m].governor.window_s = saved[m]
        self._final_drain()
        return self.cluster_telemetry()

    # ------------------------------------------------------------------
    def tenant_telemetry(self, name: str) -> Telemetry:
        """Per-tenant roll-up. ``energy_j`` is the tenant-attributable
        unit energy only — shared infrastructure power is charged once,
        at the cluster level."""
        st = self._states[name]
        gov = st.governor
        p50, p99 = latency_percentiles(st.responses)
        attributed = self.pool.tenant_energy_j.get(name, 0.0)
        return Telemetry(
            time_s=np.asarray(gov.t_hist, float),
            offered_load=np.asarray(gov.offered_hist, float),
            active_units=np.asarray(gov.active_hist, float),
            power_w=np.asarray(gov.power_hist, float),
            utilization=np.asarray(gov.util_hist, float),
            served=gov.served,
            hedged=gov.hedged,
            scale_events=gov.scale_events,
            p50_latency_s=p50,
            p99_latency_s=p99,
            energy_j=attributed,
            unit_energy_j=attributed,
            responses=list(st.responses),
            workload=st.tenant.workload.describe(),
            tenant=name,
        )

    def cluster_telemetry(self) -> Telemetry:
        """Cluster roll-up: the pool's single power integral (shared
        power counted once), merged responses, per-tenant views under
        ``per_tenant``."""
        pool = self.pool
        responses = [r for st in self._states.values()
                     for r in st.responses]
        p50, p99 = latency_percentiles(responses)
        per = {m: self.tenant_telemetry(m) for m in self._states}
        if len(self._states) == 1:
            only = next(iter(self._states.values()))
            wl_desc = only.tenant.workload.describe()
        else:
            wl_desc = {"name": "multi-tenant", "kind": "multi-tenant",
                       "tenants": {m: per[m].workload.get("name")
                                   for m in per}}
        return Telemetry(
            time_s=np.asarray(pool.t_hist, float),
            offered_load=np.asarray(pool.offered_hist, float),
            active_units=np.asarray(pool.active_hist, float),
            power_w=np.asarray(pool.power_hist, float),
            utilization=np.asarray(pool.util_hist, float),
            served=pool.served,
            hedged=sum(st.governor.hedged for st in self._states.values()),
            scale_events=sum(st.governor.scale_events
                             for st in self._states.values()),
            p50_latency_s=p50,
            p99_latency_s=p99,
            energy_j=pool.energy_j,
            unit_energy_j=sum(pool.tenant_energy_j.values()),
            responses=responses,
            workload=wl_desc,
            per_tenant=per,
            max_temp_c=np.asarray(pool.max_temp_hist, float),
            throttled_units=np.asarray(pool.throttled_hist, float),
            fan_power_w=np.asarray(pool.fan_power_hist, float),
        )

    def static_baseline_energy(self, utilization: float = 1.0) -> float:
        """Energy the same span would have cost with every unit powered
        (the monolithic / no-gating baseline of Fig 12)."""
        ts = self.pool.t_hist
        if not ts:
            return 0.0
        # reconstruct per-tick dt from the recorded clock
        dts = [t2 - t1 for t1, t2 in zip(ts, ts[1:])]
        dts.append(dts[-1] if dts else self.dt_s)
        p = self.spec.power(self.spec.n_units, utilization,
                            idle_units_off=False)
        return p * float(sum(dts))
