"""Unit-activation policy (paper §5.2): how a cluster of small units
tracks offered load. Canonical home of :class:`ScalePolicy` and of
:class:`UnitGovernor`, the policy engine that turns offered load into a
per-tenant activation target and applies it to a
:class:`~repro_torch.runtime.pool.UnitPool` (``core.scheduler`` re-exports
``ScalePolicy`` for backward compatibility).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Optional, Tuple

import numpy as np

from repro_torch.core.cluster import ClusterSpec
from repro_torch.runtime.pool import UnitPool, make_unit_pool
from repro_torch.runtime.result import (Response, Telemetry, latency_percentiles)

if TYPE_CHECKING:   # deferred: repro_torch.power.governor imports repro_torch.core
    from repro_torch.power.governor import FreqGovernor


@dataclass
class ScalePolicy:
    headroom: float = 1.25            # target capacity / offered load
    cooldown_s: float = 30.0          # scale-down hysteresis
    min_units: int = 1
    wake_latency_s: float = 0.5       # unit power-on latency
    # Straggler hedging deadline: a tenant whose oldest queued request is
    # older than this borrows one extra unit for the tick (and is charged
    # for it). Honored by the runtime proper (MultiTenantRuntime /
    # ClusterRuntime) and, through its thin wrapper, by
    # ``core.scheduler.ElasticScheduler.simulate``.
    hedge_after_s: Optional[float] = None
    # Frequency policy (repro_torch.power.governor): picks the tenant's
    # operating point each tick; the activation target is then sized
    # against that point's effective service rate, so unit count and
    # frequency are co-optimized. Only consulted when the pool carries
    # an OPP table; None pins the nominal point (strictly additive).
    freq_governor: Optional[FreqGovernor] = None


class UnitGovernor:
    """Activation policy + per-tenant bookkeeping for one pool tenant.

    Pure demand-side logic (no workload knowledge): records arrivals,
    estimates the offered rate over a sliding window, computes the
    group-quantized activation target, and applies a (possibly
    arbitrated) target to the :class:`UnitPool` — immediate scale-up
    with optional wake latency, cooldown-hysteresis scale-down. The
    wake/cooldown loop lives *only* here (:meth:`apply_target`); the
    single-tenant :class:`~repro_torch.runtime.ClusterRuntime`, the
    multi-tenant runtime, and the retired ``ElasticScheduler`` wrapper
    all share it.

    Standalone use (no pool given) creates a private single-tenant pool —
    this is the ``serving.autoscaler.ServingAutoscaler`` compatibility
    path, where :meth:`charge` records full-cluster power. When driven by
    ``MultiTenantRuntime`` the pool is shared and the runtime records
    tenant-attributed power via :meth:`note`.
    """

    def __init__(self, spec: ClusterSpec, unit_rate: float,
                 policy: Optional[ScalePolicy] = None,
                 window_s: float = 10.0, idle_units_off: bool = True,
                 model_wake_latency: bool = False, group_units: int = 1,
                 pool: Optional[UnitPool] = None, tenant: str = "default",
                 backend: str = "scalar") -> None:
        assert unit_rate > 0, "unit_rate must be positive"
        self.spec = spec
        self.unit_rate = unit_rate
        self.policy = policy or ScalePolicy()
        self.window_s = window_s
        self.idle_units_off = idle_units_off
        self.model_wake_latency = model_wake_latency
        # units activate in groups of this size (e.g. an n-SoC tensor-
        # parallel collaboration group, §5.3): targets are rounded up to
        # a whole number of groups so no unit is stranded in a partial one
        self.group_units = max(1, int(group_units))
        assert self.group_units <= spec.n_units, \
            f"group_units={group_units} exceeds cluster size {spec.n_units}"
        self.pool = pool if pool is not None \
            else make_unit_pool(spec, backend=backend,
                                idle_units_off=idle_units_off)
        self.tenant = tenant
        self.pool.force_active(tenant, self._quantize(self.policy.min_units))
        # frequency side: consulted only when the pool carries an OPP
        # table; the chosen point feeds both the activation target (via
        # the effective service rate) and pool.set_opp in apply_target
        self.freq_governor = self.policy.freq_governor
        self._opp_target: Optional[int] = None \
            if self.pool.opp_table is None else self.pool.opp_table.nominal
        self.backlog = False          # runtime sets from last tick's queue
        # chaos hooks (repro_torch.fleet.chaos), set per tick by the fleet
        # driver. unit_cap models killed units: the governor may not
        # hold more than cap units (excess is force-released, bypassing
        # the cooldown — a fault is not a scale decision). A capped-out
        # rack also may not borrow hedge units (MultiTenantRuntime
        # gates on it). force_floor_opp models a rack power cap: the
        # frequency governor still runs (its persistent target is
        # untouched, so it resumes cleanly on release) but the pool is
        # driven at the floor OPP and activation is sized against it.
        self.unit_cap: Optional[int] = None
        self.force_floor_opp = False
        self._arrivals: List[Tuple[float, float]] = []   # (t, count)
        self._last_downscale = -1e9
        self._tick_rate = 0.0
        self.served = 0.0
        self.scale_events = 0
        self.hedged = 0
        # per-tick history (cluster view when standalone, tenant-
        # attributed view when driven by MultiTenantRuntime)
        self.t_hist: List[float] = []
        self.offered_hist: List[float] = []
        self.active_hist: List[int] = []
        self.power_hist: List[float] = []
        self.util_hist: List[float] = []

    # ------------------------------------------------------------------
    @property
    def active_units(self) -> int:
        return self.pool.active(self.tenant)

    @active_units.setter
    def active_units(self, n: int) -> None:
        # compatibility/testing hook: force the allocation, no wake latency
        self.pool.force_active(self.tenant, int(n))

    @property
    def energy_j(self) -> float:
        return self.pool.energy_j

    # ------------------------------------------------------------------
    def record_arrival(self, t: float, n: float = 1) -> None:
        if n > 0:
            self._arrivals.append((float(t), float(n)))

    def offered_rate(self, t: float) -> float:
        # strict cutoff: an arrival exactly window_s old has left the
        # window (otherwise tick-bucketed traces double-count the edge)
        cutoff = t - self.window_s
        self._arrivals = [(a, n) for a, n in self._arrivals if a > cutoff]
        return sum(n for _, n in self._arrivals) / self.window_s

    def _quantize(self, units: int) -> int:
        g = self.group_units
        whole = -(-int(units) // g) * g          # ceil to whole groups
        if whole > self.spec.n_units:            # keep only full groups
            whole = self.spec.n_units // g * g
        return max(g, whole)

    def target_units(self, offered: float, perf_scale: float = 1.0) -> int:
        need = offered * self.policy.headroom \
            / (self.unit_rate * max(perf_scale, 1e-9))
        # math.ceil == np.ceil for any finite float but skips the numpy
        # scalar round-trip on this per-tick path
        raw = int(min(self.spec.n_units,
                      max(self.policy.min_units, math.ceil(need))))
        return self._quantize(raw)

    # ------------------------------------------------------------------
    def _select_opp(self, rate: float) -> float:
        """Run the frequency governor for this tick; returns the chosen
        point's perf scale (1.0 when the frequency axis is off)."""
        table = self.pool.opp_table
        if table is None:
            return 1.0
        from repro_torch.power.governor import FreqContext
        if self.freq_governor is not None:
            # the governor may only plan with units this tenant can
            # actually obtain (its current holding plus the free pool),
            # not the whole cluster — otherwise a contended schedutil
            # picks a wide-and-slow point arbitration can never grant
            obtainable = min(self.spec.n_units,
                             max(self.policy.min_units,
                                 self.pool.active(self.tenant)
                                 + self.pool.waking(self.tenant)
                                 + self.pool.free_units()))
            self._opp_target = table.clamp(self.freq_governor.select(
                FreqContext(
                    demand_rate=rate, unit_rate=self.unit_rate,
                    headroom=self.policy.headroom,
                    n_units=obtainable, table=table,
                    unit=self.spec.unit, min_units=self.policy.min_units,
                    max_sustainable=self.pool.max_sustainable_opp(),
                    backlog=self.backlog,
                    p_gated_w=self.spec.unit.p_off if self.idle_units_off
                    else self.spec.unit.p_idle)))
        if self.force_floor_opp:
            return table[table.lowest].perf_scale
        return table[self._opp_target].perf_scale

    def desired_units(self, t: float, offered: Optional[float] = None
                      ) -> int:
        """The tenant's demand this tick: group-quantized activation
        target from the (windowed) offered rate, sized against the
        frequency governor's chosen operating point."""
        rate = self.offered_rate(t) if offered is None else offered
        self._tick_rate = rate
        return self.target_units(rate, self._select_opp(rate))

    def apply_target(self, tgt: int, t: float, dt_s: float = 1.0) -> int:
        """Move the pool allocation toward ``tgt`` (which arbitration may
        have capped below :meth:`desired_units`); returns the active-unit
        count the workload may use this tick.

        Wake handling is fluid: a unit waking within the tick serves the
        whole tick, so ``model_wake_latency`` only delays activation when
        ``wake_latency_s > dt_s`` — with the 0.5 s default and >= 1 s
        ticks it changes nothing."""
        p = self.policy
        wake_s = p.wake_latency_s if self.model_wake_latency else 0.0
        cap = self.unit_cap
        if cap is not None:
            # chaos kill: units beyond the cap are force-released now —
            # no cooldown gate, no scale event, no downscale stamp (a
            # fault is not a scaling decision)
            over = (self.pool.active(self.tenant)
                    + self.pool.waking(self.tenant) - cap)
            if over > 0:
                self.pool.release(self.tenant, over)
            if tgt > cap:
                tgt = cap
        active = self.pool.active(self.tenant)
        waking = self.pool.waking(self.tenant)
        if tgt > active + waking:
            # a starved wake (pool exhausted) is not a scale event
            if self.pool.wake(self.tenant, tgt - active - waking,
                              t + wake_s):
                self.scale_events += 1
        elif tgt < active + waking \
                and t - self._last_downscale > p.cooldown_s:
            # the pool cancels still-waking units first (they are not
            # serving, so a demand drop costs them nothing), then powers
            # off active ones
            keep = max(self._quantize(p.min_units), tgt)
            if self.pool.release(self.tenant, active + waking - keep):
                self._last_downscale = t
                self.scale_events += 1
        if self._opp_target is not None:
            opp_run = self._opp_target
            table = self.pool.opp_table
            if self.force_floor_opp and table is not None:
                opp_run = table.lowest
            self.pool.set_opp(self.tenant, opp_run)
        self.pool.advance(t, dt_s, self.tenant)
        return self.pool.active(self.tenant)

    def update(self, t: float, dt_s: float = 1.0,
               offered: Optional[float] = None) -> int:
        """Single-tenant shorthand: demand is granted unarbitrated."""
        return self.apply_target(self.desired_units(t, offered), t, dt_s)

    # ------------------------------------------------------------------
    def note(self, t: float, active: int, power: float, util: float,
             served: float = 0.0) -> None:
        """Append one tick to the per-tenant history."""
        self.served += served
        self.t_hist.append(t)
        self.offered_hist.append(self._tick_rate)
        self.active_hist.append(active)
        self.power_hist.append(power)
        self.util_hist.append(util)

    def charge(self, t: float, utilization: float, dt_s: float = 1.0,
               served: float = 0.0, extra_units: int = 0) -> float:
        """Standalone/single-tenant accounting: one tick of full-cluster
        power at the current activation; returns the tick's power draw."""
        total, _, powered = self.pool.charge(
            t, dt_s, {self.tenant: utilization},
            {self.tenant: extra_units},
            offered=self._tick_rate, served=served)
        self.note(t, powered[self.tenant], total, utilization, served)
        return total

    # ------------------------------------------------------------------
    def telemetry(self, responses: Optional[List[Response]] = None,
                  workload: Optional[dict] = None) -> Telemetry:
        p50, p99 = latency_percentiles(responses or [])
        return Telemetry(
            time_s=np.asarray(self.t_hist, float),
            offered_load=np.asarray(self.offered_hist, float),
            active_units=np.asarray(self.active_hist, float),
            power_w=np.asarray(self.power_hist, float),
            utilization=np.asarray(self.util_hist, float),
            served=self.served,
            hedged=self.hedged,
            scale_events=self.scale_events,
            p50_latency_s=p50,
            p99_latency_s=p99,
            energy_j=self.energy_j,
            responses=list(responses or []),
            workload=dict(workload or {}),
        )
