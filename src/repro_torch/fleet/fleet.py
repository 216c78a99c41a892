"""``Fleet`` — N racks behind a geo-routed load balancer.

The paper prototypes one 60-SoC rack; public edge platforms aggregate
hundreds of such sites behind request routers. A :class:`Fleet` holds N
racks (mixed :class:`~repro_torch.core.cluster.ClusterSpec`\\ s allowed), a
:class:`~repro_torch.fleet.router.Router` that shards the fleet-level offered
load across racks each tick, and per-rack elastic unit governors — the
same activation policy the single-rack runtime uses, applied one level
up. A rack may additionally carry the full power stack: an
:class:`~repro_torch.power.opp.OPPTable` with a frequency governor
(``ScalePolicy.freq_governor``), an RC thermal network
(:class:`~repro_torch.power.thermal.ThermalParams`), and straggler hedging
(``ScalePolicy.hedge_after_s``).

Two engines implement the same simulation:

  * ``backend="scalar"`` — one full per-unit
    :class:`~repro_torch.runtime.ClusterRuntime` per rack (the reference:
    every unit is an object, every tick walks every rack's pool);
  * ``backend="vector"`` — rack state stacked into numpy arrays:
    activation targets, cooldown timers, per-rack OPP indices with the
    per-OPP perf/power scales stacked as (racks, opps) tables, the
    frequency governors (``fixed`` / ``race-to-idle`` / ``schedutil``'s
    lowest-energy OPP×unit-count search / the ``ThermalAwareGovernor``
    ceiling clamp) evaluated as masked argmin passes over the OPP axis,
    hedging as a per-rack borrowed-unit counter in the fluid drain, and
    the RC thermal networks of every thermal-modelled rack flattened
    into one stacked per-die state. Per-rack fluid FIFO queues are kept
    for exact request latencies.

The vector engine replicates the scalar engine's arithmetic operation
for operation, so the two produce **bitwise-identical** telemetry —
energy integrals, latency percentiles, and temperature/throttle/fan
histories — while the vector engine runs an order of magnitude faster:
fast enough to sweep 100 racks x 24 simulated hours in seconds
(``benchmarks/fig16_fleet.py``), with or without a frequency governor.
Governors outside the built-in set still work: they fall back to a
per-rack ``select`` call against a real
:class:`~repro_torch.power.governor.FreqContext` (correct, just not stacked).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cluster import ClusterSpec
from repro_torch.fleet.chaos import (
    ChaosMonitor,
    ChaosSchedule,
    LoweredChaos,
    recovery_report,
)
from repro_torch.fleet.degrade import (
    BRK_CLOSED,
    DegradeDriver,
    DegradePolicy,
    LoweredDegrade,
)
from repro_torch.fleet.engine_state import (
    GOV_FIXED,
    GOV_RACE,
    GOV_SCHED,
    ThermalLayout,
    build_fleet_arrays,
)
from repro_torch.fleet.router import FleetView, JoinShortestQueueRouter, Router
from repro_torch.fleet.telemetry import FleetTelemetry
from repro_torch.power.governor import FreqContext
from repro_torch.power.opp import OPPTable
from repro_torch.power.thermal import ThermalParams
from repro_torch.runtime import (
    ClusterRuntime,
    QueueWorkload,
    Request,
    ScalePolicy,
    Telemetry,
    latency_percentiles,
)

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (obs is optional)
    from repro_torch.obs import FleetObs

__all__ = ["RackConfig", "Fleet", "homogeneous_fleet"]


@dataclass
class RackConfig:
    """One rack's binding into the fleet.

    ``opp_table`` enables the frequency axis for the rack (consulted by
    ``policy.freq_governor``); ``thermal`` attaches the per-die RC
    network with trip-latch throttling (requires an ``opp_table`` to
    throttle within, exactly like the pool)."""

    spec: ClusterSpec
    unit_rate: float  # requests/s one unit sustains
    policy: Optional[ScalePolicy] = None
    name: str = ""
    opp_table: Optional[OPPTable] = None
    thermal: Optional[ThermalParams] = None


def homogeneous_fleet(
    spec: ClusterSpec,
    n_racks: int,
    unit_rate: float,
    policy: Optional[ScalePolicy] = None,
    opp_table: Optional[OPPTable] = None,
    thermal: Optional[ThermalParams] = None,
) -> List[RackConfig]:
    """N identical racks (the common case for a single-platform fleet)."""
    return [
        RackConfig(
            spec,
            unit_rate,
            policy,
            name=f"{spec.name}/{i}",
            opp_table=opp_table,
            thermal=thermal,
        )
        for i in range(n_racks)
    ]


def _init_chaos_state(engine: Any, n: int) -> None:
    """Shared chaos bookkeeping both tick engines carry (inert until
    ``apply_chaos`` is first called — the no-chaos fast paths check a
    single bool). ``chaos_dead`` is the *current* per-rack down-unit
    count; the cumulative counters feed telemetry and the sanitizer's
    conservation credit."""
    engine._chaos_active = False
    engine.chaos_on_kill = "respill"
    engine.chaos_dead = np.zeros(n, np.int64)
    engine.chaos_fan = np.zeros(n, bool)
    engine.chaos_cap = np.zeros(n, bool)
    engine.chaos_evac_cost = 0.0
    engine.chaos_evac_by_rack = np.zeros(n)
    engine.chaos_dropped = 0
    engine.chaos_dropped_cost = 0.0
    engine.chaos_respilled = 0
    engine.chaos_respilled_cost = 0.0


def _init_degrade_state(engine: Any, n: int) -> None:
    """Shared degradation bookkeeping both tick engines carry (inert
    until the fleet calls ``expire``). The cumulative expired cost is
    the sanitizer's conservation credit — work abandoned past its
    deadline was injected but will never be served."""
    engine.degrade_expired = 0
    engine.degrade_expired_cost = 0.0
    engine.degrade_expired_by_rack = np.zeros(n)


def _tier_requests(
    work: float, arrival_s: float,
    tier_split: Sequence[Tuple[Optional[str], float]],
) -> List[Tuple[float, Request]]:
    """Split one rack's tick work into per-tier sub-requests (shared by
    both host engines so the sub-costs are the same float expressions).
    Slice existence is decided by ``frac > 0`` alone — never by cost
    rounding dust — and the *last positive-fraction* slice takes the
    exact remainder, so the slices sum back to ``work`` bitwise and
    splitting never perturbs conservation. The jax engine mirrors this
    split host-side from its emitted per-tier admitted rows (its
    fractions agree within tolerance, so the frac-positivity predicate
    keeps sub-request counts identical across engines). Only the first
    slice carries the arrival-rate ``count`` weight; the rest weigh
    ``0.0`` (adding 0.0 to the non-negative windowed accumulator is a
    bitwise no-op), keeping the scalar governor's rate estimate
    identical to the unsplit path — the vector engine's ``work / dt``."""
    out: List[Tuple[float, Request]] = []
    idx = [i for i, (_name, frac) in enumerate(tier_split) if frac > 0.0]
    if not idx:
        return out
    acc = 0.0
    cnt = work
    for i in idx[:-1]:
        name, frac = tier_split[i]
        c = work * frac
        out.append(
            (cnt, Request(payload=name, cost=c, arrival_s=arrival_s)))
        cnt = 0.0
        acc += c
    c = work - acc
    if c > 0.0:
        out.append(
            (cnt, Request(payload=tier_split[idx[-1]][0], cost=c,
                          arrival_s=arrival_s)))
    return out


class _ScalarFleetEngine:
    """Reference engine: one per-unit ClusterRuntime per rack."""

    backend = "scalar"

    def __init__(
        self,
        racks: Sequence[RackConfig],
        dt_s: float,
        idle_units_off: bool,
    ) -> None:
        self.dt_s = dt_s
        self.now = 0.0
        self.obs: Optional["FleetObs"] = None
        self._any_thermal = any(rc.thermal is not None for rc in racks)
        self.rts: List[ClusterRuntime] = []
        for i, rc in enumerate(racks):
            wl = QueueWorkload(rc.unit_rate, name=rc.name or f"rack{i}")
            self.rts.append(
                ClusterRuntime(
                    rc.spec,
                    wl,
                    policy=rc.policy,
                    window_s=dt_s,
                    dt_s=dt_s,
                    idle_units_off=idle_units_off,
                    opp_table=rc.opp_table,
                    thermal=rc.thermal,
                    backend="scalar",
                )
            )
        self.n_units = np.array([rc.spec.n_units for rc in racks], np.int64)
        _init_chaos_state(self, len(self.rts))
        _init_degrade_state(self, len(self.rts))

    def queued_cost(self) -> np.ndarray:
        return np.array([rt.workload.pending_cost for rt in self.rts], float)

    def expire(self, deadline_s: float) -> None:
        """Abandon queued work older than ``deadline_s`` (deadline-aware
        load shedding; called by the fleet driver before routing)."""
        t = self.now
        for r, rt in enumerate(self.rts):
            n_req, cost = rt.workload.expire(t, deadline_s)
            if n_req:
                self.degrade_expired += n_req
                self.degrade_expired_cost += cost
                self.degrade_expired_by_rack[r] += cost

    def active_units(self) -> np.ndarray:
        return np.array([rt.active_units for rt in self.rts], np.int64)

    def apply_chaos(
        self,
        dead: np.ndarray,
        fan_fail: np.ndarray,
        power_cap: np.ndarray,
    ) -> float:
        """Impose one tick's fault masks on every rack (called by the
        fleet driver *before* routing). Kills are count-granular: the
        governor's ``unit_cap`` force-releases units beyond the cap and
        blocks hedging past it, so the pool's charge arithmetic never
        changes. A full-rack kill *edge* evacuates the rack's queue;
        the evacuated cost is returned for the driver to re-offer
        (``on_kill="respill"``) or counted as dropped. Racks are walked
        in ascending order so the respilled total accumulates in the
        same float order as the vector engine's."""
        spill = 0.0
        prev = self.chaos_dead
        respill = self.chaos_on_kill == "respill"
        for r, rt in enumerate(self.rts):
            d = int(dead[r])
            nu = int(self.n_units[r])
            if d >= nu and prev[r] < nu:
                n_req, cost = rt.workload.evacuate()
                self.chaos_evac_cost += cost
                self.chaos_evac_by_rack[r] += cost
                if respill:
                    spill += cost
                    self.chaos_respilled += n_req
                    self.chaos_respilled_cost += cost
                else:
                    self.chaos_dropped += n_req
                    self.chaos_dropped_cost += cost
            gov = rt.governor
            gov.unit_cap = (nu - d) if d > 0 else None
            gov.force_floor_opp = bool(power_cap[r])
            pool_th = rt.pool.thermal
            if pool_th is not None:
                pool_th.fan_failed = bool(fan_fail[r])
        np.copyto(self.chaos_dead, dead)
        np.copyto(self.chaos_fan, fan_fail)
        np.copyto(self.chaos_cap, power_cap)
        self._chaos_active = bool(
            dead.any() or fan_fail.any() or power_cap.any()
        )
        return spill

    def tick(
        self, assign_rps: np.ndarray, dt: float,
        tier_split: Optional[Sequence[Tuple[Optional[str], float]]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        t = self.now
        for r, rt in enumerate(self.rts):
            work = float(assign_rps[r]) * dt
            if work > 0:
                if tier_split is None:
                    rt.submit(
                        count=work,
                        request=Request(cost=work, arrival_s=t + 0.5 * dt),
                    )
                else:
                    for cnt, req in _tier_requests(
                        work, t + 0.5 * dt, tier_split
                    ):
                        rt.submit(count=cnt, request=req)
        n = len(self.rts)
        queued = np.zeros(n, np.int64)
        conc = np.zeros(n, np.int64)
        obs = self.obs
        emit = (
            obs is not None
            and obs.probes is not None
            and obs.probes.active
        )
        hedges = np.zeros(n, np.int64) if emit else None
        for r, rt in enumerate(self.rts):
            stats = rt.tick(dt)
            queued[r] = stats.queued
            conc[r] = stats.concurrency
            if hedges is not None:
                hedges[r] = stats.hedge_units
        if hedges is not None:
            self._emit_probes(t, dt, queued, hedges)
        self.now = t + dt
        return queued, conc

    def _emit_probes(
        self, t: float, dt: float, queued: np.ndarray, hedges: np.ndarray
    ) -> None:
        """One probe row from the pools' just-appended tick histories.
        The ledger surface needs no fleet-level hook here: each pool
        meters its own charge() ticks (``UnitPool.attach_ledger``)."""
        assert self.obs is not None and self.obs.probes is not None
        pools = [rt.pool for rt in self.rts]
        row = {
            "power_w": np.array([p.power_hist[-1] for p in pools]),
            "queued": queued.astype(float),
            "active_units": np.array(
                [float(p.active_hist[-1]) for p in pools]
            ),
            "waking_units": np.array(
                [float(p.n_waking_total()) for p in pools]
            ),
            "utilization": np.array([p.util_hist[-1] for p in pools]),
            "opp_index": np.array(
                [
                    float(p._tenant_opp_of(rt._TENANT))
                    if p.opp_table is not None
                    else 0.0
                    for p, rt in zip(pools, self.rts)
                ]
            ),
            "hedge_units": hedges.astype(float),
        }
        if self._any_thermal:
            row["max_temp_c"] = np.array(
                [
                    p.max_temp_hist[-1] if p.thermal is not None else np.nan
                    for p in pools
                ]
            )
            row["throttled_units"] = np.array(
                [
                    float(p.throttled_hist[-1])
                    if p.thermal is not None
                    else 0.0
                    for p in pools
                ]
            )
        self.obs.probes.emit_tick(t, dt, row)

    def per_rack_telemetry(self) -> List[Telemetry]:
        return [rt.cluster_telemetry() for rt in self.rts]


class _StackedThermal:
    """Every thermal-modelled rack's RC network in one flat state.

    Per-die temperatures, per-PCB-group temperatures, and trip latches
    of all racks live in single arrays; the Euler substeps are
    elementwise, per-group heat flows are contiguous ``reduceat``
    segment sums (same ascending-unit accumulation order as the scalar
    :class:`~repro_torch.power.thermal.ThermalModel` loop), and per-rack fan
    fractions are segment maxima. Racks whose sub-step count differs
    (different specs/params) are frozen with zero-deltas once their own
    sub-steps are done — adding ``0.0`` leaves a temperature bitwise
    unchanged — so every rack integrates exactly as its scalar twin.
    """

    def __init__(self, layout: ThermalLayout) -> None:
        # static layout + RC parameters are shared with the jax engine
        # (built once in engine_state.build_thermal_layout)
        self.layout = layout
        self.t_idx = layout.t_idx  # fleet rack indices
        self.r_die = layout.r_die
        self.c_die = layout.c_die
        self.r_pcb0 = layout.r_pcb0
        self.c_pcb = layout.c_pcb
        self.t_amb = layout.t_amb
        self.fan_low = layout.fan_low
        self.fan_span = layout.fan_span
        self.fan_rmin = layout.fan_rmin
        self.fan_pmax = layout.fan_pmax
        self.trip = layout.trip
        self.release = layout.release
        self.last_unit = layout.last_unit
        self.n_flat_units = layout.n_flat_units
        self.unit_starts = layout.unit_starts
        self.group_starts = layout.group_starts
        self.rack_u = layout.rack_u
        self.rack_g = layout.rack_g
        self.local_idx = layout.local_idx
        self.group_of_u = layout.group_of_u
        self.r_die_u = layout.r_die_u
        self.c_die_u = layout.c_die_u
        self.c_pcb_g = layout.c_pcb_g
        self.t_amb_g = layout.t_amb_g
        self.max_sustainable = layout.max_sustainable
        # mutable state: per-die / per-group temperatures + trip latches
        self.t_die = layout.t_amb[layout.rack_u].copy()
        self.t_pcb = layout.t_amb[layout.rack_g].copy()
        self.latched = np.zeros(layout.n_flat_units, bool)
        self._pw = np.empty(layout.n_flat_units, float)

    def any_latched(self) -> bool:
        return bool(self.latched.any())

    def step(
        self, dt: float, pw: np.ndarray,
        fan_fail: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Advance every stacked network one tick under the flat
        per-unit power draw; returns per-thermal-rack ``(fan_w,
        max_die_temp_c, n_throttled)`` — the three pool histograms.
        ``fan_fail`` (chaos, per thermal rack) pins a failed shared fan
        rail's airflow at zero: frac = 0.0 collapses ``r_pcb`` to the
        no-airflow resistance and ``fan_w`` to 0.0, bitwise the scalar
        ``ThermalModel.fan_failed`` path; healthy racks' fracs are left
        untouched."""
        hottest = np.maximum.reduceat(self.t_pcb, self.group_starts)
        raw_frac = (hottest - self.fan_low) / self.fan_span
        frac = np.minimum(1.0, np.maximum(0.0, raw_frac))
        if fan_fail is not None and fan_fail.any():
            frac = np.where(fan_fail, 0.0, frac)
        r_pcb = self.r_pcb0 * (1.0 - (1.0 - self.fan_rmin) * frac)
        tau = np.minimum(self.r_die * self.c_die, r_pcb * self.c_pcb)
        denom = np.maximum(0.25 * tau, 1e-6)
        n_sub = np.maximum(1, (dt / denom).astype(np.int64) + 1)
        h = dt / n_sub
        h_u = h[self.rack_u]
        h_g = h[self.rack_g]
        r_pcb_g = r_pcb[self.rack_g]
        max_sub = int(n_sub.max())
        uniform = bool((n_sub == max_sub).all())
        n_groups = len(self.t_pcb)
        for s in range(max_sub):
            f = (self.t_die - self.t_pcb[self.group_of_u]) / self.r_die_u
            # weighted bincount adds in input order — bitwise-identical
            # to the scalar per-unit accumulation loop, which float
            # add.reduceat is not (its reduction is not left-to-right)
            flows = np.bincount(self.group_of_u, weights=f, minlength=n_groups)
            d_die = h_u * (pw - f) / self.c_die_u
            out = (self.t_pcb - self.t_amb_g) / r_pcb_g
            d_pcb = h_g * (flows - out) / self.c_pcb_g
            if not uniform:
                live = s < n_sub
                d_die = np.where(live[self.rack_u], d_die, 0.0)
                d_pcb = np.where(live[self.rack_g], d_pcb, 0.0)
            self.t_die += d_die
            self.t_pcb += d_pcb
        self.latched = np.where(
            self.latched,
            ~(self.t_die <= self.release[self.rack_u]),
            self.t_die >= self.trip[self.rack_u],
        )
        fan_w = self.fan_pmax * frac
        max_temp = np.maximum.reduceat(self.t_die, self.unit_starts)
        n_thr = np.add.reduceat(  # reprolint: ok[RPL001] int64 counts: integer addition is exact in any order
            self.latched.astype(np.int64), self.unit_starts)
        return fan_w, max_temp, n_thr


class _VectorFleetEngine:
    """Stacked engine: rack state as arrays, one numpy pass per tick.

    Every floating-point expression mirrors the scalar engine's
    operation order exactly (``UnitGovernor.target_units``,
    ``UnitPool.charge``, the windowed rate estimate, the frequency
    governors, and the thermal Euler step collapse to closed forms when
    ``window_s == dt_s``, group size is 1, and each rack hosts one
    fluid tenant), so per-rack telemetry is bitwise-identical to the
    scalar engine's. The fluid FIFO queues stay as per-rack
    :class:`QueueWorkload` objects — both engines share that code, so
    request latencies match by construction.

    The frequency axis: each rack carries one OPP index (single tenant,
    so the pool's per-unit requested points collapse to it), the per-OPP
    perf/power scales are stacked as (racks, opps) tables, and the
    built-in governors run as masked argmin passes over the OPP axis.
    Straggler hedging is a per-rack borrowed-unit counter folded into
    the fluid drain and the power integral, exactly as the runtime
    charges it. Trip-latched dies are metered at the floor OPP through
    per-rack latched-active counts from the stacked thermal state.
    """

    backend = "vector"

    def __init__(
        self,
        racks: Sequence[RackConfig],
        dt_s: float,
        idle_units_off: bool,
    ) -> None:
        # every static per-rack array — activation policy, stacked OPP
        # tables, governor classification, thermal layout — comes from
        # the shared builder (also consumed by the jax engine)
        arr = build_fleet_arrays(racks, idle_units_off)
        self.arrays = arr
        self.dt_s = dt_s
        self.now = 0.0
        self.obs: Optional["FleetObs"] = None
        self._any_table = bool(np.any(arr.has_table))
        self._any_hedge = any(dl is not None for dl in arr.hedge_deadline)
        self._obs_zeros: Optional[np.ndarray] = None
        self.n_units = arr.n_units
        self.unit_rate = arr.unit_rate
        self.headroom = arr.headroom
        self.min_units = arr.min_units
        self.minq = arr.minq
        self.cooldown = arr.cooldown
        self.p_shared = arr.p_shared
        self.p_idle = arr.p_idle
        self.p_peak = arr.p_peak
        self.gamma = arr.gamma
        self.span = arr.span
        self.p_base = arr.p_base
        self.wls = [
            QueueWorkload(rc.unit_rate, name=arr.names[i])
            for i, rc in enumerate(racks)
        ]
        n = arr.n_racks
        self._rr = np.arange(n)
        self.has_table = arr.has_table
        self.K = arr.K
        self.Kmax = arr.Kmax
        self.perf_tab = arr.perf_tab
        self.spk_tab = arr.spk_tab
        self.opp = arr.opp0.copy()
        self.nominal = arr.nominal
        self.highest = arr.highest
        self.therm: Optional[_StackedThermal] = (
            _StackedThermal(arr.thermal) if arr.thermal is not None else None
        )
        self.t_idx = arr.t_idx
        self._gov_kind = arr.gov_kind
        self._fixed_opp = arr.fixed_opp
        self._sched_headroom = arr.sched_headroom
        self._ceiling = arr.ceiling
        self._has_ceiling = arr.has_ceiling
        self._generic = arr.generic
        self._tables = arr.tables
        self._unit_specs = arr.unit_specs
        self._max_sust = arr.max_sust
        self._fixed_idx = np.nonzero(arr.gov_kind == GOV_FIXED)[0]
        self._race_idx = np.nonzero(arr.gov_kind == GOV_RACE)[0]
        self._sched_idx = np.nonzero(arr.gov_kind == GOV_SCHED)[0]
        # hedging config (None = off), per rack
        self._hedge_deadline = arr.hedge_deadline
        self.backlog = np.zeros(n, bool)
        self.active = arr.minq.copy()
        self.last_down = np.full(n, -1e9)
        self.scale_events = np.zeros(n, np.int64)
        self.hedged_cnt = np.zeros(n, np.int64)
        self.energy = np.zeros(n)
        self.unit_energy = np.zeros(n)
        self.served_acc = np.zeros(n)
        self.responses: List[list] = [[] for _ in range(n)]
        self._t_hist: List[float] = []
        self._offered_rows: List[np.ndarray] = []
        self._active_rows: List[np.ndarray] = []
        self._power_rows: List[np.ndarray] = []
        self._util_rows: List[np.ndarray] = []
        self._fan_rows: List[np.ndarray] = []
        self._temp_rows: List[np.ndarray] = []
        self._thr_rows: List[np.ndarray] = []
        _init_chaos_state(self, n)
        _init_degrade_state(self, n)

    def queued_cost(self) -> np.ndarray:
        return np.array([wl.pending_cost for wl in self.wls], float)

    def expire(self, deadline_s: float) -> None:
        """Vector twin of the scalar ``expire`` — the deque walk lives
        in the shared :class:`QueueWorkload`, so the popped requests and
        reclaimed cost are identical by construction."""
        t = self.now
        for r, wl in enumerate(self.wls):
            n_req, cost = wl.expire(t, deadline_s)
            if n_req:
                self.degrade_expired += n_req
                self.degrade_expired_cost += cost
                self.degrade_expired_by_rack[r] += cost

    def active_units(self) -> np.ndarray:
        return self.active.copy()

    def apply_chaos(
        self,
        dead: np.ndarray,
        fan_fail: np.ndarray,
        power_cap: np.ndarray,
    ) -> float:
        """Vector twin of the scalar engine's ``apply_chaos``: same
        ascending-rack evacuation order (so the respilled total is the
        same float accumulation), same counters. The masks themselves
        are folded into :meth:`tick` as overlays — carried governor
        state (``self.opp``, cooldown stamps) is never clobbered."""
        spill = 0.0
        prev = self.chaos_dead
        respill = self.chaos_on_kill == "respill"
        nu = self.n_units
        for r in np.nonzero((dead >= nu) & (prev < nu))[0]:
            n_req, cost = self.wls[r].evacuate()
            self.chaos_evac_cost += cost
            self.chaos_evac_by_rack[r] += cost
            if respill:
                spill += cost
                self.chaos_respilled += n_req
                self.chaos_respilled_cost += cost
            else:
                self.chaos_dropped += n_req
                self.chaos_dropped_cost += cost
        np.copyto(self.chaos_dead, dead)
        np.copyto(self.chaos_fan, fan_fail)
        np.copyto(self.chaos_cap, power_cap)
        self._chaos_active = bool(
            dead.any() or fan_fail.any() or power_cap.any()
        )
        return spill

    # ------------------------------------------------------------------
    def _select_opps(self, rate: np.ndarray, t: float) -> None:
        """One frequency-governor decision per rack, vectorized over the
        OPP axis for the built-in governors (mirrors
        ``UnitGovernor._select_opp`` + each governor's ``select``)."""
        if self._fixed_idx.size:
            self.opp[self._fixed_idx] = self._fixed_opp[self._fixed_idx]
        ri = self._race_idx
        if ri.size:
            busy = (rate[ri] > 0.0) | self.backlog[ri]
            self.opp[ri] = np.where(busy, self.highest[ri], self.nominal[ri])
        si = self._sched_idx
        if si.size:
            d = rate[si]
            need = d * self._sched_headroom[si]
            ur = self.unit_rate[si]
            nu = self.n_units[si]
            mu = self.min_units[si]
            pg = self.p_base[si]
            pi = self.p_idle[si]
            ga = self.gamma[si]
            kv = self.K[si]
            best = self.highest[si].copy()
            bestp = np.full(si.size, np.inf)
            pos = need > 0.0
            for c in range(self.Kmax):
                eff = ur * self.perf_tab[si, c]
                ncnt = np.maximum(mu, np.ceil(need / eff)).astype(np.int64)
                util = np.minimum(1.0, d / (np.maximum(ncnt, 1) * eff))
                spk = self.spk_tab[si, c]
                power = ncnt * (pi + spk * util**ga) + (nu - ncnt) * pg
                upd = (c < kv) & (ncnt <= nu) & pos & (power < bestp - 1e-12)
                best = np.where(upd, c, best)
                bestp = np.where(upd, power, bestp)
            self.opp[si] = np.where(pos, best, 0)
        for r, gov in self._generic:
            tb = self._tables[r]
            ctx = FreqContext(
                demand_rate=float(rate[r]),
                unit_rate=float(self.unit_rate[r]),
                headroom=float(self.headroom[r]),
                n_units=int(self.n_units[r]),
                table=tb,
                unit=self._unit_specs[r],
                min_units=int(self.min_units[r]),
                max_sustainable=self._max_sust[r],
                backlog=bool(self.backlog[r]),
                p_gated_w=float(self.p_base[r]),
            )
            self.opp[r] = tb.clamp(gov.select(ctx))
        if self._has_ceiling.any():
            clamped = np.minimum(self.opp, self._ceiling)
            self.opp = np.where(self._has_ceiling, clamped, self.opp)

    # ------------------------------------------------------------------
    def tick(
        self, assign_rps: np.ndarray, dt: float,
        tier_split: Optional[Sequence[Tuple[Optional[str], float]]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        t = self.now
        work = assign_rps * dt
        if tier_split is None:
            for r in np.nonzero(work > 0)[0]:
                req = Request(cost=float(work[r]), arrival_s=t + 0.5 * dt)
                self.wls[r].submit(req)
        else:
            for r in np.nonzero(work > 0)[0]:
                for _cnt, req in _tier_requests(
                    float(work[r]), t + 0.5 * dt, tier_split
                ):
                    self.wls[r].submit(req)
        # windowed rate estimate with window == dt: this tick's work
        rate = work / dt
        # frequency governors pick this tick's OPP; the activation
        # target is then sized against that point's effective rate
        self._select_opps(rate, t)
        # chaos overlays (inert fast path: one bool when no fault is
        # live). Killed units shrink the usable rack; a power-capped
        # rack *runs* at the floor point this tick while the carried
        # governor state (self.opp) is untouched — exactly the scalar
        # governor's force_floor_opp / unit_cap semantics.
        chaos = self._chaos_active
        if chaos:
            cap_units = self.n_units - self.chaos_dead
            opp_eff = np.where(self.chaos_cap & self.has_table, 0, self.opp)
        else:
            cap_units = self.n_units
            opp_eff = self.opp
        # the chosen points' perf scales, for both activation sizing and
        # the workload's mean perf multiplier
        perf_req = self.perf_tab[self._rr, opp_eff]
        perf_sz = np.where(self.has_table, perf_req, 1.0)
        # UnitGovernor.target_units with group == 1
        need = rate * self.headroom / (self.unit_rate * np.maximum(perf_sz, 1e-9))
        raw = np.minimum(self.n_units, np.maximum(self.min_units, np.ceil(need)))
        tgt = np.maximum(1, raw.astype(np.int64))
        # UnitGovernor.apply_target: immediate scale-up, cooldown-gated
        # scale-down to max(min floor, target)
        active = self.active
        if chaos:
            # killed units are force-released (no cooldown stamp, no
            # scale event — a fault is not a scaling decision) and the
            # target is capped, mirroring apply_target's unit_cap path
            tgt = np.minimum(tgt, cap_units)
            active = np.minimum(active, cap_units)
        up = tgt > active
        keep = np.maximum(self.minq, tgt)
        in_cooldown = t - self.last_down > self.cooldown
        down = (tgt < active) & in_cooldown & (keep < active)
        new_active = np.where(up, tgt, np.where(down, keep, active))
        self.scale_events += up
        self.scale_events += down
        self.last_down = np.where(down, t, self.last_down)
        self.active = new_active
        k_f = new_active.astype(float)
        # mean perf-scale over each rack's active units (pool.perf_scale:
        # trip-latched units are dragged to the floor point). A fully
        # killed rack has k == 0: the pool returns the requested point's
        # perf there (k_div only rewrites the k == 0 lanes — for k >= 1
        # the division is bitwise the original expression)
        if chaos:
            k_div = np.maximum(k_f, 1.0)
            perf_used = np.where(
                self.has_table,
                np.where(new_active > 0, (k_f * perf_req) / k_div, perf_req),
                1.0,
            )
        else:
            perf_used = np.where(self.has_table, (k_f * perf_req) / k_f, 1.0)
        latched_any = self.therm is not None and self.therm.any_latched()
        floor_all = None
        if latched_any:
            th = self.therm
            ti = self.t_idx
            am = th.local_idx < new_active[ti][th.rack_u]
            lam = (am & th.latched).astype(np.int64)
            c_low_t = np.add.reduceat(lam, th.unit_starts)  # reprolint: ok[RPL001] lam is int64 0/1 flags: integer addition is exact in any order
            c_low_f = c_low_t.astype(float)
            k_t = k_f[ti]
            p0 = self.perf_tab[ti, 0]
            pr = self.perf_tab[ti, opp_eff[ti]]
            # single product when everything lands in the floor bucket,
            # the two-bucket ascending accumulation otherwise — exactly
            # _perf_from_opp_counts
            floor_all = (opp_eff[ti] == 0) & (c_low_t > 0)
            mixed = c_low_f * p0 + (k_t - c_low_f) * pr
            if chaos:
                k_div_t = np.maximum(k_t, 1.0)
                perf_used[ti] = np.where(
                    k_t > 0,
                    np.where(floor_all, k_t * p0, mixed) / k_div_t,
                    pr,
                )
            else:
                perf_used[ti] = np.where(floor_all, k_t * p0, mixed) / k_t
        else:
            am = c_low_f = None
        # fluid FIFO drain per rack (QueueWorkload.step_fast — the
        # allocation-light twin of step(), identical arithmetic), with
        # straggler hedging: a rack whose oldest queued request has
        # waited past hedge_after_s borrows one free unit this tick
        n = len(self.wls)
        acts = new_active.tolist()
        nu_l = self.n_units.tolist()
        # hedging may only borrow a *live* unit (scalar: unit_cap gates
        # the borrow in MultiTenantRuntime)
        cap_l = cap_units.tolist() if chaos else nu_l
        perf_l = perf_used.tolist()
        hedges = [0] * n
        utils_l: List[float] = []
        served_l: List[float] = []
        queued_l: List[int] = []
        conc_l: List[int] = []
        for r in range(n):
            wl = self.wls[r]
            a = acts[r]
            h = 0
            dl = self._hedge_deadline[r]
            if dl is not None and a < cap_l[r]:
                age = wl.oldest_waiting_s(t)
                if age is not None and age > dl:
                    h = 1
                    self.hedged_cnt[r] += 1
            hedges[r] = h
            used, util, q, c = wl.step_fast(a + h, dt, t, perf_l[r])
            utils_l.append(util)
            served_l.append(used)
            queued_l.append(q)
            conc_l.append(c)
            if wl._completed:
                self.responses[r].extend(wl.drain())
        utils = np.asarray(utils_l, float)
        served = np.asarray(served_l, float)
        queued = np.asarray(queued_l, np.int64)
        conc = np.asarray(conc_l, np.int64)
        h_arr = np.asarray(hedges, np.int64)
        self.backlog = queued > 0
        # UnitPool.charge, elementwise per rack: active units at the
        # rack's OPP (latched dies at the floor point), the borrowed
        # hedge unit at the requested point, the rest at the gated floor
        u = np.minimum(np.maximum(utils, 0.0), 1.0)
        ug = u**self.gamma
        w_req = self.p_idle + self.spk_tab[self._rr, opp_eff] * ug
        h_f = h_arr.astype(float)
        powered = new_active + h_arr
        powered_f = powered.astype(float)
        p_act = k_f * w_req
        w_low = None
        if latched_any:
            w_low = self.p_idle + self.spk_tab[:, 0] * ug
            ti = self.t_idx
            mixed = c_low_f * w_low[ti] + (k_f[ti] - c_low_f) * w_req[ti]
            p_act[ti] = np.where(floor_all, k_f[ti] * w_low[ti], mixed)
        p_units = np.where(self.has_table, p_act + h_f * w_req, powered_f * w_req)
        fan_w = np.zeros(n)
        if self.therm is not None:
            th = self.therm
            ti = self.t_idx
            if am is None:
                am = th.local_idx < new_active[ti][th.rack_u]
            pw = th._pw
            np.copyto(pw, self.p_base[ti][th.rack_u])
            np.copyto(pw, w_req[ti][th.rack_u], where=am)
            if latched_any:
                np.copyto(pw, w_low[ti][th.rack_u], where=am & th.latched)
            for j in np.nonzero(h_arr[ti] > 0)[0]:
                pw[th.last_unit[j]] = w_req[ti[j]]
            f_t, temp_t, thr_t = th.step(
                dt, pw, fan_fail=self.chaos_fan[ti] if chaos else None
            )
            fan_w[ti] = f_t
            self._fan_rows.append(f_t)
            self._temp_rows.append(temp_t)
            self._thr_rows.append(thr_t)
        p_rest = (self.n_units - powered).astype(float) * self.p_base
        total = self.p_shared + fan_w + p_units + p_rest
        self.energy += total * dt
        self.unit_energy += p_units * dt
        self.served_acc += served
        util_agg = np.divide(
            powered_f * u,
            powered_f,
            out=np.zeros(n),
            where=powered_f > 0,
        )
        self._t_hist.append(t)
        self._offered_rows.append(rate)
        self._active_rows.append(powered)
        self._power_rows.append(total)
        self._util_rows.append(util_agg)
        if self.obs is not None:
            self._emit_obs(
                t,
                dt,
                total=total,
                opp_eff=opp_eff,
                queued=queued,
                powered=powered,
                powered_f=powered_f,
                h_arr=h_arr,
                util_agg=util_agg,
                fan_w=fan_w,
                p_act=p_act,
                w_req=w_req,
                p_rest=p_rest,
                latched_any=latched_any,
                c_low_f=c_low_f,
                w_low=w_low,
            )
        self.now = t + dt
        return queued, conc

    def _emit_obs(
        self,
        t: float,
        dt: float,
        *,
        total: np.ndarray,
        opp_eff: np.ndarray,
        queued: np.ndarray,
        powered: np.ndarray,
        powered_f: np.ndarray,
        h_arr: np.ndarray,
        util_agg: np.ndarray,
        fan_w: np.ndarray,
        p_act: np.ndarray,
        w_req: np.ndarray,
        p_rest: np.ndarray,
        latched_any: bool,
        c_low_f: Optional[np.ndarray],
        w_low: Optional[np.ndarray],
    ) -> None:
        """Ledger leaves + probe row for one tick. The ledger arrays
        replay bitwise: ``active_w + hedge_w`` re-performs the exact
        binary add this tick's ``p_units`` came from (table racks), or
        adds ``0.0`` — a bitwise no-op on the non-negative draws —
        for racks without one (see ``repro_torch.obs.attribution``)."""
        obs = self.obs
        assert obs is not None
        n = len(self.wls)
        ledger = obs.ledger
        if ledger is not None:
            h_f = h_arr.astype(float)
            active_w = np.where(self.has_table, p_act, powered_f * w_req)
            hedge_w = np.where(self.has_table, h_f * w_req, 0.0)
            floor_units = floor_w = None
            if latched_any:
                assert c_low_f is not None and w_low is not None
                ti = self.t_idx
                floor_units = np.zeros(n)
                floor_units[ti] = c_low_f
                floor_w = np.zeros(n)
                floor_w[ti] = w_low[ti]
            ledger.record_fleet_tick(
                t,
                dt,
                fan_w=fan_w,
                active_w=active_w,
                hedge_w=hedge_w,
                rest_w=p_rest,
                hedge_units=h_arr,
                rest_units=self.n_units - powered,
                floor_units=floor_units,
                floor_w=floor_w,
            )
        probes = obs.probes
        if probes is not None and probes.active:
            # shared all-zeros row: never mutated, so sinks may keep a
            # reference across ticks without copying
            zeros = self._obs_zeros
            if zeros is None:
                zeros = self._obs_zeros = np.zeros(n)
            row = {
                "power_w": total,
                "queued": queued.astype(float),
                "active_units": powered.astype(float),
                "waking_units": zeros,
                "utilization": util_agg,
                "opp_index": (
                    np.where(self.has_table, opp_eff, 0).astype(float)
                    if self._any_table
                    else zeros
                ),
                "hedge_units": (
                    h_arr.astype(float) if self._any_hedge else zeros
                ),
            }
            if self.therm is not None and self._temp_rows:
                ti = self.t_idx
                temp = np.full(n, np.nan)
                temp[ti] = self._temp_rows[-1]
                thr = np.zeros(n)
                thr[ti] = self._thr_rows[-1]
                row["max_temp_c"] = temp
                row["throttled_units"] = thr
            probes.emit_tick(t, dt, row)

    def per_rack_telemetry(self) -> List[Telemetry]:
        ts = np.asarray(self._t_hist, float)
        offered = np.stack(self._offered_rows)  # (ticks, racks)
        active = np.stack(self._active_rows)
        power = np.stack(self._power_rows)
        util = np.stack(self._util_rows)
        empty = np.zeros(0)
        if self.therm is not None and self._fan_rows:
            fan = np.stack(self._fan_rows)  # (ticks, thermal racks)
            temp = np.stack(self._temp_rows)
            thr = np.stack(self._thr_rows)
            col_of = {int(r): j for j, r in enumerate(self.t_idx)}
        else:
            fan = temp = thr = None
            col_of = {}
        out = []
        for r in range(len(self.wls)):
            p50, p99 = latency_percentiles(self.responses[r])
            j = col_of.get(r)
            if j is None:
                temp_r = thr_r = fan_r = empty
            else:
                temp_r = temp[:, j].copy()
                thr_r = thr[:, j].astype(float)
                fan_r = fan[:, j].copy()
            out.append(
                Telemetry(
                    time_s=ts,
                    offered_load=offered[:, r].copy(),
                    active_units=active[:, r].astype(float),
                    power_w=power[:, r].copy(),
                    utilization=util[:, r].copy(),
                    served=float(self.served_acc[r]),
                    hedged=int(self.hedged_cnt[r]),
                    scale_events=int(self.scale_events[r]),
                    p50_latency_s=p50,
                    p99_latency_s=p99,
                    energy_j=float(self.energy[r]),
                    unit_energy_j=float(self.unit_energy[r]),
                    responses=list(self.responses[r]),
                    workload=self.wls[r].describe(),
                    max_temp_c=temp_r,
                    throttled_units=thr_r,
                    fan_power_w=fan_r,
                )
            )
        return out


class Fleet:
    """N racks + a router, played against a fleet-level offered load.

    ``dt_s`` is fixed at construction (the per-rack rate windows are
    sized to it). ``play_trace`` advances tick by tick: route the
    tick's offered rps across racks, submit each rack's shard, advance
    every rack's governor/queue/power integral, then keep ticking until
    every queue drains.
    """

    def __init__(
        self,
        racks: Sequence[RackConfig],
        router: Optional[Router] = None,
        dt_s: float = 60.0,
        backend: str = "vector",
        idle_units_off: bool = True,
        sanitize: Optional[bool] = None,
        obs: Optional["FleetObs"] = None,
        chaos: Optional[ChaosSchedule] = None,
        degrade: Optional[DegradePolicy] = None,
        device: str = "cuda",
    ) -> None:
        assert racks, "need at least one rack"
        self.racks = list(racks)
        self.router = router or JoinShortestQueueRouter()
        self.dt_s = dt_s
        self.backend = backend
        self.engine: Any
        if backend == "scalar":
            self.engine = _ScalarFleetEngine(self.racks, dt_s, idle_units_off)
        elif backend == "vector":
            self.engine = _VectorFleetEngine(self.racks, dt_s, idle_units_off)
        elif backend == "torch":
            # deferred import: torch is optional for the other backends
            from repro_torch.fleet.torch_engine import _TorchFleetEngine

            self.engine = _TorchFleetEngine(
                self.racks, dt_s, idle_units_off, self.router, device=device
            )
        else:
            raise ValueError(
                f"unknown fleet backend {backend!r}; "
                "use 'scalar', 'vector', or 'torch'"
            )
        self._capacity = np.array(
            [rc.spec.n_units * rc.unit_rate for rc in self.racks], float
        )
        self._n_units = np.array([rc.spec.n_units for rc in self.racks], np.int64)
        self._jpr = np.array(
            [
                (rc.spec.p_shared + rc.spec.n_units * rc.spec.unit.power(1.0))
                / (rc.spec.n_units * rc.unit_rate)
                for rc in self.racks
            ],
            float,
        )
        self.rack_names = [
            rc.name or f"{rc.spec.name}/{i}" for i, rc in enumerate(self.racks)
        ]
        self.chaos = chaos
        self._lowered: Optional[LoweredChaos] = None
        self.chaos_monitor: Optional[ChaosMonitor] = None
        if chaos is not None:
            self._lowered = chaos.lower([int(u) for u in self._n_units])
            if hasattr(self.engine, "set_chaos"):
                # jax: lowered once into per-tick mask rows, scanned
                self.engine.set_chaos(self._lowered)
            else:
                self.engine.chaos_on_kill = self._lowered.on_kill
            # a rack that misses two tick heartbeats is declared failed
            self.chaos_monitor = ChaosMonitor(
                self.n_racks, timeout_s=2.0 * dt_s
            )
        self.degrade = degrade
        self._degrade_lowered: Optional[LoweredDegrade] = None
        self._degrade_driver: Optional[DegradeDriver] = None
        self._tier_payloads: List[Optional[str]] = []
        if degrade is not None:
            low = degrade.lower([int(u) for u in self._n_units], dt_s)
            self._degrade_lowered = low
            # tier payloads tag each sub-request; the trailing None slot
            # is untiered chaos respill (bypasses admission)
            self._tier_payloads = [t.name for t in low.tiers] + [None]
            if hasattr(self.engine, "set_degrade"):
                # jax: lowered to branchless per-tick rows in the scan
                self.engine.set_degrade(low)
            else:
                # ONE driver instance serves whichever host engine runs,
                # so scalar and vector degradation decisions are the
                # same Python objects (bitwise parity by construction)
                self._degrade_driver = DegradeDriver(low)
        # cumulative per-tick driver history (grows across play_trace calls,
        # in lockstep with the engines' own cumulative state)
        self._offered: List[float] = []
        self._assigned: List[np.ndarray] = []
        self._queued_rows: List[np.ndarray] = []
        self._wall_s = 0.0
        self._drained = True
        self.obs = obs
        if obs is not None:
            self._wire_obs(obs)
        from repro_torch.runtime.sanitize import (attach_fleet_sanitizer,
                                            resolve_sanitize)
        if resolve_sanitize(sanitize):
            attach_fleet_sanitizer(self)

    def _wire_obs(self, obs: "FleetObs") -> None:
        """Bind the observability config into whichever engine runs.

        The scalar engine's ledger surface is each rack's own
        ``UnitPool.charge`` (pool-side leaves, per tenant); the vector
        engine records per-rack arrays per tick; the jax engine stays
        pure inside ``lax.scan`` and its rows are expanded host-side
        after each ``play`` (``_obs_expand_jax``)."""
        if obs.probes is not None:
            obs.probes.bind(self.rack_names)
        self.engine.obs = obs
        ledger = obs.ledger
        if ledger is None:
            return
        if self.backend == "scalar":
            for name, rt in zip(self.rack_names, self.engine.rts):
                rt.pool.attach_ledger(ledger, rack=name)
        elif self.backend == "vector":
            ledger.register_fleet(self.rack_names, self.engine.p_shared)
        else:
            # jax: the scan reorders/fuses float ops, so the replay is
            # promised within the engines' documented parity tolerance
            # (the fig16 gate), not bitwise
            ledger.tolerance = 1e-9
            ledger.register_fleet(
                self.rack_names, self.engine.arrays.p_shared
            )

    @property
    def n_racks(self) -> int:
        return len(self.racks)

    @property
    def capacity_rps(self) -> float:
        """Aggregate peak service rate of the fleet."""
        return float(self._capacity.sum())  # reprolint: ok[RPL001] roll-up-only fleet metric; never enters the bitwise-compared telemetry

    def view(self) -> FleetView:
        capacity = self._capacity
        alive = None
        if self._lowered is not None:
            # routers see the degraded fleet: killed units shrink a
            # rack's advertised capacity, a fully dead rack is excluded
            # outright (alive mask). With no live fault both fields are
            # bitwise the no-chaos view.
            dead = getattr(self.engine, "chaos_dead", None)
            if dead is not None and dead.any():
                live = (self._n_units - dead).astype(float)
                capacity = self._capacity * (
                    live / self._n_units.astype(float)
                )
                alive = dead < self._n_units
        return FleetView(
            t=self.engine.now,
            dt_s=self.dt_s,
            capacity_rps=capacity,
            queued_cost=self.engine.queued_cost(),
            active_units=self.engine.active_units(),
            n_units=self._n_units,
            full_load_j_per_req=self._jpr,
            alive=alive,
        )

    def _chaos_step(self) -> float:
        """Apply the schedule's masks at the engine clock's current
        tick; returns the respill *rate* (rps) to fold into this tick's
        routed total (0.0 unless a full-rack kill edge fired under
        ``on_kill="respill"``)."""
        assert self._lowered is not None
        dead, fan, cap = self._lowered.masks_at(self.engine.now)
        if self.chaos_monitor is not None:
            self.chaos_monitor.observe(self.engine.now, dead, self._n_units)
        return self.engine.apply_chaos(dead, fan, cap) / self.dt_s

    def _degrade_pre(
        self, rps: float, respill_rps: float
    ) -> Tuple[float, Optional[List[Tuple[Optional[str], float]]], FleetView]:
        """One tick of the degradation control plane (host engines):
        deadline expiry, then breaker/retry/admission in the shared
        :class:`DegradeDriver`, then the breaker-scaled router view.
        Returns ``(routed_total_rps, tier_split, view)``."""
        drv = self._degrade_driver
        low = self._degrade_lowered
        assert drv is not None and low is not None
        deadline = low.policy.queue_deadline_s
        if deadline is not None:
            self.engine.expire(deadline)
        view = self.view()  # chaos-degraded capacity, post-expiry queue
        total, frac = drv.pre_route(
            len(self._offered),
            rps,
            respill_rps,
            view.queued_cost,
            view.capacity_rps,
            self.engine.chaos_dead,
        )
        split = None
        if frac is not None:
            split = list(zip(self._tier_payloads, frac.tolist()))
        if low.breaker_on:
            view = view.scaled(drv.breaker_scale())
        return total, split, view

    def play_trace(
        self, trace_rps: Sequence[float], drain: bool = True
    ) -> FleetTelemetry:
        """Route and serve ``trace_rps`` tick by tick, then keep ticking
        until every rack's queue drains (bounded by a 10x-trace-length
        safety cap; if backlog still remains — a sustained-overload
        trace — the returned telemetry carries ``drained=False`` and its
        latency percentiles cover completed requests only). The
        telemetry always covers the fleet's *entire* history — calling
        ``play_trace`` again continues the same simulation (clock,
        queues, energy) and returns the cumulative roll-up, mirroring
        the engines' own cumulative state."""
        dt = self.dt_s
        trace = np.asarray(trace_rps, float)
        t0 = time.perf_counter()
        if hasattr(self.engine, "play"):
            # jax engine: routing happens in-scan, the whole trace plus
            # drain runs as one jitted program
            assigned, queued_rows, n_drain, jdrained = self.engine.play(
                trace, drain=drain
            )
            # chaos respill re-entered the in-scan routed total; mirror
            # it into the driver's offered series (the scalar/vector
            # loops add _chaos_step's respill rate before routing)
            extra = None
            n_new = len(trace) + n_drain
            if (
                self._lowered is not None
                and self._lowered.on_kill == "respill"
                and n_new > 0
            ):
                ev = self.engine._full("evac")
                if ev.shape[0] >= n_new:
                    extra = ev[-n_new:].sum(axis=1) / dt  # reprolint: ok[RPL001] jax tolerance-parity: post-hoc roll-up of finished host rows
            # with degradation on the offered series is the *admitted*
            # total the scan actually routed (post-shed, plus released
            # retries and respill) — the same total the host drivers
            # append after DegradeDriver.pre_route
            adm = None
            if self._degrade_lowered is not None and n_new > 0:
                rows = self.engine._full("dg_admitted")
                if rows.shape[0] >= n_new:
                    adm = rows[-n_new:]
            for i, rps in enumerate(trace):
                if adm is not None:
                    off = float(adm[i])
                else:
                    off = float(rps)
                    if extra is not None:
                        off += float(extra[i])
                self._offered.append(off)
                self._assigned.append(np.asarray(assigned[i], float))
            for j in range(n_drain):
                if adm is not None:
                    off = float(adm[len(trace) + j])
                else:
                    off = 0.0
                    if extra is not None:
                        off += float(extra[len(trace) + j])
                self._offered.append(off)
                self._assigned.append(
                    np.asarray(assigned[len(trace) + j], float)
                )
            if self.chaos_monitor is not None and n_new > 0:
                # replay the tick heartbeats the in-scan run could not
                # deliver live (tick-deterministic, same masks)
                assert self._lowered is not None
                for t in np.asarray(self.engine._t_hist, float)[-n_new:]:
                    d, _, _ = self._lowered.masks_at(float(t))
                    self.chaos_monitor.observe(float(t), d, self._n_units)
            for row in queued_rows:
                self._queued_rows.append(np.asarray(row, np.int64))
            if jdrained is not None:
                self._drained = bool(jdrained)
            n_rows = len(trace) + n_drain
            if self.obs is not None and n_rows > 0:
                self._obs_expand_jax(n_rows)
            self._wall_s += time.perf_counter() - t0
            return self._build_telemetry()
        zero = np.zeros(self.n_racks)
        queued = conc = None
        lowered = self._lowered
        drv = self._degrade_driver
        for rps in trace:
            respill = self._chaos_step() if lowered is not None else 0.0
            if drv is not None:
                total, split, view = self._degrade_pre(float(rps), respill)
            else:
                total, split, view = float(rps) + respill, None, self.view()
            assign = np.asarray(self.router.route(total, view), float)
            self._offered.append(total)
            self._assigned.append(assign)
            queued, conc = self.engine.tick(assign, dt, tier_split=split)
            self._queued_rows.append(queued)
        if drain:
            for _ in range(10 * len(trace) + 100):
                respill = self._chaos_step() if lowered is not None else 0.0
                if drv is not None:
                    # released retry mass re-enters during drain, routed
                    # like any offered load
                    total, split, view = self._degrade_pre(0.0, respill)
                else:
                    total, split, view = respill, None, None
                if total > 0.0:
                    # a kill edge during drain respills the dead rack's
                    # backlog through the router like any offered load
                    assign = np.asarray(
                        self.router.route(
                            total, view if view is not None else self.view()
                        ),
                        float,
                    )
                else:
                    assign = zero
                self._offered.append(total)
                self._assigned.append(assign)
                queued, conc = self.engine.tick(assign, dt, tier_split=split)
                self._queued_rows.append(queued)
                ring = drv.ring_mass() if drv is not None else 0.0
                if (
                    int(queued.sum()) == 0 and int(conc.sum()) == 0  # reprolint: ok[RPL001] zero-test only: sum()==0 iff all elements are 0, order-free
                    and ring <= 0.0
                ):
                    break
        if queued is not None:
            self._drained = (
                int(queued.sum()) == 0 and int(conc.sum()) == 0  # reprolint: ok[RPL001] zero-test only: sum()==0 iff all elements are 0, order-free
                and (drv is None or drv.ring_mass() <= 0.0)
            )
        self._wall_s += time.perf_counter() - t0
        return self._build_telemetry()

    # ------------------------------------------------------------------
    def _obs_expand_jax(self, n_rows: int) -> None:
        """Expand the jax engine's scanned per-tick rows (the last
        ``n_rows`` of its cumulative history) into the obs surfaces.
        The jitted scan stays pure — it only emits the extra arrays
        (``opp``, ``w_req``, thermal floor counts) when obs is attached
        — and this host loop mirrors the vector engine's per-tick
        emission, so ledger causes and probe rows match the other
        backends (ledger replay within ``ledger.tolerance``)."""
        obs = self.obs
        assert obs is not None
        eng = self.engine
        arr = eng.arrays
        dt = eng.dt_s
        n = eng.n_racks
        ts = np.asarray(eng._t_hist, float)[-n_rows:]
        power = eng._full("power")[-n_rows:]
        active = eng._full("active")[-n_rows:]
        util = eng._full("util")[-n_rows:]
        hedge = eng._full("hedge")[-n_rows:]
        opp_rows = eng._full("opp")[-n_rows:]
        queued = np.stack(self._queued_rows[-n_rows:])
        thermal = arr.thermal is not None and "temp" in eng._hist
        if thermal:
            t_idx = arr.thermal.t_idx
            temp_rows = np.concatenate(eng._hist["temp"])[-n_rows:]
            thr_rows = np.concatenate(eng._hist["thr"])[-n_rows:]
            fan_rows = np.concatenate(eng._hist["fan"])[-n_rows:]
            c_low_rows = np.concatenate(eng._hist["c_low"])[-n_rows:]
            w_low_rows = np.concatenate(eng._hist["w_low"])[-n_rows:]
        ledger = obs.ledger
        if ledger is not None:
            w_req_rows = eng._full("w_req")[-n_rows:]
            has_table = arr.has_table
            n_units = arr.n_units
            p_base = arr.p_base
            for i in range(n_rows):
                h_i = hedge[i].astype(np.int64)
                pw_cnt = active[i].astype(np.int64)
                k_f = (pw_cnt - h_i).astype(float)
                w_req = w_req_rows[i]
                p_act = k_f * w_req
                fan_w = np.zeros(n)
                floor_units = floor_w = None
                if thermal:
                    c_low = c_low_rows[i]
                    w_low = w_low_rows[i]
                    floor_all = (opp_rows[i][t_idx] == 0) & (c_low > 0)
                    mixed = (
                        c_low * w_low[t_idx]
                        + (k_f[t_idx] - c_low) * w_req[t_idx]
                    )
                    p_act[t_idx] = np.where(
                        floor_all, k_f[t_idx] * w_low[t_idx], mixed
                    )
                    fan_w[t_idx] = fan_rows[i]
                    floor_units = np.zeros(n)
                    floor_units[t_idx] = c_low
                    floor_w = np.zeros(n)
                    floor_w[t_idx] = w_low[t_idx]
                ledger.record_fleet_tick(
                    float(ts[i]),
                    dt,
                    fan_w=fan_w,
                    active_w=np.where(
                        has_table, p_act, pw_cnt.astype(float) * w_req
                    ),
                    hedge_w=np.where(
                        has_table, h_i.astype(float) * w_req, 0.0
                    ),
                    rest_w=(n_units - pw_cnt).astype(float) * p_base,
                    hedge_units=h_i,
                    rest_units=n_units - pw_cnt,
                    floor_units=floor_units,
                    floor_w=floor_w,
                )
        probes = obs.probes
        if probes is not None and probes.active:
            for i in range(n_rows):
                row = {
                    "power_w": power[i].copy(),
                    "queued": queued[i].astype(float),
                    "active_units": active[i].astype(float),
                    "waking_units": np.zeros(n),
                    "utilization": util[i].copy(),
                    "opp_index": np.where(
                        arr.has_table, opp_rows[i], 0
                    ).astype(float),
                    "hedge_units": hedge[i].astype(float),
                }
                if thermal:
                    temp = np.full(n, np.nan)
                    temp[t_idx] = temp_rows[i]
                    thr = np.zeros(n)
                    thr[t_idx] = thr_rows[i]
                    row["max_temp_c"] = temp
                    row["throttled_units"] = thr
                probes.emit_tick(float(ts[i]), dt, row)

    # ------------------------------------------------------------------
    def _build_telemetry(self) -> FleetTelemetry:
        offered = self._offered
        assigned = self._assigned
        queued_rows = self._queued_rows
        wall = self._wall_s
        per_rack = self.engine.per_rack_telemetry()
        power = np.stack([tel.power_w for tel in per_rack])  # (R, T)
        active = np.stack([tel.active_units for tel in per_rack])
        lats = np.array([r.latency_s for tel in per_rack for r in tel.responses])
        if len(lats):
            p50, p95, p99 = (float(np.percentile(lats, q)) for q in (50, 95, 99))
        else:
            p50 = p95 = p99 = 0.0
        tel = FleetTelemetry(
            time_s=per_rack[0].time_s,
            offered_rps=np.asarray(offered, float),
            assigned_rps=np.stack(assigned).T,
            active_units=active,
            power_w=power,
            queued=np.stack(queued_rows).T,
            served=sum(tel.served for tel in per_rack),
            energy_j=sum(tel.energy_j for tel in per_rack),
            p50_latency_s=p50,
            p95_latency_s=p95,
            p99_latency_s=p99,
            per_rack=per_rack,
            rack_names=list(self.rack_names),
            router=getattr(self.router, "name", type(self.router).__name__),
            backend=self.backend,
            wall_s=wall,
            drained=self._drained,
        )
        if self.chaos is not None:
            eng = self.engine
            tel.chaos_events = [e.to_record() for e in self.chaos.events]
            tel.dropped_requests = int(getattr(eng, "chaos_dropped", 0))
            tel.dropped_cost = float(getattr(eng, "chaos_dropped_cost", 0.0))
            tel.respilled_requests = int(getattr(eng, "chaos_respilled", 0))
            tel.respilled_cost = float(
                getattr(eng, "chaos_respilled_cost", 0.0)
            )
            fault_t = self.chaos.fault_t
            if math.isfinite(fault_t):
                tel.recovery = recovery_report(
                    tel,
                    fault_t,
                    dropped_requests=tel.dropped_requests,
                    dropped_cost=tel.dropped_cost,
                    respilled_requests=tel.respilled_requests,
                    respilled_cost=tel.respilled_cost,
                )
        if self.degrade is not None:
            eng = self.engine
            # host backends read the shared driver; the jax engine
            # mirrors the same attribute surface host-side after play
            src: Any = self._degrade_driver if (
                self._degrade_driver is not None) else eng
            tel.degrade_on = True
            tel.shed_cost = float(getattr(src, "shed_cost", 0.0))
            shed_by_tier = np.asarray(
                getattr(src, "shed_by_tier", np.zeros(0)), float)
            tel.shed_by_tier = {
                t.name: float(shed_by_tier[k])
                for k, t in enumerate(self.degrade.tiers)
                if k < len(shed_by_tier)
            }
            tel.shed_cost_t = np.asarray(
                getattr(src, "shed_cost_t", []), float)
            tel.expired_requests = int(getattr(eng, "degrade_expired", 0))
            tel.expired_cost = float(
                getattr(eng, "degrade_expired_cost", 0.0))
            tel.retried_cost = float(getattr(src, "retried_cost", 0.0))
            tel.retry_dropped_cost = float(
                getattr(src, "retry_dropped_cost", 0.0))
            tel.breaker_opens = int(getattr(src, "breaker_opens", 0))
            rows = getattr(src, "breaker_state_t", [])
            bt = (
                np.stack([np.asarray(r, np.int64) for r in rows]).T
                if len(rows)
                else np.zeros((self.n_racks, 0), np.int64)
            )
            tel.breaker_state_t = bt
            # derive open/half/close instants from the state matrix —
            # one shared code path for every backend (trace + summary)
            events: List[dict] = []
            ts = tel.time_s
            for r in range(bt.shape[0]):
                prev = BRK_CLOSED
                for i in range(bt.shape[1]):
                    s = int(bt[r, i])
                    if s != prev:
                        t_ev = (
                            float(ts[i]) if i < len(ts)
                            else i * self.dt_s
                        )
                        events.append({
                            "rack": self.rack_names[r],
                            "t_s": t_ev,
                            "state": s,
                            "prev": prev,
                        })
                    prev = s
            tel.breaker_events = events
        if self.obs is not None and self.obs.slo is not None:
            # evaluate() resets rule state first, so rebuilding telemetry
            # (cumulative across play_trace calls) stays idempotent
            tel.alerts = self.obs.slo.evaluate(tel)
        return tel
