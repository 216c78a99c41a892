"""Shared rack-stacking for the array-based fleet engines.

Both the numpy vector engine (``backend="vector"``) and the jax engine
(``backend="jax"``) simulate the fleet as *stacked per-rack arrays*:
activation policies, OPP perf/power tables, governor classifications,
and the flattened per-die RC thermal layout. This module is the single
place that stacking happens — :func:`build_fleet_arrays` turns a rack
list into a :class:`FleetArrays` bundle, and :func:`build_thermal_layout`
flattens every thermal-modelled rack's unit/group topology into a
:class:`ThermalLayout` — so the two engines cannot drift apart in how
they read a :class:`~repro_torch.fleet.fleet.RackConfig`.

Array *construction* here is parity-critical: the vector engine adopts
these arrays verbatim and its telemetry is compared bitwise against the
scalar engine, so values must be produced by exactly the arithmetic the
scalar runtime uses (same expressions, same order). The jax engine
consumes the same arrays but is held to tolerance-based parity (XLA
float semantics differ; see ``repro/fleet/jax_engine.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cluster import UnitSpec
from repro_torch.power.governor import (
    FixedFreqGovernor,
    RaceToIdleGovernor,
    SchedutilGovernor,
    ThermalAwareGovernor,
)
from repro_torch.power.opp import OPPTable
from repro_torch.power.thermal import ThermalModel
from repro_torch.runtime import ScalePolicy

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from repro_torch.fleet.fleet import RackConfig

__all__ = [
    "GOV_NONE",
    "GOV_FIXED",
    "GOV_RACE",
    "GOV_SCHED",
    "GOV_GENERIC",
    "ThermalLayout",
    "FleetArrays",
    "build_thermal_layout",
    "build_fleet_arrays",
]

# governor kinds the stacked selection passes understand; anything else
# falls back (vector engine) to a per-rack select() call with a real
# FreqContext, or is rejected outright (jax engine).
GOV_NONE, GOV_FIXED, GOV_RACE, GOV_SCHED, GOV_GENERIC = range(5)


@dataclass
class ThermalLayout:
    """Static layout of every thermal-modelled rack, flattened.

    Per-die/per-PCB-group topology and RC parameters of all thermal
    racks concatenated in ``t_idx`` order. The mutable state
    (``t_die``/``t_pcb``/``latched``) lives with the engines; this is
    the shared read-only part both build from.
    """

    t_idx: np.ndarray  # fleet rack indices carrying a thermal model
    # per-thermal-rack RC parameters
    r_die: np.ndarray
    c_die: np.ndarray
    r_pcb0: np.ndarray
    c_pcb: np.ndarray
    t_amb: np.ndarray
    fan_low: np.ndarray
    fan_span: np.ndarray
    fan_rmin: np.ndarray
    fan_pmax: np.ndarray
    trip: np.ndarray
    release: np.ndarray
    # flat unit/group layout (racks concatenated in t_idx order)
    n_flat_units: int
    unit_starts: np.ndarray
    group_starts: np.ndarray
    rack_u: np.ndarray
    rack_g: np.ndarray
    local_idx: np.ndarray
    group_of_u: np.ndarray
    last_unit: np.ndarray
    # per-unit/per-group broadcasts of the per-rack constants
    r_die_u: np.ndarray
    c_die_u: np.ndarray
    c_pcb_g: np.ndarray
    t_amb_g: np.ndarray
    # thermal ceilings for governors: constant per rack, computed with
    # the same scalar helper the pool caches
    max_sustainable: List[int] = field(default_factory=list)

    @property
    def n_groups(self) -> int:
        return int(len(self.rack_g))

    def max_substeps(self, dt: float) -> int:
        """Static upper bound on the Euler sub-step count of any rack.

        The per-tick count depends on the fan-modulated ``r_pcb`` in
        ``[r_pcb0 * fan_rmin, r_pcb0]``; the smallest reachable time
        constant (fan flat out) gives the largest count, so a
        ``lax.fori_loop`` over this bound with per-rack live masks
        covers every tick (the jax engine needs a trace-time constant).
        """
        r_pcb_min = self.r_pcb0 * self.fan_rmin
        tau_min = np.minimum(self.r_die * self.c_die, r_pcb_min * self.c_pcb)
        denom = np.maximum(0.25 * tau_min, 1e-6)
        n_sub = np.maximum(1, (dt / denom).astype(np.int64) + 1)
        return int(n_sub.max())


def build_thermal_layout(
    racks: "Sequence[RackConfig]", t_idx: Sequence[int]
) -> ThermalLayout:
    """Flatten the thermal racks' topology + RC parameters (in ``t_idx``
    order), exactly as the stacked vector engine has always laid them
    out — the arithmetic below is byte-for-byte the former
    ``_StackedThermal.__init__``."""
    idx = np.asarray(t_idx, np.int64)
    nt = len(t_idx)
    specs = [racks[r].spec for r in t_idx]
    prms = [racks[r].thermal for r in t_idx]
    assert all(p is not None for p in prms)
    r_die = np.array([p.r_die_c_per_w for p in prms if p is not None])
    c_die = np.array([p.c_die_j_per_c for p in prms if p is not None])
    r_pcb0 = np.array([p.r_pcb_c_per_w for p in prms if p is not None])
    c_pcb = np.array([p.c_pcb_j_per_c for p in prms if p is not None])
    t_amb = np.array([p.t_ambient_c for p in prms if p is not None])
    fan_low = np.array([p.fan_t_low_c for p in prms if p is not None])
    fan_span = np.array(
        [max(p.fan_t_high_c - p.fan_t_low_c, 1e-9) for p in prms if p is not None]
    )
    fan_rmin = np.array([p.fan_r_scale_min for p in prms if p is not None])
    fan_pmax = np.array([p.fan_p_max_w for p in prms if p is not None])
    trip = np.array([p.t_trip_c for p in prms if p is not None])
    release = np.array([p.t_release_c for p in prms if p is not None])
    unit_starts: List[int] = []
    group_starts: List[int] = []  # group segment starts, flat pcb
    rack_u: List[int] = []
    rack_g: List[int] = []
    local_idx: List[int] = []
    group_of_u: List[int] = []
    last_unit = np.zeros(nt, np.int64)
    u0 = g0 = 0
    for j, spec in enumerate(specs):
        unit_starts.append(u0)
        group_starts.append(g0)
        groups = spec.groups()
        for _ in groups:
            rack_g.append(j)
        for u in range(spec.n_units):
            rack_u.append(j)
            local_idx.append(u)
            group_of_u.append(g0 + u // spec.group_size)
        last_unit[j] = u0 + spec.n_units - 1
        u0 += spec.n_units
        g0 += len(groups)
    rack_u_a = np.asarray(rack_u, np.int64)
    rack_g_a = np.asarray(rack_g, np.int64)
    max_sustainable: List[int] = []
    for r in t_idx:
        tm = ThermalModel(racks[r].spec, racks[r].thermal)
        max_sustainable.append(
            tm.max_sustainable_index(racks[r].spec.unit, racks[r].opp_table)
        )
    return ThermalLayout(
        t_idx=idx,
        r_die=r_die,
        c_die=c_die,
        r_pcb0=r_pcb0,
        c_pcb=c_pcb,
        t_amb=t_amb,
        fan_low=fan_low,
        fan_span=fan_span,
        fan_rmin=fan_rmin,
        fan_pmax=fan_pmax,
        trip=trip,
        release=release,
        n_flat_units=u0,
        unit_starts=np.asarray(unit_starts, np.int64),
        group_starts=np.asarray(group_starts, np.int64),
        rack_u=rack_u_a,
        rack_g=rack_g_a,
        local_idx=np.asarray(local_idx, np.int64),
        group_of_u=np.asarray(group_of_u, np.int64),
        last_unit=last_unit,
        r_die_u=r_die[rack_u_a],
        c_die_u=c_die[rack_u_a],
        c_pcb_g=c_pcb[rack_g_a],
        t_amb_g=t_amb[rack_g_a],
        max_sustainable=max_sustainable,
    )


@dataclass
class FleetArrays:
    """Every static per-rack array the stacked engines consume."""

    n_racks: int
    # activation policy + power model, stacked per rack
    n_units: np.ndarray
    unit_rate: np.ndarray
    headroom: np.ndarray
    min_units: np.ndarray
    minq: np.ndarray
    cooldown: np.ndarray
    p_shared: np.ndarray
    p_idle: np.ndarray
    p_peak: np.ndarray
    gamma: np.ndarray
    span: np.ndarray
    p_base: np.ndarray
    # frequency axis: stacked OPP tables + governor classification
    has_table: np.ndarray
    K: np.ndarray
    Kmax: int
    perf_tab: np.ndarray  # (racks, Kmax)
    spk_tab: np.ndarray  # (racks, Kmax) span * power_scale
    opp0: np.ndarray  # initial (nominal) OPP per rack
    nominal: np.ndarray
    highest: np.ndarray
    gov_kind: np.ndarray
    fixed_opp: np.ndarray
    sched_headroom: np.ndarray
    ceiling: np.ndarray  # thermal-aware clamp
    has_ceiling: np.ndarray
    generic: List[Tuple[int, object]]
    # per-rack objects the (generic) scalar fallbacks need
    tables: List[Optional[OPPTable]]
    unit_specs: List[UnitSpec]
    max_sust: List[Optional[int]]
    # hedging config (None = off), per rack
    hedge_deadline: List[Optional[float]]
    names: List[str]
    # thermal stacking (None when no rack carries a thermal model)
    t_idx: np.ndarray
    thermal: Optional[ThermalLayout]

    @property
    def any_hedge(self) -> bool:
        return any(dl is not None for dl in self.hedge_deadline)

    @property
    def capacity_rps(self) -> np.ndarray:
        """Per-rack peak service rate (``n_units * unit_rate``) — the
        denominator of every queue-delay estimate (routers, breakers,
        the jax degradation lowering)."""
        return self.n_units.astype(float) * self.unit_rate


def build_fleet_arrays(
    racks: "Sequence[RackConfig]", idle_units_off: bool
) -> FleetArrays:
    """Stack a rack list into :class:`FleetArrays`.

    The arithmetic is lifted verbatim from the vector engine's former
    constructor — the vector engine adopts these arrays as-is, so the
    refactor is bitwise-neutral by construction.
    """
    for rc in racks:
        if rc.thermal is not None and rc.opp_table is None:
            raise AssertionError(
                "thermal throttling needs an opp_table to throttle within"
            )
    pols = [rc.policy or ScalePolicy() for rc in racks]
    units = [rc.spec.unit for rc in racks]
    n_units = np.array([rc.spec.n_units for rc in racks], np.int64)
    min_units = np.array([p.min_units for p in pols], np.int64)
    p_idle = np.array([u.p_idle for u in units], float)
    p_peak = np.array([u.p_peak for u in units], float)
    span = p_peak - p_idle
    n = len(racks)
    # --- frequency axis: stacked OPP tables + governor classification
    has_table = np.array([rc.opp_table is not None for rc in racks], bool)
    K = np.array(
        [len(rc.opp_table) if rc.opp_table is not None else 1 for rc in racks],
        np.int64,
    )
    Kmax = int(K.max())
    # (racks, opps) perf and span*power_scale tables; rows of racks
    # without a table carry the nominal point, columns past a short
    # table replicate its top point (masked out of every search)
    perf_tab = np.ones((n, Kmax), float)
    spk_tab = np.repeat(span[:, None], Kmax, axis=1)
    opp0 = np.zeros(n, np.int64)
    for r, rc in enumerate(racks):
        tb = rc.opp_table
        if tb is None:
            continue
        for c in range(Kmax):
            p = tb[min(c, len(tb) - 1)]
            perf_tab[r, c] = p.perf_scale
            spk_tab[r, c] = span[r] * p.power_scale
        opp0[r] = tb.nominal
    nominal = opp0.copy()
    highest = K - 1
    # thermal stacking (before classification: ceilings come from it)
    t_idx = [r for r, rc in enumerate(racks) if rc.thermal is not None]
    thermal = build_thermal_layout(racks, t_idx) if t_idx else None
    max_sust: List[Optional[int]] = [None] * n
    if thermal is not None:
        for j, r in enumerate(t_idx):
            max_sust[r] = thermal.max_sustainable[j]
    # classify each rack's governor for the stacked selection passes
    gov_kind = np.full(n, GOV_NONE, np.int64)
    fixed_opp = np.zeros(n, np.int64)
    sched_headroom = np.zeros(n, float)
    ceiling = highest.copy()  # thermal-aware clamp
    has_ceiling = np.zeros(n, bool)
    generic: List[Tuple[int, object]] = []
    for r, (rc, pol) in enumerate(zip(racks, pols)):
        gov = pol.freq_governor
        tb = rc.opp_table
        if tb is None or gov is None:
            continue  # frequency axis off / pinned at nominal
        inner = gov
        if type(gov) is ThermalAwareGovernor:
            inner = gov.inner
            if max_sust[r] is not None:
                ceiling[r] = max_sust[r]  # type: ignore[assignment]
                has_ceiling[r] = True
        if type(inner) is FixedFreqGovernor:
            gov_kind[r] = GOV_FIXED
            fixed_opp[r] = (
                tb.highest if inner.index is None else tb.clamp(inner.index)
            )
        elif type(inner) is RaceToIdleGovernor:
            gov_kind[r] = GOV_RACE
        elif type(inner) is SchedutilGovernor:
            gov_kind[r] = GOV_SCHED
            sched_headroom[r] = (
                inner.headroom if inner.headroom is not None else pol.headroom
            )
        else:
            gov_kind[r] = GOV_GENERIC
            generic.append((r, gov))
    return FleetArrays(
        n_racks=n,
        n_units=n_units,
        unit_rate=np.array([rc.unit_rate for rc in racks], float),
        headroom=np.array([p.headroom for p in pols], float),
        min_units=min_units,
        minq=np.maximum(1, np.minimum(min_units, n_units)),
        cooldown=np.array([p.cooldown_s for p in pols], float),
        p_shared=np.array([rc.spec.p_shared for rc in racks], float),
        p_idle=p_idle,
        p_peak=p_peak,
        gamma=np.array([u.gamma for u in units], float),
        span=span,
        p_base=np.array(
            [u.p_off if idle_units_off else u.p_idle for u in units],
            float,
        ),
        has_table=has_table,
        K=K,
        Kmax=Kmax,
        perf_tab=perf_tab,
        spk_tab=spk_tab,
        opp0=opp0,
        nominal=nominal,
        highest=highest,
        gov_kind=gov_kind,
        fixed_opp=fixed_opp,
        sched_headroom=sched_headroom,
        ceiling=ceiling,
        has_ceiling=has_ceiling,
        generic=generic,
        tables=[rc.opp_table for rc in racks],
        unit_specs=units,
        max_sust=max_sust,
        hedge_deadline=[p.hedge_after_s for p in pols],
        names=[rc.name or f"rack{i}" for i, rc in enumerate(racks)],
        t_idx=np.asarray(t_idx, np.int64),
        thermal=thermal,
    )
