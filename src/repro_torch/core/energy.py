"""Energy accounting and proportionality metrics (paper §4.1, §5.2).

Core quantities:
  * TpE — throughput per energy (streams/W or samples/J), the paper's
    headline comparison metric (Fig 6, Fig 11b).
  * Energy-proportionality index — how closely server power tracks load
    (Barroso & Hölzle's ideal is P(u) = u * P_peak). The SoC Cluster's
    per-unit gating gives ~linear scaling; monolithic GPUs do not (Fig 7/12).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.cluster import ClusterSpec


# ---------------------------------------------------------------------------
# TpE.
# ---------------------------------------------------------------------------
def throughput_per_energy(throughput: float, power_w: float) -> float:
    """throughput in items/s, power in W -> items/J (== items/s/W)."""
    return throughput / max(power_w, 1e-9)


def energy_for_work(items: float, throughput: float, power_w: float) -> float:
    """Joules to process `items` at steady state."""
    return items / max(throughput, 1e-12) * power_w


# ---------------------------------------------------------------------------
# Load -> power curves.
# ---------------------------------------------------------------------------
def cluster_power_at_load(spec: ClusterSpec, load_frac: float,
                          unit_capacity: float = 1.0,
                          idle_units_off: bool = True) -> float:
    """Power when serving `load_frac` of peak load with the fine-grained
    policy: wake ceil(load * n) units at full utilization, gate the rest.
    (The SoC Cluster policy; a monolithic unit must instead run one unit at
    partial utilization — captured by n_units == 1 specs.)"""
    load = min(max(load_frac, 0.0), 1.0)
    if spec.n_units == 1:
        return spec.power(1, load)
    need = load * spec.n_units / unit_capacity
    full = int(np.floor(need))
    frac = need - full
    active_power = (spec.p_shared
                    + full * spec.unit.power(1.0)
                    + (spec.unit.power(frac) if frac > 0 else 0.0))
    rest = spec.n_units - full - (1 if frac > 0 else 0)
    active_power += rest * (spec.unit.p_off if idle_units_off
                            else spec.unit.p_idle)
    return active_power


def dvfs_power_at_load(spec: ClusterSpec, table, load_frac: float,
                       unit_capacity: float = 1.0,
                       idle_units_off: bool = True) -> float:
    """The frequency-resolved load→power curve: for each operating point
    in ``table`` (an :class:`repro_torch.power.opp.OPPTable`), size the unit
    count that meets the load at that point's effective rate and take
    the cheapest feasible (OPP, count) pair — the schedutil governor's
    wide-and-slow vs narrow-and-fast search in closed form. At load 1.0
    only the top OPP with every unit is feasible, so the peak matches
    :func:`cluster_power_at_load` exactly."""
    from repro_torch.power.opp import unit_power as opp_unit_power
    load = min(max(load_frac, 0.0), 1.0)
    unit = spec.unit
    p_rest_1 = unit.p_off if idle_units_off else unit.p_idle
    demand = load * spec.n_units / unit_capacity   # nominal-unit equivalents
    if demand <= 0.0:
        return spec.p_shared + spec.n_units * p_rest_1
    # the binary packing (nominal OPP, full units + one fractional) is
    # always a feasible configuration, so the resolved curve is pointwise
    # ≤ the binary one for every unit model (including gamma < 1, where
    # packing beats spreading utilization evenly)
    best = cluster_power_at_load(spec, load, unit_capacity=unit_capacity,
                                 idle_units_off=idle_units_off)
    for opp in table:
        n_need = max(1, int(np.ceil(demand / opp.perf_scale - 1e-12)))
        if n_need > spec.n_units:
            continue
        util = demand / (n_need * opp.perf_scale)
        p = spec.p_shared + n_need * opp_unit_power(unit, util, opp) \
            + (spec.n_units - n_need) * p_rest_1
        best = min(best, p)
    return float(best)


def proportionality_index(spec: ClusterSpec, idle_units_off: bool = True,
                          n: int = 101,
                          power_fn: Optional[
                              Callable[[ClusterSpec, float], float]] = None
                          ) -> float:
    """1 - mean |P(u)/P_peak - u|, in [0, 1]; 1.0 = perfectly proportional.

    ``power_fn(spec, load) -> W`` swaps in an alternative load→power
    curve (e.g. the frequency-resolved one via
    :func:`dvfs_proportionality_index`); the default is the binary
    per-unit-gating curve :func:`cluster_power_at_load`.
    """
    if power_fn is None:
        power_fn = lambda s, u: cluster_power_at_load(  # noqa: E731
            s, u, idle_units_off=idle_units_off)
    us = np.linspace(0.0, 1.0, n)
    peak = power_fn(spec, 1.0)
    ps = np.array([power_fn(spec, u) for u in us]) / peak
    return float(1.0 - np.mean(np.abs(ps - us)))


def dvfs_proportionality_index(spec: ClusterSpec, table,
                               idle_units_off: bool = True,
                               n: int = 101) -> float:
    """Proportionality of the frequency-resolved curve: per-unit gating
    *plus* DVFS. Never worse than the binary index — the binary
    configuration (nominal OPP, ceil(load·n) units) is one point in the
    per-load search space, so the curve is pointwise ≤ the binary one
    while the peaks coincide."""
    return proportionality_index(
        spec, idle_units_off=idle_units_off, n=n,
        power_fn=lambda s, u: dvfs_power_at_load(
            s, table, u, idle_units_off=idle_units_off))


def dynamic_range(spec: ClusterSpec, idle_units_off: bool = True) -> float:
    """P(idle)/P(peak): lower is better."""
    peak = cluster_power_at_load(spec, 1.0, idle_units_off=idle_units_off)
    idle = cluster_power_at_load(spec, 0.0, idle_units_off=idle_units_off)
    return float(idle / peak)


# ---------------------------------------------------------------------------
# Trace-driven energy accounting.
# ---------------------------------------------------------------------------
@dataclass
class EnergyReport:
    joules: float
    avg_power_w: float
    peak_power_w: float
    items: float
    tpe: float                 # items per joule
    proportionality: float


def account_trace(spec: ClusterSpec, load_trace: Sequence[float],
                  dt_s: float, items_per_s_at_peak: float,
                  idle_units_off: bool = True) -> EnergyReport:
    """Integrate energy over a load trace (fractions of peak load)."""
    powers = np.array([cluster_power_at_load(spec, u,
                                             idle_units_off=idle_units_off)
                       for u in load_trace])
    joules = float(np.sum(powers) * dt_s)
    items = float(np.sum(np.asarray(load_trace) * items_per_s_at_peak * dt_s))
    return EnergyReport(
        joules=joules,
        avg_power_w=float(np.mean(powers)),
        peak_power_w=float(np.max(powers)),
        items=items,
        tpe=items / max(joules, 1e-9),
        proportionality=proportionality_index(spec, idle_units_off),
    )
