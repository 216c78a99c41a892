"""Pluggable frequency-scaling governors.

A frequency governor answers one question each tick, per tenant: *which
operating point should this tenant's units run at?* It composes with
the existing activation policy (:class:`~repro_torch.runtime.policy.
UnitGovernor`): the activation side then sizes the unit count against
the chosen OPP's effective service rate, so the pair co-optimizes
"how many units × how fast each runs".

Governors mirror the Linux cpufreq vocabulary:

  * :class:`FixedFreqGovernor` — pin one OPP (``performance`` when
    pinned to the top of the table, ``powersave`` at the bottom);
  * :class:`RaceToIdleGovernor` — top OPP whenever there is work,
    nominal otherwise (finish fast, gate off sooner);
  * :class:`SchedutilGovernor` — the lowest-energy (OPP, unit-count)
    pair that still meets demand × headroom, found by exhaustive search
    over the (small) OPP table — this is where wide-and-slow beats
    narrow-and-fast when V² savings outweigh extra idle floors;
  * :class:`ThermalAwareGovernor` — wraps any of the above and clamps
    its choice to the thermally sustainable ceiling, trading peak speed
    for never tripping the throttle latch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Protocol, runtime_checkable

from repro_torch.core.cluster import UnitSpec
from repro_torch.power.opp import OPPTable


@dataclass
class FreqContext:
    """Everything a governor may consult for one tick's decision."""

    demand_rate: float               # windowed offered rate (req/s)
    unit_rate: float                 # nominal per-unit rate (req/s @ OPP_nom)
    headroom: float                  # ScalePolicy.headroom
    n_units: int                     # pool size available to the tenant
    table: OPPTable
    unit: UnitSpec
    min_units: int = 1
    max_sustainable: Optional[int] = None   # thermal ceiling (OPP index)
    backlog: bool = False            # tenant had queued work last tick
    p_gated_w: float = 0.0           # per-unit draw of a *non-active*
    #   unit (p_off when idle units are gated, p_idle otherwise) — part
    #   of schedutil's objective so wide-and-slow pays for the narrower
    #   option's cheaper floor


@runtime_checkable
class FreqGovernor(Protocol):
    """Structural protocol: one OPP index per tick."""

    def select(self, ctx: FreqContext) -> int:
        ...


class FixedFreqGovernor:
    """Pin every unit to one OPP (``None`` = the top of the table — the
    cpufreq ``performance`` governor)."""

    def __init__(self, index: Optional[int] = None) -> None:
        self.index = index

    def select(self, ctx: FreqContext) -> int:
        return ctx.table.highest if self.index is None \
            else ctx.table.clamp(self.index)


class RaceToIdleGovernor:
    """Sprint at the top OPP while there is demand or backlog, drop to
    nominal when idle: finishing sooner lets the activation side gate
    units off sooner."""

    def select(self, ctx: FreqContext) -> int:
        if ctx.demand_rate > 0.0 or ctx.backlog:
            return ctx.table.highest
        return ctx.table.nominal


class SchedutilGovernor:
    """Lowest-OPP-meeting-demand-with-headroom, jointly with the unit
    count: for each OPP, size the activation (ceil of demand × headroom
    over the OPP's effective rate), predict the tenant's unit power, and
    take the cheapest feasible pair. Ties break toward the lower OPP
    (less thermal pressure for the same energy)."""

    def __init__(self, headroom: Optional[float] = None) -> None:
        # None: inherit the activation policy's headroom from the context
        self.headroom = headroom
        # per-(table, unit) constants, memoized by identity — the runtime
        # hands the same table/unit objects every tick, and this method
        # is on the per-tick hot path of every DVFS simulation
        self._tbl = self._unit = None
        self._ps: "list[float]" = []
        self._spk: "list[float]" = []

    def select(self, ctx: FreqContext) -> int:
        need = ctx.demand_rate * (self.headroom if self.headroom is not None
                                  else ctx.headroom)
        if need <= 0.0:
            return ctx.table.lowest
        if self._tbl is not ctx.table or self._unit is not ctx.unit:
            span = ctx.unit.p_peak - ctx.unit.p_idle
            self._ps = [p.perf_scale for p in ctx.table.points]
            self._spk = [span * p.power_scale for p in ctx.table.points]
            self._tbl, self._unit = ctx.table, ctx.unit
        p_idle, gamma = ctx.unit.p_idle, ctx.unit.gamma
        best_idx, best_power = ctx.table.highest, math.inf
        for idx in range(len(self._ps)):
            eff_rate = ctx.unit_rate * self._ps[idx]
            n = max(ctx.min_units, math.ceil(need / eff_rate))
            if n > ctx.n_units:
                continue                      # can't meet demand this slow
            util = min(1.0, ctx.demand_rate / (n * eff_rate))
            # inlined unit_power(ctx.unit, util, table[idx]) — identical
            # association, with span * power_scale folded into _spk
            power = n * (p_idle + self._spk[idx] * util ** gamma) \
                + (ctx.n_units - n) * ctx.p_gated_w
            if power < best_power - 1e-12:
                best_idx, best_power = idx, power
        return best_idx


class ThermalAwareGovernor:
    """Clamp an inner governor's choice to the sustainable ceiling the
    thermal model reports, so units never hit the trip latch (flat
    sustained throughput instead of throttle-induced sag)."""

    def __init__(self, inner: Optional[FreqGovernor] = None) -> None:
        self.inner = inner or FixedFreqGovernor()

    def select(self, ctx: FreqContext) -> int:
        choice = self.inner.select(ctx)
        if ctx.max_sustainable is None:
            return choice
        return min(choice, ctx.max_sustainable)


GOVERNORS = {
    "fixed": FixedFreqGovernor,
    "race-to-idle": RaceToIdleGovernor,
    "schedutil": SchedutilGovernor,
    "thermal-aware": ThermalAwareGovernor,
}
