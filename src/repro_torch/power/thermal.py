"""Discrete-time RC thermal network for the 2U SoC-Cluster envelope.

Three nodes per heat path, matching the prototype's physical stack
(§2.2): SoC die → PCB group (5 SoCs share one board and its spreader) →
rack inlet air. Each stage is a first-order RC:

    C_die · dT_die/dt = P_unit − (T_die − T_pcb) / R_die
    C_pcb · dT_pcb/dt = Σ_units (T_die − T_pcb)/R_die − (T_pcb − T_in)/R_pcb

The PCB→air resistance falls as the chassis fans spin up (the fan curve
rides on ``ClusterSpec.p_shared``: fan power is charged to the shared
rail, on top of the calibrated baseline). Each die carries a
**trip-point latch**: crossing ``t_trip_c`` forces the unit down to the
lowest OPP until it cools below ``t_release_c`` (hysteresis, like a
kernel's thermal governor). Frequency governors that want to *avoid*
the latch entirely ask :meth:`ThermalModel.max_sustainable_index` for
the highest OPP whose steady-state die temperature stays below the
release point.

Integration is explicit Euler with automatic sub-stepping (ticks are
1–60 s; the die time constant is ~1–2 min), so the model is stable for
any runtime ``dt_s``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.cluster import ClusterSpec, UnitSpec
from repro_torch.power.opp import OPPTable, unit_power


@dataclass(frozen=True)
class ThermalParams:
    """Calibrated to the 2U/60-SoC prototype: passively-cooled phone
    silicon on shared PCBs under chassis airflow."""

    t_ambient_c: float = 25.0      # rack inlet air
    # die → PCB stage (per SoC; package + thin spreader)
    r_die_c_per_w: float = 8.0
    c_die_j_per_c: float = 12.0
    # PCB group → inlet air stage (board + spreader mass)
    r_pcb_c_per_w: float = 1.2     # at idle fan speed
    c_pcb_j_per_c: float = 400.0
    # fan curve: speed follows the hottest PCB, linearly between the two
    # setpoints; at full speed the PCB→air resistance shrinks to
    # ``fan_r_scale_min``·R and the fans draw ``fan_p_max_w`` extra on
    # the shared rail
    fan_t_low_c: float = 45.0
    fan_t_high_c: float = 70.0
    fan_r_scale_min: float = 0.55
    fan_p_max_w: float = 30.0
    # trip-point throttling (hysteresis latch per die)
    t_trip_c: float = 95.0
    t_release_c: float = 80.0


class ThermalModel:
    """Per-unit die and per-group PCB temperatures over a cluster."""

    def __init__(self, spec: ClusterSpec,
                 params: Optional[ThermalParams] = None) -> None:
        self.spec = spec
        self.params = params or ThermalParams()
        p = self.params
        assert p.t_release_c < p.t_trip_c, \
            "release point must sit below the trip point (hysteresis)"
        self._groups = spec.groups()
        self._group_of = [gi for gi, g in enumerate(self._groups)
                          for _ in g]
        self.t_die: List[float] = [p.t_ambient_c] * spec.n_units
        self.t_pcb: List[float] = [p.t_ambient_c] * len(self._groups)
        self.throttled: List[bool] = [False] * spec.n_units
        self.fan_frac = 0.0
        # chaos hook: a failed shared fan rail pins airflow at zero
        # (fan_frac = 0.0, so r_pcb_eff collapses to the no-airflow
        # r_pcb_c_per_w exactly); set per tick by the fleet chaos driver
        self.fan_failed = False

    # ------------------------------------------------------------------
    def _fan_frac(self) -> float:
        if self.fan_failed:
            return 0.0
        p = self.params
        hottest = max(self.t_pcb)
        span = max(p.fan_t_high_c - p.fan_t_low_c, 1e-9)
        return min(1.0, max(0.0, (hottest - p.fan_t_low_c) / span))

    def r_pcb_eff(self, fan_frac: Optional[float] = None) -> float:
        p = self.params
        f = self._fan_frac() if fan_frac is None else fan_frac
        return p.r_pcb_c_per_w * (1.0 - (1.0 - p.fan_r_scale_min) * f)

    @property
    def fan_power_w(self) -> float:
        return self.params.fan_p_max_w * self.fan_frac

    def max_die_temp_c(self) -> float:
        return max(self.t_die)

    def n_throttled(self) -> int:
        return sum(self.throttled)

    # ------------------------------------------------------------------
    def step(self, dt_s: float, unit_power_w: Sequence[float]) -> float:
        """Advance the network one tick under the given per-unit power
        draw; updates trip latches and returns the tick's fan power."""
        p = self.params
        assert len(unit_power_w) == self.spec.n_units
        self.fan_frac = self._fan_frac()
        r_pcb = self.r_pcb_eff(self.fan_frac)
        # sub-step at a quarter of the fastest time constant
        tau = min(p.r_die_c_per_w * p.c_die_j_per_c,
                  r_pcb * p.c_pcb_j_per_c)
        n_sub = max(1, int(dt_s / max(0.25 * tau, 1e-6)) + 1)
        h = dt_s / n_sub
        for _ in range(n_sub):
            flows = [0.0] * len(self._groups)
            for u in range(self.spec.n_units):
                f = (self.t_die[u] - self.t_pcb[self._group_of[u]]) \
                    / p.r_die_c_per_w
                flows[self._group_of[u]] += f
                self.t_die[u] += h * (unit_power_w[u] - f) / p.c_die_j_per_c
            for gi in range(len(self._groups)):
                out = (self.t_pcb[gi] - p.t_ambient_c) / r_pcb
                self.t_pcb[gi] += h * (flows[gi] - out) / p.c_pcb_j_per_c
        for u in range(self.spec.n_units):
            if self.throttled[u]:
                if self.t_die[u] <= p.t_release_c:
                    self.throttled[u] = False
            elif self.t_die[u] >= p.t_trip_c:
                self.throttled[u] = True
        return self.fan_power_w

    # ------------------------------------------------------------------
    def steady_die_temp_c(self, p_unit_w: float,
                          units_in_group: Optional[int] = None,
                          fan_frac: float = 1.0) -> float:
        """Steady-state die temperature when every unit in a group draws
        ``p_unit_w`` (worst case: full group) at the given fan speed."""
        n = self.spec.group_size if units_in_group is None \
            else units_in_group
        t_pcb = self.params.t_ambient_c \
            + n * p_unit_w * self.r_pcb_eff(fan_frac)
        return t_pcb + p_unit_w * self.params.r_die_c_per_w

    def max_sustainable_index(self, unit: UnitSpec, table: OPPTable,
                              util: float = 1.0) -> int:
        """Highest OPP a fully-loaded, fully-occupied group can hold
        forever without tripping (steady-state die temp at full fan stays
        below the *release* point, so the latch never ping-pongs). The
        lowest OPP is returned even when nothing is sustainable."""
        for idx in range(table.highest, table.lowest, -1):
            p_w = unit_power(unit, util, table[idx])
            if self.steady_die_temp_c(p_w) <= self.params.t_release_c:
                return idx
        return table.lowest


class VectorThermalModel(ThermalModel):
    """Array-backed thermal network — bitwise-identical to the scalar
    :class:`ThermalModel`.

    The per-unit Euler update is elementwise (IEEE float64 ops are
    identical whether issued one unit at a time or over a whole array)
    and the per-group heat flows are accumulated by ``np.bincount``,
    which adds weights in input order — the same ascending-unit order
    the scalar loop uses — so every temperature, latch, and fan value
    matches the scalar model bit for bit. Used by
    :class:`~repro_torch.runtime.pool.VectorUnitPool` (``backend="vector"``).
    """

    def __init__(self, spec: ClusterSpec,
                 params: Optional[ThermalParams] = None) -> None:
        super().__init__(spec, params)
        self.t_die = np.asarray(self.t_die, float)
        self.t_pcb = np.asarray(self.t_pcb, float)
        self.throttled = np.zeros(spec.n_units, bool)
        self._group_idx = np.asarray(self._group_of, np.int64)
        self._scr_f: Optional[np.ndarray] = None
        self._scr_g: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    def _fan_frac(self) -> float:
        if self.fan_failed:
            return 0.0
        p = self.params
        hottest = float(self.t_pcb.max())
        span = max(p.fan_t_high_c - p.fan_t_low_c, 1e-9)
        return min(1.0, max(0.0, (hottest - p.fan_t_low_c) / span))

    def max_die_temp_c(self) -> float:
        return float(self.t_die.max())

    def n_throttled(self) -> int:
        return int(np.count_nonzero(self.throttled))

    # ------------------------------------------------------------------
    def step(self, dt_s: float, unit_power_w: Sequence[float]) -> float:
        p = self.params
        pw = np.asarray(unit_power_w, float)
        assert pw.shape == (self.spec.n_units,)
        self.fan_frac = self._fan_frac()
        r_pcb = self.r_pcb_eff(self.fan_frac)
        tau = min(p.r_die_c_per_w * p.c_die_j_per_c,
                  r_pcb * p.c_pcb_j_per_c)
        n_sub = max(1, int(dt_s / max(0.25 * tau, 1e-6)) + 1)
        h = dt_s / n_sub
        n_groups = len(self._groups)
        # scratch buffers (ufunc out= — same float ops, no allocations)
        f = self._scr_f
        if f is None:
            f = self._scr_f = np.empty(self.spec.n_units, float)
            self._scr_g = np.empty(n_groups, float)
        out = self._scr_g
        for _ in range(n_sub):
            np.subtract(self.t_die, self.t_pcb[self._group_idx], out=f)
            f /= p.r_die_c_per_w
            # weighted bincount adds in input order — the only numpy
            # group-sum whose accumulation is bitwise-identical to the
            # scalar loop (reduceat / reshape-sum reductions are not
            # strictly left-to-right)
            flows = np.bincount(self._group_idx, weights=f,
                                minlength=n_groups)
            np.subtract(pw, f, out=f)
            f *= h
            f /= p.c_die_j_per_c
            self.t_die += f
            np.subtract(self.t_pcb, p.t_ambient_c, out=out)
            out /= r_pcb
            np.subtract(flows, out, out=flows)
            flows *= h
            flows /= p.c_pcb_j_per_c
            self.t_pcb += flows
        # hysteresis latch: a throttled die stays latched until it cools
        # below the release point; an unlatched one trips at t_trip_c
        self.throttled = np.where(self.throttled,
                                  ~(self.t_die <= p.t_release_c),
                                  self.t_die >= p.t_trip_c)
        return self.fan_power_w
