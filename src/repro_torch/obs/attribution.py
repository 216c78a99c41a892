"""Exact energy attribution: every joule gets a rack, tenant, and cause.

``EnergyLedger`` records, per tick, the same floating-point leaves the
power integrals accumulate — shared rail, fan rail, per-tenant active
compute at each OPP, hedge borrows, and the off/idle rest floor — in
the same order. Replaying those leaves through the same expression
tree (``rack_energy_j`` / ``total_energy_j``) therefore reproduces the
pool's / vector engine's ``energy_j`` integral **bitwise** on the
scalar and vector backends; the jax backend replays rows emitted from
the jitted scan and is compared within the engine's documented
tolerance (``ledger.tolerance``, relative) because XLA may fuse the
per-tick expression differently.

Two recording surfaces feed one ledger:

  * :meth:`record_pool_tick` — called from ``UnitPool.charge`` (both
    pool backends) when a ledger is attached via
    ``pool.attach_ledger``. Leaves arrive per tenant: the per-OPP
    ``count x unit_power`` products in ascending-OPP order (exactly
    ``_power_from_opp_counts``'s accumulation) plus the borrowed
    ``extra``-unit product; waking-unit counts split the rest floor
    into idle vs wake-transition energy.
  * :meth:`record_fleet_tick` — called once per tick by the vector
    fleet engine (and by the host-side jax expansion) with per-rack
    arrays mirroring ``_VectorFleetEngine.tick``'s power expression:
    ``total = (shared + fan) + (active + hedge) + rest``.

Replay is the parity contract; the *cause* split (:meth:`by_cause`)
additionally carves derived components out of the recorded leaves —
the throttle-floor share of active compute (trip-latched dies metered
at the lowest OPP) and the wake-transition share of the rest floor —
and is computed with ``math.fsum``, so per-cause totals match the
replayed total to ~1 ulp per tick, not bitwise. Tests pin the bitwise
contract on the replay and a 1e-9 relative bound on the split.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["EnergyLedger", "CAUSES"]

#: The causes a joule can be attributed to.
CAUSES = (
    "shared",          # per-rack shared rail (fans at rest, switch, BMC)
    "fan",             # thermal-model fan rail (rides the shared rail)
    "active",          # active compute at each unit's effective OPP
    "hedge",           # borrowed straggler-hedge units
    "throttle_floor",  # trip-latched dies metered at the lowest OPP
    "wake",            # waking units held at the rest floor
    "idle",            # powered-off / gated-idle floor
)

# One active-compute leaf: (cause label, watts, unit count). Pool leaves
# use "active:opp{k}" / "hedge" labels; watts is the *product* c_k * w_k
# exactly as the charge loop accumulated it.
_Leaf = Tuple[str, float, int]
# One tenant's leaves for one pool tick:
# (tenant, leaves, floor_units, floor_w) — floor_units trip-latched
# active dies, metered at floor_w each (derived cause split only).
_Group = Tuple[str, List[_Leaf], int, float]


@dataclass
class _PoolTick:
    t: float
    dt_s: float
    shared_w: float
    fan_w: float
    groups: List[_Group]
    rest_w: float
    rest_units: int
    waking_units: int


@dataclass
class _FleetTick:
    t: float
    dt_s: float
    fan_w: np.ndarray
    active_w: np.ndarray
    hedge_w: np.ndarray
    rest_w: np.ndarray
    hedge_units: np.ndarray
    rest_units: np.ndarray
    waking_units: Optional[np.ndarray]
    floor_units: Optional[np.ndarray]  # trip-latched active dies
    floor_w: Optional[np.ndarray]      # per-die floor-OPP draw


@dataclass
class EnergyLedger:
    """Per rack x tenant x cause energy breakdown with bitwise replay.

    ``tolerance`` is ``None`` for the bitwise scalar/vector contract;
    the jax path sets it to the engine's documented relative tolerance
    (the fig16 parity budget) — queries behave identically, only the
    strength of the ``energy_j`` comparison promised to callers
    differs.
    """

    tolerance: Optional[float] = None
    _pool_order: List[str] = field(default_factory=list)
    _pool_base: Dict[str, float] = field(default_factory=dict)
    _pool_ticks: Dict[str, List[_PoolTick]] = field(default_factory=dict)
    _fleet_names: List[str] = field(default_factory=list)
    _fleet_shared_w: Optional[np.ndarray] = None
    _fleet_ticks: List[_FleetTick] = field(default_factory=list)

    # -- recording: pool surface ----------------------------------------
    def register_pool(self, rack: str, base_energy_j: float = 0.0) -> None:
        """Start metering a pool under rack label ``rack``. The replay
        starts from ``base_energy_j`` (the pool's integral at attach
        time), so attaching mid-run still reproduces ``energy_j``."""
        if rack not in self._pool_base:
            self._pool_order.append(rack)
            self._pool_base[rack] = float(base_energy_j)
            self._pool_ticks[rack] = []

    def record_pool_tick(self, rack: str, t: float, dt_s: float, *,
                         shared_w: float, fan_w: float,
                         groups: Sequence[_Group], rest_w: float,
                         rest_units: int, waking_units: int) -> None:
        """One ``UnitPool.charge`` tick's leaves (see module docstring)."""
        self._pool_ticks[rack].append(_PoolTick(
            t=t, dt_s=dt_s, shared_w=shared_w, fan_w=fan_w,
            groups=list(groups), rest_w=rest_w,
            rest_units=rest_units, waking_units=waking_units))

    # -- recording: fleet surface ----------------------------------------
    def register_fleet(self, rack_names: Sequence[str],
                       shared_w: np.ndarray) -> None:
        """Start metering a fleet engine: per-rack names and the static
        per-rack shared-rail draw (``p_shared``)."""
        self._fleet_names = list(rack_names)
        self._fleet_shared_w = np.asarray(shared_w, float)

    def record_fleet_tick(self, t: float, dt_s: float, *,
                          fan_w: np.ndarray, active_w: np.ndarray,
                          hedge_w: np.ndarray, rest_w: np.ndarray,
                          hedge_units: np.ndarray, rest_units: np.ndarray,
                          waking_units: Optional[np.ndarray] = None,
                          floor_units: Optional[np.ndarray] = None,
                          floor_w: Optional[np.ndarray] = None) -> None:
        """One vector-engine (or expanded jax) tick, as per-rack arrays.

        ``active_w + hedge_w`` must equal the engine's ``p_units``
        elementwise-bitwise: for OPP-table racks ``active_w`` is the
        engine's ``p_act`` and ``hedge_w`` its ``h_f * w_req`` term
        (replayed as the same binary add); for table-less racks
        ``active_w`` is ``powered_f * w_req`` and ``hedge_w`` is 0.0
        (``x + 0.0`` is bitwise ``x`` for the non-negative draws here).
        """
        assert self._fleet_shared_w is not None, \
            "register_fleet() before record_fleet_tick()"
        self._fleet_ticks.append(_FleetTick(
            t=t, dt_s=dt_s, fan_w=fan_w, active_w=active_w,
            hedge_w=hedge_w, rest_w=rest_w, hedge_units=hedge_units,
            rest_units=rest_units, waking_units=waking_units,
            floor_units=floor_units, floor_w=floor_w))

    # -- replay (the bitwise contract) ------------------------------------
    def _replay_pool(self, rack: str) -> float:
        """Replay one pool's ticks through ``UnitPool.charge``'s exact
        accumulation tree: per-tenant leaf sums in recorded order, then
        ``((shared + fan) + p_units) + rest``, integrated tick by tick."""
        e = self._pool_base[rack]
        for tk in self._pool_ticks[rack]:
            p_units = 0.0
            for _tenant, leaves, _fu, _fw in tk.groups:
                p = 0.0
                for _cause, w, _n in leaves:
                    p += w
                p_units += p
            total = tk.shared_w + tk.fan_w + p_units + tk.rest_w
            e += total * tk.dt_s
        return e

    def _replay_fleet(self) -> np.ndarray:
        """Replay the fleet ticks through ``_VectorFleetEngine.tick``'s
        exact per-rack expression ``((shared + fan) + p_units) + rest``."""
        shared = self._fleet_shared_w
        assert shared is not None
        e = np.zeros(len(self._fleet_names))
        for tk in self._fleet_ticks:
            p_units = tk.active_w + tk.hedge_w
            total = shared + tk.fan_w + p_units + tk.rest_w
            e += total * tk.dt_s
        return e

    def rack_energy_j(self) -> Dict[str, float]:
        """Replayed energy integral per rack — bitwise-equal to each
        pool's / engine's per-rack ``energy_j`` on scalar/vector."""
        out: Dict[str, float] = {}
        for rack in self._pool_order:
            out[rack] = self._replay_pool(rack)
        if self._fleet_names:
            fe = self._replay_fleet()
            for i, name in enumerate(self._fleet_names):
                out[name] = float(fe[i])
        return out

    def total_energy_j(self) -> float:
        """Replayed fleet/pool total. Rack energies are combined with a
        left-to-right builtin sum in registration order — the same
        reduction ``FleetTelemetry.energy_j`` performs over per-rack
        telemetry — so the fleet total is also bitwise."""
        total = 0.0
        for rack in self._pool_order:
            total += self._replay_pool(rack)
        if self._fleet_names:
            for e in self._replay_fleet():
                total += float(e)
        return total

    # -- derived splits (fsum; ~1 ulp per tick, not bitwise) ---------------
    def by_rack_tenant_cause(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        """``{rack: {tenant: {cause: joules}}}``. Fleet racks host one
        fluid tenant, recorded under the rack's own name."""
        out: Dict[str, Dict[str, Dict[str, List[float]]]] = {}

        def _add(rack: str, tenant: str, cause: str, j: float) -> None:
            out.setdefault(rack, {}).setdefault(tenant, {}) \
               .setdefault(cause, []).append(j)

        for rack in self._pool_order:
            for tk in self._pool_ticks[rack]:
                _add(rack, "-", "shared", tk.shared_w * tk.dt_s)
                if tk.fan_w:
                    _add(rack, "-", "fan", tk.fan_w * tk.dt_s)
                for tenant, leaves, fu, fw in tk.groups:
                    thr_w = fu * fw
                    act_w = 0.0
                    for cause, w, _n in leaves:
                        if cause == "hedge":
                            _add(rack, tenant, "hedge", w * tk.dt_s)
                        else:
                            act_w += w
                    if thr_w:
                        _add(rack, tenant, "throttle_floor", thr_w * tk.dt_s)
                    _add(rack, tenant, "active", (act_w - thr_w) * tk.dt_s)
                rest_j = tk.rest_w * tk.dt_s
                if tk.rest_units > 0 and tk.waking_units > 0:
                    wake_j = rest_j * (tk.waking_units / tk.rest_units)
                    _add(rack, "-", "wake", wake_j)
                    _add(rack, "-", "idle", rest_j - wake_j)
                else:
                    _add(rack, "-", "idle", rest_j)
        if self._fleet_names:
            shared = self._fleet_shared_w
            assert shared is not None
            for tk in self._fleet_ticks:
                thr_w = np.zeros(len(self._fleet_names))
                if tk.floor_units is not None and tk.floor_w is not None:
                    thr_w = tk.floor_units * tk.floor_w
                rest_j = tk.rest_w * tk.dt_s
                wake_frac = np.zeros(len(self._fleet_names))
                if tk.waking_units is not None:
                    nz = tk.rest_units > 0
                    wake_frac[nz] = tk.waking_units[nz] / tk.rest_units[nz]
                for i, rack in enumerate(self._fleet_names):
                    _add(rack, rack, "shared", float(shared[i]) * tk.dt_s)
                    if tk.fan_w[i]:
                        _add(rack, rack, "fan", float(tk.fan_w[i]) * tk.dt_s)
                    if thr_w[i]:
                        _add(rack, rack, "throttle_floor",
                             float(thr_w[i]) * tk.dt_s)
                    _add(rack, rack, "active",
                         float(tk.active_w[i] - thr_w[i]) * tk.dt_s)
                    if tk.hedge_w[i]:
                        _add(rack, rack, "hedge",
                             float(tk.hedge_w[i]) * tk.dt_s)
                    wj = float(rest_j[i]) * float(wake_frac[i])
                    if wj:
                        _add(rack, rack, "wake", wj)
                    _add(rack, rack, "idle", float(rest_j[i]) - wj)
        return {
            rack: {
                tenant: {cause: math.fsum(js) for cause, js in causes.items()}
                for tenant, causes in tenants.items()
            }
            for rack, tenants in out.items()
        }

    def by_cause(self) -> Dict[str, float]:
        """Fleet-wide joules per cause (fsum over racks and tenants)."""
        parts: Dict[str, List[float]] = {}
        for tenants in self.by_rack_tenant_cause().values():
            for causes in tenants.values():
                for cause, j in causes.items():
                    parts.setdefault(cause, []).append(j)
        return {cause: math.fsum(parts.get(cause, [0.0])) for cause in CAUSES
                if cause in parts}

    def by_tenant(self) -> Dict[str, float]:
        """Joules attributed to each tenant's own units (active + hedge
        + throttle floor; the shared/fan/idle rails are rack-level)."""
        parts: Dict[str, List[float]] = {}
        for tenants in self.by_rack_tenant_cause().values():
            for tenant, causes in tenants.items():
                if tenant == "-":
                    continue
                parts.setdefault(tenant, []).extend(causes.values())
        return {tenant: math.fsum(js) for tenant, js in parts.items()}

    # -- presentation -----------------------------------------------------
    @property
    def n_ticks(self) -> int:
        pool = max((len(v) for v in self._pool_ticks.values()), default=0)
        return max(pool, len(self._fleet_ticks))

    def to_records(self) -> List[Dict[str, object]]:
        """Flat ``{rack, tenant, cause, joules}`` rows (JSONL export)."""
        rows: List[Dict[str, object]] = []
        for rack, tenants in self.by_rack_tenant_cause().items():
            for tenant, causes in tenants.items():
                for cause, j in causes.items():
                    rows.append({"rack": rack, "tenant": tenant,
                                 "cause": cause, "joules": j})
        return rows

    def to_markdown(self) -> str:
        """Fleet-wide per-cause table plus the replay total."""
        by_cause = self.by_cause()
        total = self.total_energy_j()
        lines = ["| cause | energy (J) | share |",
                 "|---|---:|---:|"]
        for cause in CAUSES:
            if cause not in by_cause:
                continue
            j = by_cause[cause]
            share = j / total if total else 0.0
            lines.append(f"| {cause} | {j:.3f} | {100.0 * share:.2f}% |")
        lines.append(f"| **total (replayed)** | **{total:.3f}** | 100.00% |")
        return "\n".join(lines)
