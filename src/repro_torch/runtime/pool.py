"""``UnitPool`` — per-unit activation state over a :class:`ClusterSpec`.

The pool is the single owner of which physical units are powered (paper
§5.2: per-SoC power gating). Every unit is in one of three states —
``off → waking → active`` — and allocations are handed out
**PCB-group-aligned**: a tenant's units are packed into as few
``ClusterSpec.group_size`` groups as possible (filling groups the tenant
already occupies first, then wholly-free groups), so tensor-parallel
collaboration groups (§5.3) are not stranded across half-empty PCBs.

The pool also owns the cluster's **single power integral**: shared
infrastructure power (``ClusterSpec.p_shared`` — fans, switch boards,
BMC) is charged exactly once per tick no matter how many tenants share
the cluster, while each tenant's powered units are metered at that
tenant's utilization and attributed to ``tenant_energy_j``.

With an :class:`~repro_torch.power.opp.OPPTable` attached the pool also owns
the **frequency axis**: every unit carries a requested operating point
(set per tenant via :meth:`set_opp`), a thermal trip latch may force it
down to the lowest OPP, and :meth:`charge` meters each unit at its
*effective* OPP's f·V² power scale while stepping the RC thermal
network (fan power rides on the shared rail). With no table configured
— the default — every DVFS path is skipped and the pool behaves
bit-for-bit like the pre-power-layer code.

Two interchangeable backends implement the same API:

  * :class:`UnitPool` (``backend="scalar"``) — the reference
    implementation: Python lists and per-unit loops;
  * :class:`VectorUnitPool` (``backend="vector"``) — numpy state
    arrays, mask/lexsort transitions, and exact integer caches for the
    hot-path queries.

Both backends route every floating-point reduction through the same
order-pinned helpers (:func:`_power_from_opp_counts`,
:func:`_perf_from_opp_counts`), so their telemetry — energy integrals,
power/active histories, temperature and throttle histograms — is
**bitwise identical**; only the wall-clock differs. Construct via
:func:`make_unit_pool` (or the runtimes' ``backend=`` argument).
"""
from __future__ import annotations

from enum import Enum
from typing import (TYPE_CHECKING, Any, Dict, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from repro_torch.core.cluster import ClusterSpec, UnitSpec
from repro_torch.power.opp import OPPTable, unit_power
from repro_torch.power.thermal import (ThermalModel, ThermalParams,
                                 VectorThermalModel)

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (obs is optional)
    from repro_torch.obs.attribution import EnergyLedger


class UnitState(str, Enum):
    OFF = "off"
    WAKING = "waking"
    ACTIVE = "active"


# Integer state codes of the vector backend (index == _STATE_ENUM order).
_OFF, _WAKING, _ACTIVE = 0, 1, 2
_STATE_ENUM = (UnitState.OFF, UnitState.WAKING, UnitState.ACTIVE)


def _power_from_opp_counts(unit: UnitSpec, util: float, table: OPPTable,
                           counts: Sequence[int],
                           ) -> Tuple[float, List[float]]:
    """Tenant unit power from per-OPP active-unit counts.

    Accumulates in ascending OPP order in *both* backends, so the
    floating-point sum is order-pinned — this (plus exact integer
    counts) is what makes ``backend="vector"`` bitwise-identical to
    ``"scalar"``. Returns ``(tenant_power_w, per_opp_unit_power_w)``.
    """
    total = 0.0
    pw = [0.0] * len(counts)
    for k in range(len(counts)):
        c = counts[k]
        if c:
            w = unit_power(unit, util, table[k])
            pw[k] = w
            total += c * w
    return total, pw


def _perf_from_opp_counts(table: OPPTable, counts: Sequence[int]) -> float:
    """Mean perf-scale over active units, from per-OPP counts (same
    order-pinning argument as :func:`_power_from_opp_counts`)."""
    s = 0.0
    n = 0
    for k in range(len(counts)):
        c = counts[k]
        if c:
            s += c * table[k].perf_scale
            n += c
    return s / n


class UnitPool:
    """Tracks per-unit state and hands out group-aligned allocations.

    Tenants are identified by name. ``wake`` claims free units (they
    serve only after ``advance`` passes their ready time), ``release``
    powers active units back off, and ``charge`` integrates the cluster
    power model for one tick. Waking units draw the same rest power as
    off/idle units (they are not serving yet) but are *owned* — they are
    unavailable to other tenants and to hedging.
    """

    backend = "scalar"

    def __init__(self, spec: ClusterSpec, idle_units_off: bool = True,
                 opp_table: Optional[OPPTable] = None,
                 thermal: Union[ThermalParams, ThermalModel, None] = None) -> None:
        if isinstance(thermal, ThermalParams):
            thermal = ThermalModel(spec, thermal)
        self._init_common(spec, idle_units_off, opp_table, thermal)
        n = spec.n_units
        nominal = opp_table.nominal if opp_table is not None else 0
        self.state: List[UnitState] = [UnitState.OFF] * n
        self.owner: List[Optional[str]] = [None] * n
        self._ready_t: List[float] = [0.0] * n
        self._req_opp: List[int] = [nominal] * n

    def _init_common(self, spec: ClusterSpec, idle_units_off: bool,
                     opp_table: Optional[OPPTable],
                     thermal: Optional[ThermalModel]) -> None:
        self.spec = spec
        self.idle_units_off = idle_units_off
        self._groups = spec.groups()
        # DVFS state (absent by default: strictly additive)
        assert opp_table is not None or thermal is None, \
            "thermal throttling needs an opp_table to throttle within"
        self.opp_table = opp_table
        self.thermal: Optional[ThermalModel] = thermal
        self._max_sustainable: Optional[int] = None
        self._tenant_opp: Dict[str, int] = {}
        # accounting (cluster level; shared power charged once)
        self.energy_j = 0.0
        self.served = 0.0
        self.tenant_energy_j: Dict[str, float] = {}
        self.last_power_w = 0.0
        # cluster-level per-tick history
        self.t_hist: List[float] = []
        self.power_hist: List[float] = []
        self.active_hist: List[int] = []
        self.util_hist: List[float] = []
        self.offered_hist: List[float] = []
        self.served_hist: List[float] = []
        # filled only when a thermal model is attached
        self.max_temp_hist: List[float] = []
        self.throttled_hist: List[int] = []
        self.fan_power_hist: List[float] = []
        # observability (attach_ledger): when unattached — the default —
        # charge() pays exactly one is-None check per tick
        self._obs_ledger: Optional["EnergyLedger"] = None
        self._obs_rack = ""

    # -- queries -----------------------------------------------------------
    def active(self, tenant: str) -> int:
        return sum(1 for u in range(self.spec.n_units)
                   if self.owner[u] == tenant
                   and self.state[u] is UnitState.ACTIVE)

    def waking(self, tenant: str) -> int:
        return sum(1 for u in range(self.spec.n_units)
                   if self.owner[u] == tenant
                   and self.state[u] is UnitState.WAKING)

    def owned(self, tenant: str) -> int:
        return sum(1 for u in range(self.spec.n_units)
                   if self.owner[u] == tenant
                   and self.state[u] is not UnitState.OFF)

    def units_of(self, tenant: str) -> List[int]:
        return [u for u in range(self.spec.n_units)
                if self.owner[u] == tenant
                and self.state[u] is not UnitState.OFF]

    def n_allocated(self) -> int:
        return sum(1 for s in self.state if s is not UnitState.OFF)

    def n_active(self) -> int:
        return sum(1 for s in self.state if s is UnitState.ACTIVE)

    def n_waking_total(self) -> int:
        return sum(1 for s in self.state if s is UnitState.WAKING)

    def free_units(self) -> int:
        return self.spec.n_units - self.n_allocated()

    # -- DVFS --------------------------------------------------------------
    def set_opp(self, tenant: str, idx: int) -> None:
        """Request an operating point for all of ``tenant``'s units (a
        thermal trip latch can still force individual units lower)."""
        if self.opp_table is None:
            return
        idx = self.opp_table.clamp(idx)
        self._tenant_opp[tenant] = idx
        for u in range(self.spec.n_units):
            if self.owner[u] == tenant:
                self._req_opp[u] = idx

    def effective_opp(self, u: int) -> int:
        """The OPP unit ``u`` actually runs at: its requested point, or
        the table's lowest while its thermal trip latch is set."""
        assert self.opp_table is not None
        if self.thermal is not None and self.thermal.throttled[u]:
            return self.opp_table.lowest
        return self._req_opp[u]

    def _tenant_opp_of(self, tenant: str) -> int:
        assert self.opp_table is not None
        return self._tenant_opp.get(tenant, self.opp_table.nominal)

    def perf_scale(self, tenant: str) -> float:
        """Mean service-rate multiplier over the tenant's active units
        (1.0 with no OPP table, or at the nominal point). Throttled
        units drag the mean down — this is what the workload's capacity
        is scaled by."""
        if self.opp_table is None:
            return 1.0
        mine = self._active_units_of(tenant)
        if len(mine) == 0:
            return self.opp_table[self._tenant_opp_of(tenant)].perf_scale
        return _perf_from_opp_counts(self.opp_table, self._opp_counts(mine))

    def max_sustainable_opp(self) -> Optional[int]:
        """Thermal ceiling for governors (None without a thermal model):
        the highest OPP a fully-loaded, fully-occupied PCB group can
        hold forever without tripping. Constant over the pool's lifetime
        (params, unit, and table are fixed at construction), so it is
        computed once and cached — governors consult it every tick."""
        if self.thermal is None or self.opp_table is None:
            return None
        if self._max_sustainable is None:
            self._max_sustainable = self.thermal.max_sustainable_index(
                self.spec.unit, self.opp_table)
        return self._max_sustainable

    # -- placement ---------------------------------------------------------
    def _group_key(self, gi: int, tenant: str) -> Tuple[int, int, int, int]:
        g = self._groups[gi]
        mine = sum(1 for u in g if self.owner[u] == tenant
                   and self.state[u] is not UnitState.OFF)
        free = sum(1 for u in g if self.state[u] is UnitState.OFF)
        # pack into groups the tenant already occupies, then wholly-free
        # groups, then whatever has the most room
        return (0 if mine else 1, 0 if free == len(g) else 1, -free, gi)

    def _pick_units(self, tenant: str, k: int) -> List[int]:
        if k <= 0:
            return []
        out: List[int] = []
        for gi in sorted(range(len(self._groups)),
                         key=lambda gi: self._group_key(gi, tenant)):
            for u in self._groups[gi]:
                if self.state[u] is UnitState.OFF:
                    out.append(u)
                    if len(out) == k:
                        return out
        return out

    # -- transitions -------------------------------------------------------
    def wake(self, tenant: str, k: int, ready_t: float) -> int:
        """Claim up to ``k`` free units for ``tenant``; they become active
        once ``advance`` passes ``ready_t``. Returns the claimed count."""
        picked = self._pick_units(tenant, k)
        for u in picked:
            self.state[u] = UnitState.WAKING
            self.owner[u] = tenant
            self._ready_t[u] = ready_t
            if self.opp_table is not None:
                self._req_opp[u] = self._tenant_opp_of(tenant)
        return len(picked)

    def release(self, tenant: str, k: int) -> int:
        """Power off up to ``k`` of the tenant's units. Still-waking
        units are cancelled first (they are not serving yet, so dropping
        them loses nothing); active units then vacate the tenant's
        least-occupied groups first so allocations stay packed."""
        if k <= 0:
            return 0
        released = 0
        # cancel pending wakes first, newest ready time first
        waking = [u for u in range(self.spec.n_units)
                  if self.owner[u] == tenant
                  and self.state[u] is UnitState.WAKING]
        waking.sort(key=lambda u: (-self._ready_t[u], -u))
        for u in waking[:k]:
            self.state[u] = UnitState.OFF
            self.owner[u] = None
            released += 1
        if released == k:
            return released
        mine = [u for u in range(self.spec.n_units)
                if self.owner[u] == tenant
                and self.state[u] is UnitState.ACTIVE]
        occupancy = {gi: 0 for gi in range(len(self._groups))}
        for u in mine:
            occupancy[u // self.spec.group_size] += 1
        mine.sort(key=lambda u: (occupancy[u // self.spec.group_size], -u))
        for u in mine[:k - released]:
            self.state[u] = UnitState.OFF
            self.owner[u] = None
            released += 1
        return released

    def advance(self, t: float, dt_s: float,
                tenant: Optional[str] = None) -> int:
        """Waking units whose ready time falls within this tick become
        active (fluid model: a unit waking within the tick serves it)."""
        woke = 0
        for u in range(self.spec.n_units):
            if self.state[u] is UnitState.WAKING \
                    and (tenant is None or self.owner[u] == tenant) \
                    and self._ready_t[u] <= t + dt_s:
                self.state[u] = UnitState.ACTIVE
                woke += 1
        return woke

    def force_active(self, tenant: str, k: int) -> None:
        """Set the tenant's active-unit count to exactly ``k``, skipping
        wake latency (initial floors, tests, compatibility setters).
        Pending wakes are cancelled first — a hard reset would otherwise
        drift above ``k`` when they landed (and ``release`` prefers
        waking units, so trimming actives needs them gone)."""
        waking = self.waking(tenant)
        if waking:
            self.release(tenant, waking)
        cur = self.active(tenant)
        if cur > k:
            self.release(tenant, cur - k)
        elif cur < k:
            for u in self._pick_units(tenant, k - cur):
                self.state[u] = UnitState.ACTIVE
                self.owner[u] = tenant
                if self.opp_table is not None:
                    self._req_opp[u] = self._tenant_opp_of(tenant)

    # -- backend hooks (overridden by VectorUnitPool) ----------------------
    def _active_units_of(self, tenant: str) -> Sequence[int]:
        """The tenant's active unit indices, in ascending unit order."""
        return [u for u in range(self.spec.n_units)
                if self.owner[u] == tenant
                and self.state[u] is UnitState.ACTIVE]

    def _opp_counts(self, mine: Sequence[int]) -> List[int]:
        """Active-unit count per effective OPP index (exact integers)."""
        counts = [0] * len(self.opp_table)
        for u in mine:
            counts[self.effective_opp(u)] += 1
        return counts

    def _scatter_unit_power(self, buf: Union[List[float], np.ndarray],
                            mine: Sequence[int],
                            pw_per_opp: Sequence[float]) -> None:
        for u in mine:
            buf[u] = pw_per_opp[self.effective_opp(u)]

    def _spare_units(self) -> List[int]:
        """Non-active unit indices (ascending); extras' heat is parked
        here for the thermal step, consumed from the back."""
        return [u for u in range(self.spec.n_units)
                if self.state[u] is not UnitState.ACTIVE]

    def _new_power_buf(self, fill: float) -> Union[List[float], np.ndarray]:
        return [fill] * self.spec.n_units

    def _n_latched_of(self, mine: Sequence[int]) -> int:
        """Trip-latched dies among ``mine`` (ledger cause split)."""
        assert self.thermal is not None
        thr = self.thermal.throttled
        return sum(1 for u in mine if thr[u])

    # -- accounting --------------------------------------------------------
    def attach_ledger(self, ledger: "EnergyLedger", rack: str = "") -> None:
        """Meter every subsequent ``charge`` tick into ``ledger`` under
        rack label ``rack`` (default: the spec's name). The ledger's
        replay starts from the pool's current ``energy_j``, so its
        :meth:`~repro_torch.obs.attribution.EnergyLedger.rack_energy_j` stays
        bitwise-equal to this pool's integral even when attached
        mid-run."""
        self._obs_rack = rack or self.spec.name
        self._obs_ledger = ledger
        ledger.register_pool(self._obs_rack, base_energy_j=self.energy_j)

    def charge(self, t: float, dt_s: float, utils: Dict[str, float],
               extra: Optional[Dict[str, int]] = None,
               offered: float = 0.0, served: float = 0.0,
               ) -> Tuple[float, Dict[str, float], Dict[str, int]]:
        """Integrate one tick of cluster power: shared power once, each
        tenant's powered units (allocation + borrowed/overflow ``extra``)
        at that tenant's utilization, the rest at the off/idle floor.

        With an OPP table attached, each of a tenant's active units is
        metered at its *effective* operating point's f·V² power scale
        (extra borrowed/overflow units at the tenant's requested point),
        the thermal network advances one tick on the per-unit draw, and
        the fan's power lands on the shared rail. Without a table this
        is the exact pre-DVFS computation.

        Returns ``(total_power_w, per_tenant_power_w, per_tenant_powered)``.
        """
        extra = extra or {}
        n = self.spec.n_units
        powered: Dict[str, int] = {
            name: self.active(name) + max(0, int(extra.get(name, 0)))
            for name in utils}
        total_powered = sum(powered.values())
        if total_powered > n:
            # can't power more than n units: trim the extras, largest first
            over = total_powered - n
            for name in sorted(powered, key=lambda m: -powered[m]):
                cut = min(over, max(0, powered[name] - self.active(name)))
                powered[name] -= cut
                over -= cut
                if over == 0:
                    break
            total_powered = sum(powered.values())
        unit = self.spec.unit
        p_base = unit.p_off if self.idle_units_off else unit.p_idle
        p_tenant: Dict[str, float] = {}
        p_units = 0.0
        fan_w = 0.0
        ledger = self._obs_ledger
        # leaf groups mirror this loop's accumulation order exactly, so
        # the ledger replay reproduces energy_j bitwise (see repro_torch.obs)
        groups: Optional[List[Any]] = [] if ledger is not None else None
        if self.opp_table is None:
            for name, cnt in powered.items():
                u = min(max(utils[name], 0.0), 1.0)
                p = cnt * unit.power(u)
                p_tenant[name] = p
                p_units += p
                if groups is not None:
                    groups.append((name, [("active", p, cnt)], 0, 0.0))
        else:
            table = self.opp_table
            # per-unit draw, for thermal: off/waking units at the floor
            per_unit_w = self._new_power_buf(p_base) \
                if self.thermal is not None else None
            # borrowed/overflow units have no allocation of their own;
            # their heat still lands on physical silicon, so park it on
            # otherwise-inactive units for the thermal step
            spare: Optional[List[int]] = None
            for name, cnt in powered.items():
                u = min(max(utils[name], 0.0), 1.0)
                mine = self._active_units_of(name)
                counts = self._opp_counts(mine)
                p, pw_per_opp = _power_from_opp_counts(
                    unit, u, table, counts)
                if per_unit_w is not None:
                    self._scatter_unit_power(per_unit_w, mine, pw_per_opp)
                # extras are metered at the tenant's requested point
                n_extra = cnt - len(mine)
                if n_extra > 0:
                    pw = unit_power(unit, u,
                                    table[self._tenant_opp_of(name)])
                    p += n_extra * pw
                    if per_unit_w is not None:
                        if spare is None:
                            spare = self._spare_units()
                        for _ in range(n_extra):
                            if not spare:
                                break
                            per_unit_w[spare.pop()] = pw
                p_tenant[name] = p
                p_units += p
                if groups is not None:
                    # same products, same ascending-OPP order, same
                    # zero-count skips as _power_from_opp_counts
                    leaves: List[Tuple[str, float, int]] = [
                        ("active:opp%d" % k, counts[k] * pw_per_opp[k],
                         counts[k])
                        for k in range(len(counts)) if counts[k]]
                    if n_extra > 0:
                        leaves.append(("hedge", n_extra * pw, n_extra))
                    fu = self._n_latched_of(mine) \
                        if self.thermal is not None else 0
                    fw = pw_per_opp[table.lowest] if fu else 0.0
                    groups.append((name, leaves, fu, fw))
            if self.thermal is not None:
                fan_w = self.thermal.step(dt_s, per_unit_w)
                self.max_temp_hist.append(self.thermal.max_die_temp_c())
                self.throttled_hist.append(self.thermal.n_throttled())
                self.fan_power_hist.append(fan_w)
        rest = n - total_powered
        p_rest = rest * p_base
        total = self.spec.p_shared + fan_w + p_units + p_rest
        self.energy_j += total * dt_s
        if ledger is not None:
            assert groups is not None
            ledger.record_pool_tick(
                self._obs_rack, t, dt_s, shared_w=self.spec.p_shared,
                fan_w=fan_w, groups=groups, rest_w=p_rest, rest_units=rest,
                waking_units=self.n_waking_total())
        self.served += served
        for name, p in p_tenant.items():
            self.tenant_energy_j[name] = \
                self.tenant_energy_j.get(name, 0.0) + p * dt_s
        self.last_power_w = total
        cap = float(total_powered)
        util_agg = sum(powered[m] * min(max(utils[m], 0.0), 1.0)
                       for m in powered) / cap if cap else 0.0
        self.t_hist.append(t)
        self.power_hist.append(total)
        self.active_hist.append(total_powered)
        self.util_hist.append(util_agg)
        self.offered_hist.append(offered)
        self.served_hist.append(served)
        return total, p_tenant, powered


class VectorUnitPool(UnitPool):
    """Array-backed :class:`UnitPool` (``backend="vector"``).

    State lives in numpy arrays (int8 state codes, int64 owner ids,
    float64 ready times), transitions are mask/lexsort operations, and
    the per-(tenant, state) unit counts are maintained as exact integer
    caches so the hot-path queries (``active``/``waking``/
    ``free_units``) are O(1) instead of O(n_units). All float
    reductions go through the shared order-pinned helpers, so telemetry
    is bitwise-identical to the scalar backend — asserted by
    ``tests/test_vector_parity.py``.
    """

    backend = "vector"

    def __init__(self, spec: ClusterSpec, idle_units_off: bool = True,
                 opp_table: Optional[OPPTable] = None,
                 thermal: Union[ThermalParams, ThermalModel, None] = None) -> None:
        if isinstance(thermal, ThermalParams):
            thermal = VectorThermalModel(spec, thermal)
        elif isinstance(thermal, ThermalModel) \
                and not isinstance(thermal, VectorThermalModel):
            raise TypeError(
                "backend='vector' needs a VectorThermalModel; pass "
                "ThermalParams and let the pool build one")
        self._init_common(spec, idle_units_off, opp_table, thermal)
        n = spec.n_units
        nominal = opp_table.nominal if opp_table is not None else 0
        self._state = np.zeros(n, np.int8)
        self._owner = np.full(n, -1, np.int64)
        self._ready = np.zeros(n, float)
        self._req = np.full(n, nominal, np.int64)
        self._tenant_ids: Dict[str, int] = {}
        self._tenant_names: List[str] = []
        self._group_idx = np.asarray(
            [u // spec.group_size for u in range(n)], np.int64)
        self._group_len = np.asarray([len(g) for g in self._groups],
                                     np.int64)
        # exact integer caches (updated on every transition)
        self._n_waking_of: Dict[int, int] = {}
        self._n_active_of: Dict[int, int] = {}
        self._n_alloc = 0
        self._n_waking_total = 0
        # incrementally-maintained per-group counts: free units per group,
        # and per tenant the owned (not-off) / active units per group.
        # Placement and release read these instead of re-deriving them
        # with bincount + lexsort on every operation.
        self._free_g = self._group_len.copy()
        self._mine_g: Dict[int, np.ndarray] = {}
        self._act_g: Dict[int, np.ndarray] = {}
        # composite placement-key constants: (no-units-here, not-wholly-
        # free, fullness) packed into one int so a single stable argsort
        # reproduces the scalar _group_key ordering (gi breaks ties)
        self._lmax = int(self._group_len.max())
        # cached per-tenant active-index arrays (invalidated whenever a
        # transition changes an active set; callers must not mutate)
        self._active_idx: Dict[int, np.ndarray] = {}
        self._pwbuf: Optional[np.ndarray] = None

    # -- compatibility views ----------------------------------------------
    # Tuples, not lists: code written against the scalar backend's mutable
    # attributes (pool.state[u] = ...) must fail fast here rather than
    # silently mutating a materialized temporary.
    @property  # type: ignore[override]  # read-only view of the base's list
    def state(self) -> Tuple[UnitState, ...]:
        """Read-only scalar-compatible view (tests/debugging); mutate
        through wake/release/advance/force_active instead."""
        return tuple(_STATE_ENUM[c] for c in self._state)

    @property  # type: ignore[override]  # read-only view of the base's list
    def owner(self) -> Tuple[Optional[str], ...]:
        return tuple(self._tenant_names[o] if o >= 0 else None
                     for o in self._owner)

    @property  # type: ignore[override]  # read-only view of the base's list
    def _req_opp(self) -> Tuple[int, ...]:
        return tuple(int(r) for r in self._req)

    def _tid(self, tenant: str, create: bool = False) -> Optional[int]:
        tid = self._tenant_ids.get(tenant)
        if tid is None and create:
            tid = len(self._tenant_names)
            self._tenant_ids[tenant] = tid
            self._tenant_names.append(tenant)
        return tid

    # -- queries -----------------------------------------------------------
    def active(self, tenant: str) -> int:
        return self._n_active_of.get(self._tenant_ids.get(tenant), 0)

    def waking(self, tenant: str) -> int:
        return self._n_waking_of.get(self._tenant_ids.get(tenant), 0)

    def owned(self, tenant: str) -> int:
        return self.active(tenant) + self.waking(tenant)

    def units_of(self, tenant: str) -> List[int]:
        tid = self._tenant_ids.get(tenant)
        if tid is None:
            return []
        mask = (self._owner == tid) & (self._state != _OFF)
        return [int(u) for u in np.nonzero(mask)[0]]

    def n_allocated(self) -> int:
        return self._n_alloc

    def n_active(self) -> int:
        return sum(self._n_active_of.values())

    def n_waking_total(self) -> int:
        return self._n_waking_total

    def _n_latched_of(self, mine: Sequence[int]) -> int:
        assert self.thermal is not None
        return int(np.count_nonzero(
            np.asarray(self.thermal.throttled)[np.asarray(mine, np.int64)]))

    # -- DVFS --------------------------------------------------------------
    def set_opp(self, tenant: str, idx: int) -> None:
        if self.opp_table is None:
            return
        idx = self.opp_table.clamp(idx)
        prev = self._tenant_opp.get(tenant, self.opp_table.nominal)
        self._tenant_opp[tenant] = idx
        if idx == prev:
            # every acquisition (wake / force_active) stamps the tenant's
            # current point onto the unit, so owned units already carry
            # ``idx`` — skip the per-unit write on the steady-state tick
            return
        tid = self._tenant_ids.get(tenant)
        if tid is not None:
            self._req[self._owner == tid] = idx

    def effective_opp(self, u: int) -> int:
        assert self.opp_table is not None
        if self.thermal is not None and bool(self.thermal.throttled[u]):
            return self.opp_table.lowest
        return int(self._req[u])

    def _eff_opp_arr(self) -> np.ndarray:
        if self.thermal is not None:
            return np.where(self.thermal.throttled,
                            self.opp_table.lowest, self._req)
        return self._req

    # -- placement ---------------------------------------------------------
    def _group_counts_of(self, tid: int) -> "tuple[np.ndarray, np.ndarray]":
        n_groups = len(self._groups)
        mine = self._mine_g.get(tid)
        if mine is None:
            mine = self._mine_g[tid] = np.zeros(n_groups, np.int64)
        act = self._act_g.get(tid)
        if act is None:
            act = self._act_g[tid] = np.zeros(n_groups, np.int64)
        return mine, act

    def _pick_units(self, tenant: str, k: int) -> List[int]:
        if k <= 0 or self._n_alloc == self.spec.n_units:
            return []
        tid = self._tid(tenant, create=True)
        mine_g, _ = self._group_counts_of(tid)
        free_g = self._free_g
        # the scalar _group_key — (no units here, not wholly free, -free)
        # with gi tie-break — packed into one int; stable argsort keeps
        # ascending gi among equal keys
        key = ((mine_g == 0).astype(np.int64) * 2
               + (free_g != self._group_len)) * (self._lmax + 1) \
            + (self._lmax - free_g)
        order = np.argsort(key, kind="stable")
        out: List[int] = []
        gs = self.spec.group_size
        state = self._state
        for gi in order:
            if free_g[gi] == 0:
                continue
            lo = gi * gs
            for u in np.nonzero(state[lo:lo + int(self._group_len[gi])]
                                == _OFF)[0]:
                out.append(lo + int(u))
                if len(out) == k:
                    return out
        return out

    # -- transitions -------------------------------------------------------
    def _count_groups(self, idx: np.ndarray) -> np.ndarray:
        return np.bincount(self._group_idx[idx],
                           minlength=len(self._groups))

    def wake(self, tenant: str, k: int, ready_t: float) -> int:
        picked = self._pick_units(tenant, k)
        if picked:
            tid = self._tid(tenant, create=True)
            idx = np.asarray(picked, np.int64)
            self._state[idx] = _WAKING
            self._owner[idx] = tid
            self._ready[idx] = ready_t
            if self.opp_table is not None:
                self._req[idx] = self._tenant_opp_of(tenant)
            self._n_waking_of[tid] = \
                self._n_waking_of.get(tid, 0) + len(picked)
            self._n_alloc += len(picked)
            self._n_waking_total += len(picked)
            g = self._count_groups(idx)
            mine_g, _ = self._group_counts_of(tid)
            mine_g += g
            self._free_g -= g
        return len(picked)

    def release(self, tenant: str, k: int) -> int:
        if k <= 0:
            return 0
        tid = self._tenant_ids.get(tenant)
        if tid is None:
            return 0
        released = 0
        if self._n_waking_of.get(tid, 0):
            widx = np.nonzero((self._owner == tid)
                              & (self._state == _WAKING))[0]
            # newest ready time first, then highest unit index
            order = np.lexsort((-widx, -self._ready[widx]))
            take = widx[order[:k]]
            self._state[take] = _OFF
            self._owner[take] = -1
            released = len(take)
            self._n_waking_of[tid] -= released
            self._n_alloc -= released
            self._n_waking_total -= released
            g = self._count_groups(take)
            mine_g, _ = self._group_counts_of(tid)
            mine_g -= g
            self._free_g += g
        if released == k:
            return released
        if self._n_active_of.get(tid, 0):
            aidx = self._active_units_of(tenant)
            # least-occupied groups first, then highest unit index —
            # the cached per-group active counts *are* the occupancy the
            # scalar backend derives per call, and packing (occupancy,
            # n_units - u) into one key makes a single argsort reproduce
            # the scalar ordering (keys are unique: one per unit)
            _, act_g = self._group_counts_of(tid)
            key = act_g[self._group_idx[aidx]] * (self.spec.n_units + 1) \
                + (self.spec.n_units - aidx)
            order = np.argsort(key)  # reprolint: ok[RPL005] integer composite key, one per unit (see comment above): keys are unique, so sort stability is irrelevant
            take = aidx[order[:k - released]]
            self._state[take] = _OFF
            self._owner[take] = -1
            self._n_active_of[tid] = \
                self._n_active_of.get(tid, 0) - len(take)
            self._n_alloc -= len(take)
            g = self._count_groups(take)
            mine_g, act_g = self._group_counts_of(tid)
            mine_g -= g
            act_g -= g
            self._free_g += g
            self._active_idx.pop(tid, None)
            released += len(take)
        return released

    def advance(self, t: float, dt_s: float,
                tenant: Optional[str] = None) -> int:
        if self._n_waking_total == 0:
            return 0
        mask = (self._state == _WAKING) & (self._ready <= t + dt_s)
        if tenant is not None:
            tid = self._tenant_ids.get(tenant)
            if tid is None:
                return 0
            mask &= self._owner == tid
        idx = np.nonzero(mask)[0]
        if len(idx) == 0:
            return 0
        self._state[idx] = _ACTIVE
        owners, cnts = np.unique(self._owner[idx], return_counts=True)
        for o, c in zip(owners, cnts):
            o, c = int(o), int(c)
            self._n_waking_of[o] -= c
            self._n_active_of[o] = self._n_active_of.get(o, 0) + c
            self._n_waking_total -= c
            sel = idx[self._owner[idx] == o]
            _, act_g = self._group_counts_of(o)
            act_g += self._count_groups(sel)
            self._active_idx.pop(o, None)
        return len(idx)

    def force_active(self, tenant: str, k: int) -> None:
        waking = self.waking(tenant)
        if waking:
            self.release(tenant, waking)
        cur = self.active(tenant)
        if cur > k:
            self.release(tenant, cur - k)
        elif cur < k:
            picked = self._pick_units(tenant, k - cur)
            if picked:
                tid = self._tid(tenant, create=True)
                idx = np.asarray(picked, np.int64)
                self._state[idx] = _ACTIVE
                self._owner[idx] = tid
                if self.opp_table is not None:
                    self._req[idx] = self._tenant_opp_of(tenant)
                self._n_active_of[tid] = \
                    self._n_active_of.get(tid, 0) + len(picked)
                self._n_alloc += len(picked)
                g = self._count_groups(idx)
                mine_g, act_g = self._group_counts_of(tid)
                mine_g += g
                act_g += g
                self._free_g -= g
                self._active_idx.pop(tid, None)

    # -- backend hooks -----------------------------------------------------
    def _latch_free(self) -> bool:
        """True when no die carries a trip latch — then every unit of a
        tenant runs at the tenant's requested OPP (wake/force_active/
        set_opp maintain that invariant) and the per-unit effective-OPP
        gathers collapse to a single bucket. Read live off the thermal
        model (tests may set latches by hand)."""
        return self.thermal is None or not self.thermal.throttled.any()

    def _active_units_of(self, tenant: str) -> np.ndarray:  # type: ignore[override]
        tid = self._tenant_ids.get(tenant)
        if tid is None:
            return np.empty(0, np.int64)
        cached = self._active_idx.get(tid)
        if cached is None:
            cached = np.nonzero((self._owner == tid)
                                & (self._state == _ACTIVE))[0]
            self._active_idx[tid] = cached
        return cached

    def perf_scale(self, tenant: str) -> float:
        if self.opp_table is None:
            return 1.0
        k = self.active(tenant)
        if k == 0:
            return self.opp_table[self._tenant_opp_of(tenant)].perf_scale
        if self._latch_free():
            # single bucket: same accumulation as _perf_from_opp_counts
            # with one non-zero count
            return (k * self.opp_table[self._tenant_opp_of(tenant)]
                    .perf_scale) / k
        return _perf_from_opp_counts(
            self.opp_table, self._opp_counts(self._active_units_of(tenant)))

    def _opp_counts(self, mine: np.ndarray) -> List[int]:  # type: ignore[override]
        counts = [0] * len(self.opp_table)
        if len(mine) == 0:
            return counts
        if self._latch_free():
            counts[int(self._req[mine[0]])] = len(mine)
            return counts
        eff = self._eff_opp_arr()[mine]
        return np.bincount(eff, minlength=len(self.opp_table)).tolist()

    def _scatter_unit_power(self, buf: np.ndarray,  # type: ignore[override]
                            mine: np.ndarray,
                            pw_per_opp: Sequence[float]) -> None:
        if len(mine) == 0:
            return
        if self._latch_free():
            buf[mine] = pw_per_opp[int(self._req[mine[0]])]
            return
        buf[mine] = np.asarray(pw_per_opp)[self._eff_opp_arr()[mine]]

    def _spare_units(self) -> List[int]:
        return np.nonzero(self._state != _ACTIVE)[0].tolist()

    def _new_power_buf(self, fill: float) -> np.ndarray:
        # one reusable buffer: charge() consumes it within the tick and
        # the thermal step never retains it
        buf = self._pwbuf
        if buf is None:
            buf = self._pwbuf = np.empty(self.spec.n_units, float)
        buf.fill(fill)
        return buf


def make_unit_pool(spec: ClusterSpec, backend: str = "scalar",
                   sanitize: Optional[bool] = None,
                   **kwargs: Any) -> UnitPool:
    """Construct a pool backend: ``"scalar"`` (reference, per-unit
    loops) or ``"vector"`` (numpy arrays, bitwise-identical telemetry).

    ``sanitize=True`` (or ``REPRO_SANITIZE=1`` with ``sanitize=None``)
    arms the pool with :mod:`repro_torch.runtime.sanitize` invariant checks
    on every mutating call."""
    if backend == "scalar":
        pool: UnitPool = UnitPool(spec, **kwargs)
    elif backend == "vector":
        pool = VectorUnitPool(spec, **kwargs)
    else:
        raise ValueError(
            f"unknown pool backend {backend!r}; use 'scalar' or 'vector'")
    from repro_torch.runtime.sanitize import attach_pool_sanitizer, resolve_sanitize
    if resolve_sanitize(sanitize):
        attach_pool_sanitizer(pool)
    return pool
