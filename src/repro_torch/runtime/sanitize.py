"""Runtime invariant sanitizer for the twin-engine parity contract.

Static analysis (``tools/reprolint``) catches the *patterns* that break
scalar/vector parity; this module catches the *state* — it wraps the
mutating entry points of :class:`~repro_torch.runtime.pool.UnitPool`,
:class:`~repro_torch.runtime.pool.VectorUnitPool`, and the
:class:`~repro_torch.fleet.fleet.Fleet` engines with invariant checks that
run after every call:

* **Count-cache ground truth** — the vector pool's exact integer caches
  (``_n_alloc``, ``_n_active_of``, ``_free_g``, ...) must equal the
  ``np.bincount``/``np.nonzero`` recomputation from the state arrays.
* **Legal state transitions** — per unit, only
  ``off -> waking -> active -> off`` moves (plus ``off -> active`` for
  ``force_active``); ``active -> waking`` is impossible, and a unit may
  change owner only by passing through ``off``.
* **State/owner consistency** — a unit is off iff it has no owner.
* **Request conservation** (fleet level) — cumulative injected cost
  equals served + queued pending cost per rack (the fluid model has no
  separate in-flight mass; concurrency is a derived count).
* **OPP indices in range**, **finite bounded temperatures**, and
  **monotone non-negative energy integrals**.

Enable globally with ``REPRO_SANITIZE=1`` (picked up by
:func:`~repro_torch.runtime.pool.make_unit_pool` and
:class:`~repro_torch.fleet.fleet.Fleet`), or per object with their
``sanitize=True`` keyword. Checks are O(n_units) numpy work per
mutating call — cheap on the small configs tier-1 tests use.

A violated invariant raises :class:`InvariantViolation` (an
``AssertionError`` subclass) at the mutating call that broke it, not
ticks later in a telemetry mismatch.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import numpy as np

__all__ = [
    "InvariantViolation",
    "sanitizer_enabled",
    "resolve_sanitize",
    "PoolSanitizer",
    "FleetSanitizer",
    "attach_pool_sanitizer",
    "attach_fleet_sanitizer",
    "check_pool",
]

# pool state codes (mirrors pool._OFF/_WAKING/_ACTIVE; pool imports this
# module lazily, so the constants live here too to avoid a cycle)
_OFF, _WAKING, _ACTIVE = 0, 1, 2

#: legal (previous, current) per-unit state moves across one mutating
#: call: anything out of OFF, WAKING forward/back, ACTIVE only to OFF.
_LEGAL_MOVES = frozenset({
    (_OFF, _OFF), (_OFF, _WAKING), (_OFF, _ACTIVE),
    (_WAKING, _WAKING), (_WAKING, _ACTIVE), (_WAKING, _OFF),
    (_ACTIVE, _ACTIVE), (_ACTIVE, _OFF),
})

_TEMP_MIN_C = -40.0
_TEMP_MAX_C = 400.0

# methods whose calls mutate pool state and therefore get re-checked
_POOL_MUTATORS = ("wake", "release", "advance", "force_active",
                  "charge", "set_opp")


class InvariantViolation(AssertionError):
    """A runtime invariant of the parity contract was broken."""


def sanitizer_enabled() -> bool:
    """True when ``REPRO_SANITIZE`` requests sanitized runs."""
    return os.environ.get("REPRO_SANITIZE", "").strip().lower() in (
        "1", "true", "yes", "on")


def resolve_sanitize(flag: Optional[bool]) -> bool:
    """``sanitize=`` keyword semantics: explicit wins, None asks env."""
    return sanitizer_enabled() if flag is None else bool(flag)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise InvariantViolation(what)


# ---------------------------------------------------------------------------
# pool-level checks


_SCALAR_CODES: Dict[object, int] = {}


def _state_codes(pool: Any) -> np.ndarray:
    """The pool's per-unit state as int codes, backend-agnostic."""
    st = getattr(pool, "_state", None)
    if isinstance(st, np.ndarray):
        return st.copy()
    # scalar backend: List[UnitState] in enum-declaration order
    if not _SCALAR_CODES and pool.state:
        _SCALAR_CODES.update(
            (s, i) for i, s in
            enumerate(type(pool.state[0]).__members__.values()))
    return np.asarray([_SCALAR_CODES[s] for s in pool.state], np.int8)


#: stable name -> id assignment for the scalar backend's owner list
#: (ids must not depend on encounter order, or a snapshot taken before
#: a call and one taken after could number the same tenant differently)
_OWNER_INTERN: Dict[str, int] = {}


def _owner_ids(pool: Any) -> np.ndarray:
    ow = getattr(pool, "_owner", None)
    if isinstance(ow, np.ndarray):
        return ow.copy()
    out = np.empty(pool.spec.n_units, np.int64)
    for u, o in enumerate(pool.owner):
        out[u] = -1 if o is None else \
            _OWNER_INTERN.setdefault(o, len(_OWNER_INTERN))
    return out


def _check_transitions(prev_state: np.ndarray, prev_owner: np.ndarray,
                       state: np.ndarray, owner: np.ndarray) -> None:
    changed = np.nonzero((prev_state != state)
                         | (prev_owner != owner))[0]
    for u in changed:
        move = (int(prev_state[u]), int(state[u]))
        _require(
            move in _LEGAL_MOVES,
            f"unit {u}: illegal state transition {move[0]} -> {move[1]} "
            "(legal: off->waking->active, off->active, waking/active->off)")
        if prev_state[u] != _OFF and state[u] != _OFF:
            _require(
                prev_owner[u] == owner[u],
                f"unit {u}: owner changed {int(prev_owner[u])} -> "
                f"{int(owner[u])} without passing through off")


def _check_vector_caches(pool: Any) -> None:
    st, ow = pool._state, pool._owner
    gi = pool._group_idx
    n_groups = len(pool._groups)
    off = st == _OFF
    _require(int((~off).sum()) == pool._n_alloc,
             f"_n_alloc cache {pool._n_alloc} != ground truth "
             f"{int((~off).sum())}")
    n_waking = int((st == _WAKING).sum())
    _require(n_waking == pool._n_waking_total,
             f"_n_waking_total cache {pool._n_waking_total} != ground "
             f"truth {n_waking}")
    free_truth = np.bincount(gi[off], minlength=n_groups)
    _require(np.array_equal(free_truth, pool._free_g),
             f"_free_g cache {pool._free_g.tolist()} != ground truth "
             f"{free_truth.tolist()}")
    for tid in range(len(pool._tenant_names)):
        mine = ow == tid
        n_act = int((mine & (st == _ACTIVE)).sum())
        n_wak = int((mine & (st == _WAKING)).sum())
        name = pool._tenant_names[tid]
        _require(pool._n_active_of.get(tid, 0) == n_act,
                 f"tenant {name!r}: _n_active_of cache "
                 f"{pool._n_active_of.get(tid, 0)} != ground truth {n_act}")
        _require(pool._n_waking_of.get(tid, 0) == n_wak,
                 f"tenant {name!r}: _n_waking_of cache "
                 f"{pool._n_waking_of.get(tid, 0)} != ground truth {n_wak}")
        mine_truth = np.bincount(gi[mine & ~off], minlength=n_groups)
        act_truth = np.bincount(gi[mine & (st == _ACTIVE)],
                                minlength=n_groups)
        cached_mine = pool._mine_g.get(tid)
        if cached_mine is not None:
            _require(np.array_equal(mine_truth, cached_mine),
                     f"tenant {name!r}: _mine_g cache "
                     f"{cached_mine.tolist()} != ground truth "
                     f"{mine_truth.tolist()}")
        elif mine_truth.any():
            raise InvariantViolation(
                f"tenant {name!r}: owns units but has no _mine_g cache")
        cached_act = pool._act_g.get(tid)
        if cached_act is not None:
            _require(np.array_equal(act_truth, cached_act),
                     f"tenant {name!r}: _act_g cache "
                     f"{cached_act.tolist()} != ground truth "
                     f"{act_truth.tolist()}")
        elif act_truth.any():
            raise InvariantViolation(
                f"tenant {name!r}: has active units but no _act_g cache")
        cached_idx = pool._active_idx.get(tid)
        if cached_idx is not None:
            idx_truth = np.nonzero(mine & (st == _ACTIVE))[0]
            _require(np.array_equal(idx_truth, cached_idx),
                     f"tenant {name!r}: stale _active_idx cache "
                     f"{cached_idx.tolist()} != ground truth "
                     f"{idx_truth.tolist()}")


def _check_thermal(thermal: Any) -> None:
    for field in ("t_die", "t_pcb"):
        temps = np.asarray(getattr(thermal, field), float)
        _require(bool(np.all(np.isfinite(temps))),
                 f"thermal.{field} has non-finite temperatures")
        _require(bool(np.all((temps >= _TEMP_MIN_C)
                             & (temps <= _TEMP_MAX_C))),
                 f"thermal.{field} out of [{_TEMP_MIN_C}, {_TEMP_MAX_C}] C: "
                 f"min {temps.min():.1f}, max {temps.max():.1f}")


def check_pool(pool: Any, prev_state: Optional[np.ndarray] = None,
               prev_owner: Optional[np.ndarray] = None,
               prev_energy: float = 0.0) -> None:
    """Assert every pool invariant; raise :class:`InvariantViolation`.

    Standalone entry point (the property tests call it directly);
    ``prev_*`` enable the transition-legality check across a call.
    """
    state = _state_codes(pool)
    owner = _owner_ids(pool)
    # state/owner consistency: off iff unowned
    no_owner = owner < 0
    bad = np.nonzero((state == _OFF) != no_owner)[0]
    _require(len(bad) == 0,
             f"units {bad.tolist()}: off-state and ownerless disagree "
             "(a unit is off iff it has no owner)")
    if prev_state is not None and prev_owner is not None:
        _check_transitions(prev_state, prev_owner, state, owner)
    if getattr(pool, "_n_alloc", None) is not None \
            and hasattr(pool, "_tenant_names"):
        _check_vector_caches(pool)
    if pool.opp_table is not None:
        k = len(pool.opp_table)
        req = np.asarray(pool._req_opp, np.int64)
        _require(bool(np.all((req >= 0) & (req < k))),
                 f"requested OPP indices out of table range [0, {k})")
        for name, idx in pool._tenant_opp.items():
            _require(0 <= idx < k,
                     f"tenant {name!r}: OPP {idx} out of range [0, {k})")
    if pool.thermal is not None:
        _check_thermal(pool.thermal)
    _require(np.isfinite(pool.energy_j) and pool.energy_j >= 0.0,
             f"energy_j non-finite or negative: {pool.energy_j}")
    _require(pool.energy_j >= prev_energy - 1e-9,
             f"energy integral went backwards: {prev_energy} -> "
             f"{pool.energy_j}")
    _require(np.isfinite(pool.last_power_w) and pool.last_power_w >= 0.0,
             f"last_power_w non-finite or negative: {pool.last_power_w}")


class PoolSanitizer:
    """Wraps a pool's mutating methods with post-call invariant checks.

    Installed by :func:`attach_pool_sanitizer`: each wrapped method
    snapshots state/owner, runs the real method, then re-validates the
    whole pool (caches vs ground truth, transition legality, OPP
    ranges, thermal bounds, energy monotonicity). Nested mutators
    (``force_active`` calls ``release``) each check their own span.
    """

    def __init__(self, pool: Any) -> None:
        self.pool = pool
        for name in _POOL_MUTATORS:
            setattr(pool, name, self._wrap(getattr(pool, name)))
        pool._sanitizer = self
        check_pool(pool)  # construction must already be consistent

    def _wrap(self, method: Callable[..., Any]) -> Callable[..., Any]:
        pool = self.pool

        def checked(*args: Any, **kwargs: Any) -> Any:
            prev_state = _state_codes(pool)
            prev_owner = _owner_ids(pool)
            prev_energy = pool.energy_j
            out = method(*args, **kwargs)
            check_pool(pool, prev_state, prev_owner, prev_energy)
            return out

        checked.__name__ = method.__name__
        checked.__wrapped__ = method  # type: ignore[attr-defined]
        return checked


def attach_pool_sanitizer(pool: Any) -> PoolSanitizer:
    """Idempotently arm a pool with invariant checking."""
    existing = getattr(pool, "_sanitizer", None)
    if isinstance(existing, PoolSanitizer):
        return existing
    return PoolSanitizer(pool)


# ---------------------------------------------------------------------------
# fleet-level checks

# conservation tolerance: the fluid drain forgives up to 1e-12 residual
# cost per completed request, so equality is approximate
_CONS_ATOL = 1e-6
_CONS_RTOL = 1e-9


class FleetSanitizer:
    """Wraps a fleet engine's ``tick`` with conservation checks.

    Tracks the cumulative injected cost per rack (``assign_rps * dt``,
    exactly what the engines submit) and asserts after every tick that
    it matches served + queued pending cost — the fluid model has no
    other place for request mass to live. Also checks per-rack energy
    monotonicity, OPP ranges, and (vector backend) stacked thermal
    bounds. On the scalar backend the deep per-pool checks (count
    caches, transition legality, thermal bounds) run once per fleet
    tick over every rack's pool — per-tick granularity instead of
    per-call keeps the overhead inside the tier-1 budget.
    """

    def __init__(self, fleet: Any) -> None:
        self.fleet = fleet
        engine = fleet.engine
        self.injected = np.zeros(fleet.n_racks)
        self._prev_energy = np.zeros(fleet.n_racks)
        self._prev_served = np.zeros(fleet.n_racks)
        # resurrection check needs per-tick granularity (the jax play
        # wrapper checks once per whole trace, where a rack may serve
        # legitimately before its kill window opens)
        self._per_tick = hasattr(engine, "tick")
        self._pools = [rt.pool for rt in engine.rts] \
            if hasattr(engine, "rts") else []
        for pool in self._pools:
            check_pool(pool)  # construction must already be consistent
        if hasattr(engine, "tick"):
            engine.tick = self._wrap(engine.tick)
        else:
            # jax engine: one play() call covers many ticks — wrap that
            engine.play = self._wrap_play(engine.play)
        fleet._sanitizer = self

    # -- engine accessors (scalar vs vector) ----------------------------
    # np.array (not asarray): the vector engine mutates served_acc /
    # energy in place, so an aliasing view would make the grew-while-dead
    # and energy-monotonicity deltas compare an array against itself
    def _served(self) -> np.ndarray:
        engine = self.fleet.engine
        if hasattr(engine, "served_acc"):
            return np.array(engine.served_acc, float)
        return np.asarray([rt.pool.served for rt in engine.rts], float)

    def _energy(self) -> np.ndarray:
        engine = self.fleet.engine
        if hasattr(engine, "energy"):
            return np.array(engine.energy, float)
        return np.asarray([rt.pool.energy_j for rt in engine.rts], float)

    def _wrap(self, tick: Callable[..., Any]) -> Callable[..., Any]:
        def checked(assign_rps: np.ndarray, dt: float,
                    *args: Any, **kwargs: Any) -> Any:
            self.injected = self.injected + np.asarray(assign_rps,
                                                       float) * dt
            prev = [(_state_codes(p), _owner_ids(p), p.energy_j)
                    for p in self._pools]
            out = tick(assign_rps, dt, *args, **kwargs)
            self.check()
            for pool, (ps, po, pe) in zip(self._pools, prev):
                check_pool(pool, ps, po, pe)
            return out

        checked.__name__ = "tick"
        checked.__wrapped__ = tick  # type: ignore[attr-defined]
        return checked

    def _wrap_play(self, play: Callable[..., Any]) -> Callable[..., Any]:
        """Per-call twin of :meth:`_wrap` for engines whose unit of
        advancement is a whole ``play(trace)`` rather than one tick:
        the injected-cost ledger grows by the routed assignments the
        call reports, then the same invariants run once."""
        def checked(trace_rps: Any, drain: bool = True) -> Any:
            out = play(trace_rps, drain=drain)
            assigned = np.asarray(out[0], float)
            if assigned.size:
                per_rack = np.zeros(assigned.shape[1])
                for row in assigned:  # ordered accumulation
                    per_rack = per_rack + row
                self.injected = self.injected + per_rack * self.fleet.dt_s
            self.check()
            return out

        checked.__name__ = "play"
        checked.__wrapped__ = play  # type: ignore[attr-defined]
        return checked

    def check(self) -> None:
        engine = self.fleet.engine
        served = self._served()
        pending = np.asarray(engine.queued_cost(), float)
        # chaos credit: a full-rack kill evacuates queued cost out of
        # the fluid system (respilled cost re-enters through the router
        # and is re-counted as injected; dropped cost leaves for good)
        evac = getattr(engine, "chaos_evac_by_rack", None)
        balance = self.injected - (served + pending)
        if evac is not None:
            balance = balance - np.asarray(evac, float)
        # degradation credit: deadline-expired queued work was injected
        # but is abandoned, never served (shed-at-the-door mass never
        # reaches an engine, so it needs no credit here — the retry
        # ring re-injects it through the router)
        expired = getattr(engine, "degrade_expired_by_rack", None)
        if expired is not None:
            balance = balance - np.asarray(expired, float)
        tol = _CONS_ATOL + _CONS_RTOL * np.maximum(self.injected, 1.0)
        bad = np.nonzero(np.abs(balance) > tol)[0]
        _require(
            len(bad) == 0,
            "request conservation violated: rack(s) "
            f"{bad.tolist()} injected {self.injected[bad].tolist()} != "
            f"served {served[bad].tolist()} + queued "
            f"{pending[bad].tolist()} (+ evacuated/expired)")
        dead = getattr(engine, "chaos_dead", None)
        if self._per_tick and dead is not None:
            full = np.asarray(dead) >= np.asarray(engine.n_units)
            if full.any():
                grew = served - self._prev_served
                res = np.nonzero(full & (grew > 1e-9))[0]
                _require(
                    len(res) == 0,
                    f"resurrection: fully-killed rack(s) {res.tolist()} "
                    "served requests while dead")
        self._prev_served = served
        energy = self._energy()
        _require(bool(np.all(np.isfinite(energy)) and np.all(energy >= 0)),
                 f"rack energy non-finite or negative: {energy.tolist()}")
        _require(bool(np.all(energy >= self._prev_energy - 1e-9)),
                 "rack energy integral went backwards")
        self._prev_energy = energy
        opp = getattr(engine, "opp", None)
        if opp is not None:
            k = np.asarray(engine.K, np.int64)
            has = np.asarray(engine.has_table, bool)
            ok = ~has | ((opp >= 0) & (opp < k))
            _require(bool(np.all(ok)),
                     f"rack OPP indices out of table range: "
                     f"{np.asarray(opp)[~ok].tolist()}")
        therm = getattr(engine, "therm", None)
        if therm is not None:
            _check_thermal(therm)


def attach_fleet_sanitizer(fleet: Any) -> FleetSanitizer:
    """Idempotently arm a fleet with conservation checking."""
    existing = getattr(fleet, "_sanitizer", None)
    if isinstance(existing, FleetSanitizer):
        return existing
    return FleetSanitizer(fleet)
