"""Request routers: shard one fleet-level offered load across racks.

A router sees a :class:`FleetView` — per-rack state arrays published by
the engine at the start of every tick — and returns the per-rack
requests/s assignment. All routers are pure array computations, so the
same router instance drives both fleet backends and (given identical
views) produces bitwise-identical assignments, which is what makes the
scalar and vector fleet engines comparable end to end.

  * :class:`RoundRobinRouter` — uniform spread (the fluid limit of
    per-request round-robin); ignores rack state entirely;
  * :class:`JoinShortestQueueRouter` — water-filling on expected
    queueing delay: load goes to the racks whose (backlog + new work) /
    capacity is lowest until delays equalize — the geo load balancer's
    JSQ policy in fluid form;
  * :class:`PowerAwareRouter` — packs load onto the most
    energy-efficient racks first (full-load J/request ranking, filled
    to a utilization setpoint, spilling only when the efficient racks
    saturate) — routing-level energy proportionality on heterogeneous
    fleets.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol, runtime_checkable

import numpy as np

__all__ = [
    "FleetView",
    "Router",
    "RoundRobinRouter",
    "JoinShortestQueueRouter",
    "PowerAwareRouter",
    "ROUTERS",
]


@dataclass
class FleetView:
    """Per-rack state a router may consult (arrays of length n_racks).

    Under chaos the fleet publishes a *degraded* view: killed units
    shrink ``capacity_rps`` and a fully dead rack carries capacity 0.0
    and ``alive=False``. JSQ and the power-aware router exclude dead
    racks through the zeroed capacity alone (their assignments are
    capacity-scaled); round-robin consults ``alive`` directly. ``None``
    means no chaos is wired — bitwise-identical to the pre-chaos view.
    """

    t: float
    dt_s: float
    capacity_rps: np.ndarray  # peak service rate (n_units x unit_rate)
    queued_cost: np.ndarray  # request-equivalents waiting per rack
    active_units: np.ndarray
    n_units: np.ndarray
    full_load_j_per_req: np.ndarray  # rack energy cost per request at peak
    alive: Optional[np.ndarray] = None  # chaos: False = rack fully dead

    @property
    def n_racks(self) -> int:
        return len(self.capacity_rps)

    def scaled(self, capacity_scale: np.ndarray) -> "FleetView":
        """This view with per-rack capacity multipliers applied — how
        the degradation layer's circuit breakers reshape routing. An
        open breaker (scale 0.0) zeroes the rack's advertised capacity
        and clears ``alive`` (so capacity-oblivious round-robin also
        stops sending); a half-open breaker advertises its probe
        fraction, which capacity-aware routers honor proportionally.
        ``scale == 1`` everywhere returns the arrays unchanged
        bitwise (multiplying by 1.0 is an IEEE identity)."""
        scale = np.asarray(capacity_scale, float)
        alive = self.alive
        if (scale == 0.0).any():  # reprolint: ok[RPL005] exact-zero sentinel, not a float tie: an open breaker's scale is the literal 0.0 on every backend, never a computed near-zero
            base = alive if alive is not None else np.ones(self.n_racks, bool)
            alive = base & (scale > 0.0)
        return FleetView(
            t=self.t,
            dt_s=self.dt_s,
            capacity_rps=self.capacity_rps * scale,
            queued_cost=self.queued_cost,
            active_units=self.active_units,
            n_units=self.n_units,
            full_load_j_per_req=self.full_load_j_per_req,
            alive=alive,
        )


@runtime_checkable
class Router(Protocol):
    """Structural protocol: one per-rack rps assignment per tick."""

    def route(self, total_rps: float, view: FleetView) -> np.ndarray: ...


class RoundRobinRouter:
    """Uniform spread: every rack gets ``total / n_racks`` requests/s.

    The fluid equivalent of cycling request-by-request through the rack
    list. Capacity-oblivious — on a heterogeneous fleet it overloads
    the small racks while big ones idle, which is exactly the baseline
    the smarter routers are measured against.
    """

    name = "round-robin"

    def route(self, total_rps: float, view: FleetView) -> np.ndarray:
        alive = view.alive
        if alive is None:
            return np.full(view.n_racks, total_rps / view.n_racks)
        # chaos degradation: spread only over live racks (a dead rack's
        # queue was evacuated; sending it more work would strand it).
        # All racks dead = nowhere to route — the load is lost.
        n_alive = int(np.count_nonzero(alive))
        if n_alive == 0:
            return np.zeros(view.n_racks)
        return np.where(alive, total_rps / n_alive, 0.0)


class JoinShortestQueueRouter:
    """Water-fill on expected queueing delay.

    Each rack's delay metric is ``queued_cost / capacity`` seconds of
    backlog; this tick's work is poured onto the racks with the lowest
    metric until delays equalize at a common water level ``L``::

        assign_r = max(0, capacity_r * L - queued_r) / dt

    with ``L`` chosen so the assignments sum to the offered work. Racks
    whose backlog already exceeds the level receive nothing this tick.
    """

    name = "join-shortest-queue"

    def route(self, total_rps: float, view: FleetView) -> np.ndarray:
        cap = np.maximum(view.capacity_rps, 1e-12)
        if total_rps <= 0.0:
            return np.zeros(view.n_racks)
        work = total_rps * view.dt_s
        delay = view.queued_cost / cap
        order = np.argsort(delay, kind="stable")
        d = delay[order]
        c = cap[order]
        q = view.queued_cost[order]
        # level over the k cheapest racks; feasible while L_k >= d_k
        levels = (work + np.cumsum(q)) / np.cumsum(c)  # reprolint: ok[RPL001] cumsum is prefix-ordered; the one Router instance feeds both engines the same views, so routing is deterministic by construction
        feasible = np.nonzero(levels >= d)[0]
        level = levels[feasible[-1]] if len(feasible) else levels[0]
        assign = np.maximum(0.0, view.capacity_rps * level - view.queued_cost)
        return assign / view.dt_s


class PowerAwareRouter:
    """Pack load onto the cheapest racks (J/request at full load) first.

    Racks are ranked by ``full_load_j_per_req``; each is filled to
    ``util_target`` of its capacity before the next rank gets traffic.
    If the setpoint pool saturates, a second pass fills the same
    ranking to full capacity; any residual overload is spread
    capacity-proportionally. On a heterogeneous fleet this keeps the
    inefficient racks at their idle floor whenever the efficient ones
    can carry the load.
    """

    name = "power-aware"

    def __init__(self, util_target: float = 0.85) -> None:
        assert 0.0 < util_target <= 1.0
        self.util_target = util_target

    @staticmethod
    def _greedy(total: float, budget: np.ndarray) -> np.ndarray:
        """Fill ``budget`` slots in order until ``total`` is exhausted."""
        before = np.concatenate(([0.0], np.cumsum(budget)[:-1]))  # reprolint: ok[RPL001] cumsum is prefix-ordered; the one Router instance feeds both engines the same views, so routing is deterministic by construction
        return np.clip(total - before, 0.0, budget)

    def route(self, total_rps: float, view: FleetView) -> np.ndarray:
        if total_rps <= 0.0:
            return np.zeros(view.n_racks)
        order = np.argsort(view.full_load_j_per_req, kind="stable")
        cap = view.capacity_rps[order]
        if float(cap.sum()) <= 0.0:  # reprolint: ok[RPL001] zero-test only: capacities are non-negative, sum()==0 iff all are 0
            # chaos: every rack dead — nowhere to route
            return np.zeros(view.n_racks)
        setpoint = cap * self.util_target
        take = self._greedy(total_rps, setpoint)
        rem = total_rps - float(take.sum())  # reprolint: ok[RPL001] router runs once per tick on identical views in both engines; its output is replayed, not recomputed, so any reduction order is parity-safe
        if rem > 1e-12:
            take = take + self._greedy(rem, cap - take)
            rem = total_rps - float(take.sum())  # reprolint: ok[RPL001] same shared-router argument as above
        if rem > 1e-12:
            # fleet-wide overload: spread the excess by capacity
            take = take + rem * cap / float(cap.sum())  # reprolint: ok[RPL001] same shared-router argument as above
        assign = np.zeros(view.n_racks)
        assign[order] = take
        return assign


ROUTERS = {
    "round-robin": RoundRobinRouter,
    "join-shortest-queue": JoinShortestQueueRouter,
    "power-aware": PowerAwareRouter,
}
