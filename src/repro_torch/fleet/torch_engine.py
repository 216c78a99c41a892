"""Torch fleet engine: the scanned fleet tick as one batched tensor step.

Third fleet backend of the port (``Fleet(backend="torch")``), the twin of
the JAX package's ``fleet/jax_engine.py``. The whole per-tick pipeline of
the vector engine — branchless masked routing, the ``fixed`` /
``race-to-idle`` / ``schedutil`` / thermal-aware-clamp governor passes,
activation targets with cooldown, straggler hedging, the fluid FIFO drain,
``UnitPool.charge`` power accounting, and the stacked RC thermal Euler
substeps — is :func:`_step`, a pure function of a dict of tensors. Every
tensor carries a **leading config axis**: a ``Fleet`` is batch 1, and
:func:`sweep` runs a whole config grid as batch N, which is what
``jax.vmap`` did for the JAX engine.

Parity contract — **tolerance, not bitwise**, as for the JAX engine: the
vector engine is the oracle, and the reductions here run in another order
(CUDA's tree reductions and scans, padded-gather segment sums), so
telemetry is compared under the rtol/atol bounds of the JAX parity tests.
Float64 and int64 are mandatory and explicit: every tensor is made with
its ``dtype`` (torch has no global x64 switch, and an int64 tensor times a
Python float is float32 in torch), because in float32 the drain recurrence
loses request mass far beyond those bounds.

Determinism. Two runs of one program are bitwise equal: no float sum uses
atomics (``index_add_``/``scatter_add_`` accumulate in a run-dependent
order on CUDA); segment sums over the static rack/group layouts are padded
gathers summed along a fixed axis, the one scatter (the power-aware
router's permutation) writes unique indices, and sorts are stable.

Blocks. Traces run in fixed blocks of :data:`_BLOCK` ticks with a per-tick
``live`` mask (dead ticks pass the carry through), and the post-trace drain
keeps the JAX engine's rewind: when the first fully idle drain tick lies
mid-block, the block is re-run from its starting carry with the mask cut at
that tick. On the card one tick is captured as a CUDA graph over static
buffers (the block's ``rps``/``live``/``is_trace`` rows, a device tick
counter, the carry updated in place, per-tick rows written at the counter)
and replayed ``_BLOCK`` times a block: the tick holds no host sync (no
``.item()``, no ``nonzero``, no Python branch on a tensor), and every
data-dependent pick is a gather. One tick rather than a whole block is
captured because a graph's capture time and memory grow with its node
count, and one tick of some 250 nodes is captured in milliseconds for each
fleet shape, while the 128 replays of a block cost the host about a
millisecond. On the CPU the same tick runs eagerly.

Chaos and degrade overlays are not ported yet: ``set_chaos`` and
``set_degrade`` raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import (
    TYPE_CHECKING,
    Any,
    Dict,
    List,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np
import torch

from repro_torch.config.torch_env import resolve_device
from repro_torch.fleet.engine_state import (
    GOV_FIXED,
    GOV_RACE,
    GOV_SCHED,
    FleetArrays,
    build_fleet_arrays,
)
from repro_torch.runtime import Telemetry, latency_percentiles
from repro_torch.runtime.result import Response

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from repro_torch.fleet.fleet import RackConfig

__all__ = ["ROUTER_KINDS", "SweepConfig", "sweep"]

#: branchless router selector values (params["router_kind"])
ROUTER_KINDS = {"round-robin": 0, "join-shortest-queue": 1, "power-aware": 2}

#: the fluid queue's per-request forgiveness (QueueWorkload pop rule)
_EPS = 1e-12

#: relative forgiveness for cumulative-axis comparisons: the carried S
#: (effective served) and the submission prefix sum A are two different
#: float summation orders of the same history, so after an overload
#: episode they drift apart by ~eps(|A|) — far above the absolute _EPS
#: once A reaches ~1e6 cost units. Completion tests along the cumulative
#: axis therefore forgive 1e-12 relative on top of the absolute floor
#: (still orders of magnitude below any real per-request cost).
_REL = 1e-12


def _cum_tol(x: Any) -> Any:
    """Forgiveness for comparisons between cumulative served/submitted
    totals (absolute floor + relative term, see ``_REL``)."""
    return _EPS + _REL * abs(x)

#: scan block size: one compiled program serves any trace length
_BLOCK = 128

_F64 = torch.float64
_I64 = torch.int64

#: what the step raises for the overlays this engine does not run yet
_OVERLAY_TODO = (
    "backend='torch' does not run the {} overlay yet: porting the chaos "
    "and degrade overlays is ROADMAP Queue 1 item 2, the next module to "
    "port; use backend='vector' meanwhile"
)


class _Dims(NamedTuple):
    """Static (hashable) shape info baked into the compiled program."""

    kmax: int
    has_thermal: bool
    nt: int
    n_groups: int
    max_sub: int
    hedge_on: bool
    # emit the extra per-tick rows (opp, w_req, c_low, w_low) the host
    # needs to expand observability state after the scan; compiled as a
    # separate program so obs-off pays nothing
    emit_obs: bool = False
    # chaos mask rows are threaded through xs and the evacuation /
    # unit-cap / floor-OPP overlays run in-scan; compiled separately so
    # a chaos-free fleet runs the exact pre-chaos program
    chaos_on: bool = False
    # graceful degradation (repro.fleet.degrade lowered in-scan):
    # deadline expiry, per-rack circuit breakers, tiered admission with
    # a retry ring. All off by default so a degrade-free fleet compiles
    # to the exact pre-degrade program.
    degrade_on: bool = False
    dg_admission: bool = False
    dg_breaker_on: bool = False
    dg_use_chaos: bool = False
    dg_tiers: int = 0
    dg_attempts: int = 1
    dg_ring_slots: int = 1
    dg_lag: int = 0


# ---------------------------------------------------------------------------
# pure per-tick pipeline (every tensor has a leading config axis N)


def _pick(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tab[r, idx[:, r]]`` for a shared ``(racks, opps)`` table and
    ``(N, racks)`` indices (``take_along_axis`` over the OPP axis)."""
    return tab.expand(idx.shape[0], -1, -1).gather(
        2, idx.unsqueeze(2)).squeeze(2)


def _seg(x: torch.Tensor, idx: torch.Tensor, fill: float) -> torch.Tensor:
    """Segments of ``x`` (N, m) laid out as ``(N, segments, longest)`` by
    a static padded index table whose pad entry ``m`` reads ``fill``; the
    caller reduces along the last axis, in a fixed order."""
    pad = torch.full((x.shape[0], 1), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)[:, idx]


def _route(
    params: Dict[str, Any],
    queued: torch.Tensor,
    total: torch.Tensor,
    dt: float,
    cap: torch.Tensor,
) -> torch.Tensor:
    """All three routers, computed branchlessly and selected by
    ``params["router_kind"]`` (N, 1), so every config of a sweep has its
    own router. Mirrors ``repro_torch.fleet.router``. ``queued`` and
    ``cap`` are (N, racks), ``total`` the offered rps (N, 1)."""
    n = cap.shape[1]
    rk = params["router_kind"]
    # round-robin: uniform spread
    rr = total / n
    # join-shortest-queue: water-fill on expected queueing delay
    capm = torch.clamp_min(cap, 1e-12)
    work = total * dt
    delay = queued / capm
    d, order = torch.sort(delay, dim=1, stable=True)
    c = capm.gather(1, order)
    q = queued.gather(1, order)
    levels = (work + torch.cumsum(q, 1)) / torch.cumsum(c, 1)
    ar = torch.arange(n, dtype=_I64, device=cap.device)
    feasible = torch.where(levels >= d, ar, -1)
    idx = feasible.amax(dim=1, keepdim=True)
    level = torch.where(idx < 0, levels[:, :1],
                        levels.gather(1, torch.clamp_min(idx, 0)))
    jsq = torch.clamp_min(cap * level - queued, 0.0) / dt
    # power-aware: pack the cheapest (J/request) racks first
    porder = params["pa_order"]
    capo = cap[:, porder]
    setpoint = capo * params["pa_util_target"]

    def greedy(tot: torch.Tensor, budget: torch.Tensor) -> torch.Tensor:
        before = torch.cat(
            [torch.zeros_like(budget[:, :1]),
             torch.cumsum(budget, 1)[:, :-1]], dim=1)
        return torch.minimum(torch.clamp_min(tot - before, 0.0), budget)

    take = greedy(total, setpoint)
    rem = total - take.sum(1, keepdim=True)
    take = take + torch.where(rem > 1e-12, greedy(rem, capo - take), 0.0)
    rem2 = total - take.sum(1, keepdim=True)
    spread = rem2 * capo / torch.clamp_min(capo.sum(1, keepdim=True), 1e-12)
    take = take + torch.where(rem2 > 1e-12, spread, 0.0)
    # back from power order to rack order (porder is a permutation, so
    # every index is written once)
    pa = torch.zeros_like(take).index_copy(1, porder, take)
    assign = torch.where(rk == 0, rr, torch.where(rk == 1, jsq, pa))
    # every router hands out nothing when there is no offered load
    return torch.where(total > 0.0, assign, 0.0)


def _select_opps(
    params: Dict[str, Any],
    dims: _Dims,
    opp: torch.Tensor,
    backlog: torch.Tensor,
    rate: torch.Tensor,
) -> torch.Tensor:
    """Branchless twin of ``_VectorFleetEngine._select_opps`` (which
    itself mirrors the scalar governors)."""
    gk = params["gov_kind"]
    opp = torch.where(gk == GOV_FIXED, params["fixed_opp"], opp)
    busy = (rate > 0.0) | backlog
    opp = torch.where(
        gk == GOV_RACE,
        torch.where(busy, params["highest"], params["nominal"]),
        opp,
    )
    # schedutil: lowest-energy OPP x unit-count search over the OPP axis
    need = rate * params["sched_headroom"]
    pos = need > 0.0
    best = params["highest"].expand_as(opp)
    bestp = torch.full_like(rate, float("inf"))
    for c in range(dims.kmax):
        eff = params["unit_rate"] * params["perf_tab"][:, c]
        ncnt = torch.maximum(
            params["min_units"].to(_F64), torch.ceil(need / eff)
        ).to(_I64)
        util = torch.clamp_max(
            rate / (torch.clamp_min(ncnt, 1).to(_F64) * eff), 1.0)
        power = (
            ncnt.to(_F64) * (params["p_idle"] + params["spk_tab"][:, c]
                             * util ** params["gamma"])
            + (params["n_units"] - ncnt).to(_F64) * params["p_base"]
        )
        upd = (
            (c < params["K"])
            & (ncnt <= params["n_units"])
            & pos
            & (power < bestp - 1e-12)
        )
        best = torch.where(upd, c, best)
        bestp = torch.where(upd, power, bestp)
    opp = torch.where(gk == GOV_SCHED, torch.where(pos, best, 0), opp)
    # thermal-aware ceiling clamps whatever the inner governor picked
    return torch.where(
        params["has_ceiling"], torch.minimum(opp, params["ceiling"]), opp
    )


def _thermal_step(
    params: Dict[str, Any],
    dims: _Dims,
    t_die: torch.Tensor,
    t_pcb: torch.Tensor,
    latched: torch.Tensor,
    pw: torch.Tensor,
    dt: float,
) -> Tuple[torch.Tensor, ...]:
    """Stacked RC Euler step (twin of ``_StackedThermal.step``). The
    per-rack sub-step counts are data-dependent, so the loop runs to the
    static worst case (``ThermalLayout.max_substeps``) with per-rack live
    masks — masked racks add exact zeros. Segment sums and maxima (group
    flows, the hottest PCB group, the hottest die, throttled units) are
    padded gathers reduced along a fixed axis."""
    rack_u = params["th_rack_u"]
    rack_g = params["th_rack_g"]
    group_of_u = params["th_group_of_u"]
    hottest = _seg(t_pcb, params["th_seg_g"], float("-inf")).amax(-1)
    raw_frac = (hottest - params["th_fan_low"]) / params["th_fan_span"]
    frac = torch.clamp(raw_frac, 0.0, 1.0)
    r_pcb = params["th_r_pcb0"] * (1.0 - (1.0 - params["th_fan_rmin"]) * frac)
    tau = torch.minimum(
        params["th_r_die"] * params["th_c_die"], r_pcb * params["th_c_pcb"]
    )
    denom = torch.clamp_min(0.25 * tau, 1e-6)
    n_sub = torch.clamp_min((dt / denom).to(_I64) + 1, 1)
    hh = dt / n_sub.to(_F64)
    h_u = hh[:, rack_u]
    h_g = hh[:, rack_g]
    r_pcb_g = r_pcb[:, rack_g]
    n_sub_u = n_sub[:, rack_u]
    n_sub_g = n_sub[:, rack_g]
    td, tp = t_die, t_pcb
    for s in range(dims.max_sub):
        f = (td - tp[:, group_of_u]) / params["th_r_die_u"]
        flows = _seg(f, params["th_seg_gu"], 0.0).sum(-1)
        d_die = h_u * (pw - f) / params["th_c_die_u"]
        out = (tp - params["th_t_amb_g"]) / r_pcb_g
        d_pcb = h_g * (flows - out) / params["th_c_pcb_g"]
        td = td + torch.where(s < n_sub_u, d_die, 0.0)
        tp = tp + torch.where(s < n_sub_g, d_pcb, 0.0)
    trip_u = params["th_trip"][rack_u]
    rel_u = params["th_release"][rack_u]
    new_latched = torch.where(latched, ~(td <= rel_u), td >= trip_u)
    fan_w = params["th_fan_pmax"] * frac
    max_temp = _seg(td, params["th_seg_u"], float("-inf")).amax(-1)
    n_thr = _seg(new_latched.to(_I64), params["th_seg_u"], 0).sum(-1)
    return td, tp, new_latched, fan_w, max_temp, n_thr


def _step(
    params: Dict[str, Any],
    dims: _Dims,
    carry: Dict[str, torch.Tensor],
    x: Dict[str, torch.Tensor],
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One fleet tick. ``x["live"]`` masks the whole tick (dead ticks
    pass the carry through unchanged); ``x["is_trace"]`` marks trace
    ticks (only those append to the hedge submission ring). ``x``'s
    values are shape (1,), shared by every config."""
    dt = params["dt"]
    live = x["live"]
    t = carry["t"]
    B = carry["B"]
    A = carry["A"]
    S = carry["S"]
    total = x["rps"] * params["trace_scale"]
    cap_units = params["n_units"]
    assign = _route(params, B, total, dt, params["capacity_rps"])
    work = assign * dt
    rate = work / dt
    # frequency governors pick this tick's OPP (window_s == dt_s)
    opp = _select_opps(params, dims, carry["opp"], carry["backlog"], rate)
    perf_req = _pick(params["perf_tab"], opp)
    perf_sz = torch.where(params["has_table"], perf_req, 1.0)
    # UnitGovernor.target_units / apply_target with group == 1
    need = rate * params["headroom"] / (
        params["unit_rate"] * torch.clamp_min(perf_sz, 1e-9)
    )
    raw = torch.minimum(
        params["n_units"].to(_F64),
        torch.maximum(params["min_units"].to(_F64), torch.ceil(need)),
    )
    tgt = torch.clamp_min(raw.to(_I64), 1)
    active = carry["active"]
    up = tgt > active
    keep_n = torch.maximum(params["minq"], tgt)
    in_cooldown = t - carry["last_down"] > params["cooldown"]
    down = (tgt < active) & in_cooldown & (keep_n < active)
    new_active = torch.where(up, tgt, torch.where(down, keep_n, active))
    scale = up.to(_I64) + down.to(_I64)
    scale_events = carry["scale_events"] + scale
    last_down = torch.where(down, t, carry["last_down"])
    k_f = new_active.to(_F64)
    # mean perf-scale over active units; trip-latched dies dragged to
    # the floor OPP (pool.perf_scale / _perf_from_opp_counts)
    perf_used = torch.where(params["has_table"], (k_f * perf_req) / k_f, 1.0)
    if dims.has_thermal:
        ti = params["t_idx"]
        rack_u = params["th_rack_u"]
        latched = carry["latched"]
        am = params["th_local_idx"] < new_active[:, ti][:, rack_u]
        lam = (am & latched).to(_I64)
        c_low_t = _seg(lam, params["th_seg_u"], 0).sum(-1)
        c_low_f = c_low_t.to(_F64)
        k_t = k_f[:, ti]
        p0 = params["perf_tab"][:, 0][ti]
        pr = perf_req[:, ti]
        floor_all = (opp[:, ti] == 0) & (c_low_t > 0)
        mixed = c_low_f * p0 + (k_t - c_low_f) * pr
        perf_used[:, ti] = torch.where(floor_all, k_t * p0, mixed) / k_t
    # straggler hedging: the submission ring carries (cumulative cost,
    # arrival) per trace tick; the head request is the first submission
    # not yet fully served (searchsorted past S + forgiveness)
    arrival_t = t + 0.5 * dt
    A_new = A + work
    if dims.hedge_on:
        wmask = x["is_trace"] & live
        ptr = carry["ptr"]
        A_buf = carry["A_buf"]
        arr_buf = carry["arr_buf"]
        # ptr reaches the ring's length after the last trace tick; the
        # write there is masked off, so clamp the index (JAX drops it)
        slot = torch.clamp_max(ptr, A_buf.shape[2] - 1).unsqueeze(2)
        slot = slot.expand(-1, A_buf.shape[1], 1)
        A_buf = A_buf.scatter(2, slot, torch.where(
            wmask, A_new.unsqueeze(2), A_buf.gather(2, slot)))
        arr_buf = arr_buf.scatter(2, slot, torch.where(
            wmask, arrival_t.expand_as(A).unsqueeze(2),
            arr_buf.gather(2, slot)))
        new_ptr = ptr + wmask.to(_I64)
        disp = S
        head = torch.searchsorted(
            A_buf, (disp + _cum_tol(disp)).unsqueeze(2), right=True
        ).squeeze(2)
        hidx = torch.minimum(head, torch.clamp_min(new_ptr - 1, 0))
        head_arrival = arr_buf.gather(2, hidx.unsqueeze(2)).squeeze(2)
        age = torch.clamp_min(t - head_arrival, 0.0)
        pending = (B + work) > 0.0
        h = (
            pending
            & (age > params["hedge_deadline"])
            & (new_active < cap_units)
        ).to(_I64)
    else:
        h = torch.zeros_like(new_active)
    hedged = carry["hedged"] + h
    # fluid FIFO drain (QueueWorkload.step_fast collapsed to B/A/S)
    cap = (
        torch.clamp_min(new_active + h, 0).to(_F64)
        * params["unit_rate"]
        * dt
        * torch.clamp_min(perf_used, 0.0)
    )
    Bw = B + work
    empty = Bw <= cap + _EPS
    used = torch.where(empty, Bw, cap)
    B_new = torch.where(empty, 0.0, Bw - cap)
    S_new = torch.where(empty, S + Bw, S + cap)
    cap_safe = torch.where(cap > 0.0, cap, 1.0)
    util = torch.where(cap > 0.0, used / cap_safe, 0.0)
    backlog = B_new > 0.0
    served = carry["served"] + used
    # UnitPool.charge: active units at the rack's OPP (latched dies at
    # the floor), the borrowed hedge unit at the requested point, the
    # rest at the gated floor
    u = torch.clamp(util, 0.0, 1.0)
    ug = u ** params["gamma"]
    spk_req = _pick(params["spk_tab"], opp)
    w_req = params["p_idle"] + spk_req * ug
    h_f = h.to(_F64)
    powered = new_active + h
    powered_f = powered.to(_F64)
    p_act = k_f * w_req
    fan_w = torch.zeros_like(w_req)
    if dims.has_thermal:
        w_low = params["p_idle"] + params["spk_tab"][:, 0] * ug
        w_low_t = w_low[:, ti]
        w_req_t = w_req[:, ti]
        mixed_w = c_low_f * w_low_t + (k_t - c_low_f) * w_req_t
        p_act[:, ti] = torch.where(floor_all, k_t * w_low_t, mixed_w)
        pw = params["p_base"][ti][rack_u]
        pw = torch.where(am, w_req_t[:, rack_u], pw)
        pw = torch.where(am & latched, w_low_t[:, rack_u], pw)
        last_u = params["th_last_unit"]
        pw[:, last_u] = torch.where(h[:, ti] > 0, w_req_t, pw[:, last_u])
        t_die, t_pcb, new_latched, fan_t, temp_t, thr_t = _thermal_step(
            params, dims, carry["t_die"], carry["t_pcb"], latched, pw, dt
        )
        fan_w[:, ti] = fan_t
    p_units = torch.where(
        params["has_table"], p_act + h_f * w_req, powered_f * w_req
    )
    p_rest = (params["n_units"] - powered).to(_F64) * params["p_base"]
    total_w = params["p_shared"] + fan_w + p_units + p_rest
    energy = carry["energy"] + total_w * dt
    unit_energy = carry["unit_energy"] + p_units * dt
    pf_safe = torch.where(powered_f > 0.0, powered_f, 1.0)
    util_agg = torch.where(powered_f > 0.0, powered_f * u / pf_safe, 0.0)

    def keep(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
        return torch.where(live, new, old)

    new_carry: Dict[str, torch.Tensor] = {
        "t": keep(t + dt, t),
        "B": keep(B_new, B),
        "A": keep(A_new, A),
        "S": keep(S_new, S),
        "opp": keep(opp, carry["opp"]),
        "backlog": keep(backlog, carry["backlog"]),
        "active": keep(new_active, active),
        "last_down": keep(last_down, carry["last_down"]),
        "scale_events": keep(scale_events, carry["scale_events"]),
        "hedged": keep(hedged, carry["hedged"]),
        "energy": keep(energy, carry["energy"]),
        "unit_energy": keep(unit_energy, carry["unit_energy"]),
        "served": keep(served, carry["served"]),
    }
    if dims.has_thermal:
        new_carry["t_die"] = keep(t_die, carry["t_die"])
        new_carry["t_pcb"] = keep(t_pcb, carry["t_pcb"])
        new_carry["latched"] = keep(new_latched, latched)
    if dims.hedge_on:
        new_carry["A_buf"] = keep(A_buf, carry["A_buf"])
        new_carry["arr_buf"] = keep(arr_buf, carry["arr_buf"])
        new_carry["ptr"] = keep(new_ptr, carry["ptr"])
    ys: Dict[str, torch.Tensor] = {
        "assign": assign,
        "rate": rate,
        "work": work,
        "empty": empty,
        "used": used,
        "S": S_new,
        "cap": cap,
        "perf": perf_used,
        "active": powered,
        "power": total_w,
        "util": util_agg,
        "hedge": h,
        "scale": scale,
    }
    if dims.has_thermal:
        ys["fan"] = fan_t
        ys["temp"] = temp_t
        ys["thr"] = thr_t
    if dims.emit_obs:
        ys["opp"] = opp
        ys["w_req"] = w_req
        if dims.has_thermal:
            ys["c_low"] = c_low_f
            ys["w_low"] = w_low
    return new_carry, ys


class _Runner:
    """Runs :func:`_step` a block at a time over static buffers.

    The carry (updated in place), the block's input rows and a device
    tick counter are fixed tensors, so on the card the tick is captured
    once as a CUDA graph and replayed; on the CPU it runs eagerly.
    After :meth:`run_block`, ``ys[k][i]`` holds tick ``i``'s row."""

    def __init__(
        self,
        params: Dict[str, Any],
        dims: _Dims,
        carry: Dict[str, torch.Tensor],
        device: torch.device,
        graph: bool = True,
    ) -> None:
        self.params = params
        self.dims = dims
        self.carry = carry
        self.device = device
        self.xs = {
            "rps": torch.zeros(_BLOCK, dtype=_F64, device=device),
            "live": torch.zeros(_BLOCK, dtype=torch.bool, device=device),
            "is_trace": torch.zeros(_BLOCK, dtype=torch.bool, device=device),
        }
        self.i = torch.zeros(1, dtype=_I64, device=device)
        # row shapes from one dead tick (its carry is discarded)
        _, ys = _step(params, dims, carry, self._x())
        self.ys = {
            k: torch.empty((_BLOCK,) + tuple(v.shape), dtype=v.dtype,
                           device=device)
            for k, v in ys.items()
        }
        self.use_graph = graph and device.type == "cuda"
        self._graph: Optional[Any] = None

    def _x(self) -> Dict[str, torch.Tensor]:
        return {k: v.index_select(0, self.i) for k, v in self.xs.items()}

    def _tick(self) -> None:
        new, ys = _step(self.params, self.dims, self.carry, self._x())
        for k, v in new.items():
            self.carry[k].copy_(v)
        for k, v in ys.items():
            self.ys[k].index_copy_(0, self.i, v.unsqueeze(0))
        self.i.add_(1)

    def _capture(self) -> None:
        """Warm the tick up on a side stream (the carry is restored
        after), then capture it."""
        saved = self.snapshot()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._tick()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.restore(saved)
        self.i.zero_()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._tick()
        self._graph = graph

    def snapshot(self) -> Dict[str, torch.Tensor]:
        return {k: v.clone() for k, v in self.carry.items()}

    def restore(self, snap: Dict[str, torch.Tensor]) -> None:
        for k, v in snap.items():
            self.carry[k].copy_(v)

    def run_block(
        self, rps: np.ndarray, live: np.ndarray, is_trace: np.ndarray
    ) -> Dict[str, torch.Tensor]:
        for key, row in (("rps", rps), ("live", live),
                         ("is_trace", is_trace)):
            self.xs[key].copy_(torch.from_numpy(np.ascontiguousarray(row)))
        self.i.zero_()
        if self.use_graph:
            if self._graph is None:
                self._capture()
            for _ in range(_BLOCK):
                self._graph.replay()
        else:
            for _ in range(_BLOCK):
                self._tick()
        return self.ys


# ---------------------------------------------------------------------------
# static params / carry builders (shared by the engine and sweep())


def _full_load_j_per_req(racks: "Sequence[RackConfig]") -> np.ndarray:
    """Same ranking key ``Fleet`` publishes to the PowerAwareRouter."""
    return np.array(
        [
            (rc.spec.p_shared + rc.spec.n_units * rc.spec.unit.power(1.0))
            / (rc.spec.n_units * rc.unit_rate)
            for rc in racks
        ],
        float,
    )


def _base_params(
    arr: FleetArrays, dt_s: float, jpr: np.ndarray
) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "dt": float(dt_s),
        "trace_scale": 1.0,
        "router_kind": np.int64(ROUTER_KINDS["join-shortest-queue"]),
        "pa_util_target": 0.85,
        "pa_order": np.argsort(jpr, kind="stable"),
        "capacity_rps": arr.n_units.astype(float) * arr.unit_rate,
        "n_units": arr.n_units,
        "unit_rate": arr.unit_rate,
        "headroom": arr.headroom,
        "min_units": arr.min_units,
        "minq": arr.minq,
        "cooldown": arr.cooldown,
        "p_shared": arr.p_shared,
        "p_idle": arr.p_idle,
        "gamma": arr.gamma,
        "p_base": arr.p_base,
        "has_table": arr.has_table,
        "K": arr.K,
        "perf_tab": arr.perf_tab,
        "spk_tab": arr.spk_tab,
        "nominal": arr.nominal,
        "highest": arr.highest,
        "gov_kind": arr.gov_kind,
        "fixed_opp": arr.fixed_opp,
        "sched_headroom": arr.sched_headroom,
        "ceiling": arr.ceiling,
        "has_ceiling": arr.has_ceiling,
        "hedge_deadline": np.array(
            [np.inf if dl is None else float(dl) for dl in arr.hedge_deadline]
        ),
    }
    th = arr.thermal
    if th is not None:
        p.update(
            t_idx=th.t_idx,
            th_rack_u=th.rack_u,
            th_rack_g=th.rack_g,
            th_group_of_u=th.group_of_u,
            th_local_idx=th.local_idx,
            th_last_unit=th.last_unit,
            th_r_die=th.r_die,
            th_c_die=th.c_die,
            th_r_pcb0=th.r_pcb0,
            th_c_pcb=th.c_pcb,
            th_t_amb_g=th.t_amb_g,
            th_fan_low=th.fan_low,
            th_fan_span=th.fan_span,
            th_fan_rmin=th.fan_rmin,
            th_fan_pmax=th.fan_pmax,
            th_trip=th.trip,
            th_release=th.release,
            th_r_die_u=th.r_die_u,
            th_c_die_u=th.c_die_u,
            th_c_pcb_g=th.c_pcb_g,
        )
    return p


def _make_dims(
    arr: FleetArrays,
    dt_s: float,
    hedge_on: bool,
    emit_obs: bool = False,
    chaos_on: bool = False,
    degrade: Optional[Any] = None,
) -> _Dims:
    th = arr.thermal
    return _Dims(
        kmax=int(arr.Kmax),
        has_thermal=th is not None,
        nt=0 if th is None else int(len(th.t_idx)),
        n_groups=0 if th is None else th.n_groups,
        max_sub=0 if th is None else th.max_substeps(dt_s),
        hedge_on=hedge_on,
        emit_obs=emit_obs,
        chaos_on=chaos_on,
        degrade_on=degrade is not None,
        dg_admission=degrade is not None and degrade.admission_on,
        dg_breaker_on=degrade is not None and degrade.breaker_on,
        dg_use_chaos=(
            degrade is not None
            and degrade.breaker_on
            and degrade.policy.breaker.use_chaos_signal
        ),
        dg_tiers=0 if degrade is None else int(degrade.n_tiers),
        dg_attempts=(
            1 if degrade is None else int(degrade.retry.max_attempts)
        ),
        dg_ring_slots=1 if degrade is None else int(degrade.ring_slots),
        dg_lag=0 if degrade is None else int(degrade.deadline_lag),
    )


def _fresh_carry(arr: FleetArrays, hedge_on: bool, tbuf: int) -> Dict[str, Any]:
    n = arr.n_racks
    c: Dict[str, Any] = {
        "t": np.float64(0.0),
        "B": np.zeros(n),
        "A": np.zeros(n),
        "S": np.zeros(n),
        "opp": arr.opp0.copy(),
        "backlog": np.zeros(n, bool),
        "active": arr.minq.copy(),
        "last_down": np.full(n, -1e9),
        "scale_events": np.zeros(n, np.int64),
        "hedged": np.zeros(n, np.int64),
        "energy": np.zeros(n),
        "unit_energy": np.zeros(n),
        "served": np.zeros(n),
    }
    th = arr.thermal
    if th is not None:
        c["t_die"] = th.t_amb[th.rack_u].copy()
        c["t_pcb"] = th.t_amb[th.rack_g].copy()
        c["latched"] = np.zeros(th.n_flat_units, bool)
    if hedge_on:
        c["A_buf"] = np.full((n, tbuf), np.inf)
        c["arr_buf"] = np.full((n, tbuf), np.inf)
        c["ptr"] = np.int64(0)
    return c


#: params that carry the config axis (a sweep's knobs); the rest are
#: one fleet's static arrays, shared by every config
_BATCHED = ("router_kind", "trace_scale", "unit_rate", "capacity_rps",
            "headroom", "sched_headroom", "hedge_deadline")
#: params the step reads as Python floats (baked into a captured graph)
_SCALARS = ("dt", "pa_util_target")


def _tensor(v: Any, device: torch.device) -> torch.Tensor:
    """numpy -> tensor with an explicit 64-bit dtype (bool stays bool)."""
    a = np.asarray(v)
    if a.dtype == bool:
        dtype = torch.bool
    elif np.issubdtype(a.dtype, np.integer):
        dtype = _I64
    else:
        dtype = _F64
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


def _segments(seg: np.ndarray, n_seg: int) -> np.ndarray:
    """Padded index table of a segment layout: row ``s`` lists the
    positions ``i`` with ``seg[i] == s`` in ascending order, padded with
    ``len(seg)`` (the pad slot :func:`_seg` appends)."""
    rows = [np.nonzero(seg == s)[0] for s in range(n_seg)]
    width = max(len(r) for r in rows)
    out = np.full((n_seg, width), len(seg), np.int64)
    for s, r in enumerate(rows):
        out[s, : len(r)] = r
    return out


def _device_params(
    params: Dict[str, Any], arr: FleetArrays, device: torch.device
) -> Dict[str, Any]:
    """Params on the device: the ``_BATCHED`` keys must already carry the
    config axis N (scalars become (N, 1)), the rest stay shared; the
    thermal layout gains the padded segment tables of its three sums."""
    out: Dict[str, Any] = {}
    for k, v in params.items():
        if k in _SCALARS:
            out[k] = float(v)
        elif k in _BATCHED:
            a = np.asarray(v)
            out[k] = _tensor(a.reshape(a.shape[0], -1), device)
        else:
            out[k] = _tensor(v, device)
    th = arr.thermal
    if th is not None:
        nt = len(th.t_idx)
        out["th_seg_u"] = _tensor(_segments(th.rack_u, nt), device)
        out["th_seg_g"] = _tensor(_segments(th.rack_g, nt), device)
        out["th_seg_gu"] = _tensor(
            _segments(th.group_of_u, th.n_groups), device)
    return out


def _device_carry(
    carry: Dict[str, Any], n_cfg: int, device: torch.device
) -> Dict[str, torch.Tensor]:
    """The host carry given a leading config axis (scalars become
    (N, 1)), as contiguous tensors the step updates in place."""
    out = {}
    for k, v in carry.items():
        a = np.asarray(v)
        a = a.reshape(1) if a.ndim == 0 else a
        out[k] = _tensor(
            np.broadcast_to(a, (n_cfg,) + a.shape).copy(), device)
    return out


def _host_rows(ys: Dict[str, torch.Tensor], n: int) -> Dict[str, np.ndarray]:
    """The first ``n`` ticks of a batch-1 block's rows, copied to the host
    (the block buffers are rewritten by the next block)."""
    return {k: _numpy(v[:n, 0]) for k, v in ys.items()}


def _numpy(v: torch.Tensor) -> np.ndarray:
    """A host copy (``.cpu()`` of a CPU tensor is the tensor itself)."""
    return v.cpu().numpy().copy()


# ---------------------------------------------------------------------------
# host-side request reconstruction (completions / latencies / queue depth)


def _expand_submissions(
    work_col: np.ndarray, split_rows: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Expand each work-carrying tick into per-tier sub-submissions,
    mirroring ``fleet._tier_requests`` exactly: slice existence is
    decided by ``frac > 0`` alone, non-last slices cost ``work * frac``
    and the last positive-fraction slice takes the exact remainder (the
    trailing column is the untiered chaos respill, tier index ``-1``
    → tier count). Returns (submission ticks, costs, tier indices)."""
    ticks: List[int] = []
    costs: List[float] = []
    tiers: List[int] = []
    for i in np.nonzero(work_col > 0.0)[0]:
        w = float(work_col[i])
        row = split_rows[i]
        idx = np.nonzero(row > 0.0)[0]
        if len(idx) == 0:
            # no split recorded for a work-carrying tick (should not
            # happen: routed work implies admitted flow) — keep the
            # mass as one untiered submission rather than drop it
            ticks.append(int(i))
            costs.append(w)
            tiers.append(len(row) - 1)
            continue
        acc = 0.0
        for k in idx[:-1]:
            c = w * float(row[k])
            ticks.append(int(i))
            costs.append(c)
            tiers.append(int(k))
            acc += c
        c = w - acc
        if c > 0.0:
            ticks.append(int(i))
            costs.append(c)
            tiers.append(int(idx[-1]))
    return (
        np.asarray(ticks, np.int64),
        np.asarray(costs),
        np.asarray(tiers, np.int64),
    )


def _completions(
    work_col: np.ndarray,
    s_col: np.ndarray,
    split_rows: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Per-rack submission ticks, cumulative-cost tails, completion
    ticks, and (when tiered) tier indices. Without ``split_rows`` one
    fluid request is reconstructed per work-carrying tick; with it,
    each tick expands into the same per-tier sub-requests the host
    engines submit via ``_tier_requests``, so response / queued / void
    *counts* match the hosts. Submission ``k`` completes at the first
    tick whose cumulative effective served ``S`` reaches its cumulative
    cost tail, minus the cumulative-axis forgiveness (``_cum_tol`` —
    the pop rule of ``QueueWorkload``, widened to relative because
    ``a`` and ``s_col`` are different float summation orders of the
    same history). A completion index of ``len(s_col)`` means "still
    queued"."""
    if split_rows is None:
        a = np.cumsum(work_col)  # reprolint: ok[RPL001] jax tolerance-parity: prefix cumsum replays the device carry's sequential adds
        sub = np.nonzero(work_col > 0.0)[0]
        a_sub = a[sub]
        tiers = None
    else:
        sub, costs, tiers = _expand_submissions(work_col, split_rows)
        a_sub = np.cumsum(costs)  # reprolint: ok[RPL001] jax tolerance-parity: prefix cumsum replays the device carry's sequential adds
    j = np.searchsorted(s_col, a_sub - _cum_tol(a_sub), side="left")
    return sub, a_sub, j, tiers


def _queued_for_rack(
    work_col: np.ndarray,
    s_col: np.ndarray,
    split_rows: Optional[np.ndarray] = None,
) -> np.ndarray:
    """End-of-tick queued request count per tick (len(queue) twin)."""
    t_all = len(work_col)
    sub, _, j, _ = _completions(work_col, s_col, split_rows)
    diff = np.zeros(t_all + 1, np.int64)
    np.add.at(diff, sub, 1)
    np.add.at(diff, np.minimum(j, t_all), -1)
    return np.cumsum(diff[:-1])  # reprolint: ok[RPL001] jax tolerance-parity: int64 prefix sum, exact in any order


def _responses_for_rack(
    ts: np.ndarray,
    dt: float,
    work_col: np.ndarray,
    s_col: np.ndarray,
    cap_col: np.ndarray,
    perf_col: np.ndarray,
    unit_rate: float,
    evac_col: Optional[np.ndarray] = None,
    split_rows: Optional[np.ndarray] = None,
    payloads: Optional[List[Optional[str]]] = None,
) -> List[Response]:
    """Rebuild the rack's :class:`Response` list from emitted rows,
    with ``QueueWorkload.step_fast``'s finish-time arithmetic. With
    ``split_rows``/``payloads`` (tiered admission active) each tick
    expands into the hosts' per-tier sub-requests and every Response
    carries its tier name as ``output`` — the same tagging the host
    engines get from ``QueueWorkload`` echoing ``Request.payload`` —
    so :func:`repro_torch.fleet.degrade.tier_latency_percentiles` works on
    jax telemetry within the engine's documented tolerances.

    ``evac_col`` is the per-tick cost *voided* without being served:
    chaos evacuations (the whole pending queue flushed by a kill edge)
    plus deadline expiries (``QueueWorkload.expire``). The dispatched
    axis becomes ``S + cumsum(void)``, and a request whose cumulative
    tail lands inside its crossing tick's void jump emits no Response.
    Voiding happens *before* serving within a tick (kill edges and
    expiry both run pre-routing), so the in-tick order of the jump vs
    the served mass is void-first — a request past the jump at an
    expiry tick genuinely completed (unlike a kill tick, where the
    rack's unit cap is 0 and nothing serves)."""
    if evac_col is not None:
        s_col = s_col + np.cumsum(evac_col)  # reprolint: ok[RPL001] jax tolerance-parity: prefix cumsum replays the device carry's sequential adds
    sub, a_sub, j, tiers = _completions(work_col, s_col, split_rows)
    t_all = len(ts)
    done: List[Tuple[int, int, Response]] = []
    for k in range(len(sub)):
        jj = int(j[k])
        if jj >= t_all:
            continue  # never completed (undrained overload)
        s_prev = float(s_col[jj - 1]) if jj > 0 else 0.0
        void_j = float(evac_col[jj]) if evac_col is not None else 0.0
        a_k = float(a_sub[k])
        if void_j > 0.0 and a_k - _cum_tol(a_k) <= s_prev + void_j:
            continue  # voided (evacuated or expired), not served
        # the void jump consumes no serving capacity: the mass served
        # *into* this request excludes it
        s_prev += void_j
        arrival = float(ts[sub[k]]) + 0.5 * dt
        cap_j = float(cap_col[jj])
        if cap_j > 0.0:
            frac = min(a_k - s_prev, cap_j) / cap_j
        else:
            frac = 1.0
        service_s = 1.0 / (unit_rate * max(float(perf_col[jj]), 1e-9))
        finish = max(float(ts[jj]) + frac * dt, arrival + service_s)
        out = None
        if tiers is not None and payloads is not None:
            tk = int(tiers[k])
            if 0 <= tk < len(payloads):
                out = payloads[tk]
        done.append(
            (jj, k,
             Response(rid=k, arrival_s=arrival, finish_s=finish, output=out))
        )
    done.sort(key=lambda it: (it[0], it[1]))  # completion order, FIFO in-tick
    return [resp for _, _, resp in done]


class _ThermalState:
    """Host mirror of the stacked RC state (what the sanitizer reads)."""

    def __init__(self, layout: Any) -> None:
        self.layout = layout
        self.t_die = layout.t_amb[layout.rack_u].copy()
        self.t_pcb = layout.t_amb[layout.rack_g].copy()
        self.latched = np.zeros(layout.n_flat_units, bool)


# ---------------------------------------------------------------------------
# the engine


class _TorchFleetEngine:
    """Block-stepped torch engine behind ``Fleet(backend="torch")``.

    Holds all mutable simulation state on the host between ``play``
    calls (so ``play_trace`` composes cumulatively like the other
    engines) and runs each call as blocks of :func:`_step` on the device,
    a CUDA graph replayed on the card. Routing happens *in-step* — the
    fleet's router object is only used to pick the branchless router
    kind, so only the built-in routers (and built-in governors) are
    supported; anything else must use ``backend="vector"``.
    """

    backend = "torch"

    def __init__(
        self,
        racks: "Sequence[RackConfig]",
        dt_s: float,
        idle_units_off: bool,
        router: Any,
        device: str = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        arr = build_fleet_arrays(racks, idle_units_off)
        if arr.generic:
            kinds = sorted({type(g).__name__ for _, g in arr.generic})
            raise ValueError(
                "backend='torch' steps the governor passes as tensors and "
                "only supports the built-in governors (fixed / "
                f"race-to-idle / schedutil / thermal-aware); got {kinds} "
                "— use backend='vector' for generic governors"
            )
        rname = getattr(router, "name", type(router).__name__)
        if rname not in ROUTER_KINDS:
            raise ValueError(
                "backend='torch' routes in-step and only knows "
                f"{sorted(ROUTER_KINDS)}; got router {rname!r} — use "
                "backend='vector' for custom routers"
            )
        self.arrays = arr
        self.dt_s = float(dt_s)
        self.now = 0.0
        self.n_racks = arr.n_racks
        # sanitizer-facing static surface
        self.K = arr.K
        self.has_table = arr.has_table
        params = _base_params(arr, dt_s, _full_load_j_per_req(racks))
        params["router_kind"] = np.int64(ROUTER_KINDS[rname])
        params["pa_util_target"] = float(getattr(router, "util_target", 0.85))
        for k in _BATCHED:  # this fleet is a batch of one config
            params[k] = np.asarray(params[k])[None]
        self._params = _device_params(params, arr, self.device)
        self._hedge_any = arr.any_hedge
        # set by Fleet._wire_obs; rows are expanded host-side after play
        self.obs: Optional[Any] = None
        # mutable per-rack state (mirrors _fresh_carry)
        n = arr.n_racks
        self._B = np.zeros(n)
        self._A = np.zeros(n)
        self._S = np.zeros(n)
        self.opp = arr.opp0.copy()
        self._backlog = np.zeros(n, bool)
        self.active = arr.minq.copy()
        self._last_down = np.full(n, -1e9)
        self.scale_events = np.zeros(n, np.int64)
        self.hedged_cnt = np.zeros(n, np.int64)
        self.energy = np.zeros(n)
        self.unit_energy = np.zeros(n)
        self.served_acc = np.zeros(n)
        self.therm: Optional[_ThermalState] = (
            _ThermalState(arr.thermal) if arr.thermal is not None else None
        )
        self._A_buf = np.full((n, 0), np.inf)
        self._arr_buf = np.full((n, 0), np.inf)
        self._ptr = 0
        # cumulative per-tick emitted history (for telemetry rebuilds)
        self._t_hist: List[float] = []
        self._hist: Dict[str, List[np.ndarray]] = {}

    def set_chaos(self, lowered: Any) -> None:
        """Refuses: the chaos overlay is not ported to this engine."""
        raise NotImplementedError(_OVERLAY_TODO.format("chaos"))

    def set_degrade(self, lowered: Any) -> None:
        """Refuses: the degrade overlay is not ported to this engine."""
        raise NotImplementedError(_OVERLAY_TODO.format("degrade"))

    # -- sanitizer / Fleet.view surface ---------------------------------
    def queued_cost(self) -> np.ndarray:
        return self._B.copy()

    def active_units(self) -> np.ndarray:
        return self.active.copy()

    # -------------------------------------------------------------------
    def _carry(self, hedge_on: bool) -> Dict[str, Any]:
        c: Dict[str, Any] = {
            "t": np.float64(self.now),
            "B": self._B,
            "A": self._A,
            "S": self._S,
            "opp": self.opp,
            "backlog": self._backlog,
            "active": self.active,
            "last_down": self._last_down,
            "scale_events": self.scale_events,
            "hedged": self.hedged_cnt,
            "energy": self.energy,
            "unit_energy": self.unit_energy,
            "served": self.served_acc,
        }
        if self.therm is not None:
            c["t_die"] = self.therm.t_die
            c["t_pcb"] = self.therm.t_pcb
            c["latched"] = self.therm.latched
        if hedge_on:
            c["A_buf"] = self._A_buf
            c["arr_buf"] = self._arr_buf
            c["ptr"] = np.int64(self._ptr)
        return c

    def _full(self, key: str) -> np.ndarray:
        rows = self._hist.get(key)
        if not rows:
            return np.zeros((0, self.n_racks))
        return np.concatenate(rows, axis=0)

    # -------------------------------------------------------------------
    def play(
        self, trace_rps: Sequence[float], drain: bool = True
    ) -> Tuple[np.ndarray, np.ndarray, int, Optional[bool]]:
        """Run the whole trace (plus post-trace drain) in one shot.

        Returns ``(assigned_rps, queued_rows, n_drain_ticks, drained)``
        with one row per simulated tick; ``drained`` is ``None`` when
        the call simulated no ticks at all.
        """
        trace = np.asarray(trace_rps, float)
        dt = self.dt_s
        t_len = len(trace)
        n = self.n_racks
        if self._hedge_any and t_len > 0:
            pad = np.full((n, t_len), np.inf)
            self._A_buf = np.concatenate([self._A_buf, pad], axis=1)
            self._arr_buf = np.concatenate([self._arr_buf, pad.copy()], axis=1)
        hedge_on = self._hedge_any and self._A_buf.shape[1] > 0
        dims = _make_dims(self.arrays, dt, hedge_on,
                          emit_obs=self.obs is not None)
        run = _Runner(self._params, dims,
                      _device_carry(self._carry(hedge_on), 1, self.device),
                      self.device)
        zeros = np.zeros(_BLOCK)
        falses = np.zeros(_BLOCK, bool)
        kept: List[Dict[str, np.ndarray]] = []
        pos = 0
        while pos < t_len:
            blk = min(_BLOCK, t_len - pos)
            rps = np.zeros(_BLOCK)
            rps[:blk] = trace[pos : pos + blk]
            live = np.zeros(_BLOCK, bool)
            live[:blk] = True
            kept.append(_host_rows(run.run_block(rps, live, live), blk))
            pos += blk
        if kept:
            all_empty = bool(kept[-1]["empty"][-1].all())
        else:
            all_empty = bool(np.all(self._B <= 0.0))
        drained: Optional[bool]
        if drain:
            # keep ticking until the first tick that starts fully idle
            # (inclusive) — the same stop tick Fleet.play_trace's
            # queued/concurrency break lands on — bounded by the same
            # 10x-trace safety cap
            cap_ticks = 10 * t_len + 100
            done = 0
            found = False
            while done < cap_ticks and not found:
                blk = min(_BLOCK, cap_ticks - done)
                live = np.zeros(_BLOCK, bool)
                live[:blk] = True
                carry0 = run.snapshot()
                rows = _host_rows(run.run_block(zeros, live, falses), blk)
                allm = rows["empty"].all(axis=1)
                start_idle = np.concatenate(([all_empty], allm[:-1]))
                idle = np.nonzero(start_idle)[0]
                if len(idle):
                    # rewind: re-run the block with the mask cut at the
                    # first idle tick, landing the carry on it
                    stop = int(idle[0])
                    live2 = np.zeros(_BLOCK, bool)
                    live2[: stop + 1] = True
                    run.restore(carry0)
                    run.run_block(zeros, live2, falses)
                    kept.append({k: v[: stop + 1] for k, v in rows.items()})
                    found = True
                else:
                    kept.append(rows)
                    all_empty = bool(allm[-1])
                    done += blk
            drained = found
        elif t_len == 0:
            drained = None
        else:
            last = kept[-1]
            drained = bool(
                last["empty"][-1].all() and not (last["used"][-1] > 0.0).any()
            )
        # pull the final carry back into host state
        fin = {k: _numpy(v[0]) for k, v in run.carry.items()}
        self.now = float(fin["t"][0])
        self._B = fin["B"]
        self._A = fin["A"]
        self._S = fin["S"]
        self.opp = fin["opp"]
        self._backlog = fin["backlog"]
        self.active = fin["active"]
        self._last_down = fin["last_down"]
        self.scale_events = fin["scale_events"]
        self.hedged_cnt = fin["hedged"]
        self.energy = fin["energy"]
        self.unit_energy = fin["unit_energy"]
        self.served_acc = fin["served"]
        if self.therm is not None:
            self.therm.t_die = fin["t_die"]
            self.therm.t_pcb = fin["t_pcb"]
            self.therm.latched = fin["latched"]
        if hedge_on:
            self._A_buf = fin["A_buf"]
            self._arr_buf = fin["arr_buf"]
            self._ptr = int(fin["ptr"][0])
        # append this call's rows to the cumulative history
        if kept:
            rows_all = {k: np.concatenate([r[k] for r in kept]) for k in kept[0]}
            n_rows = int(rows_all["empty"].shape[0])
        else:
            rows_all = {}
            n_rows = 0
        t0 = self.now - n_rows * dt
        if n_rows:
            self._t_hist.extend((t0 + np.arange(n_rows) * dt).tolist())
            for k, v in rows_all.items():
                self._hist.setdefault(k, []).append(v)
        # queue depths come from the *full* history (cumulative S/A)
        work_all = self._full("work")
        s_all = self._full("S")
        queued_rows = np.zeros((n_rows, n), np.int64)
        for r in range(n):
            q = _queued_for_rack(work_all[:, r], s_all[:, r])
            if n_rows:
                queued_rows[:, r] = q[-n_rows:]
        assigned = rows_all["assign"] if n_rows else np.zeros((0, n))
        return assigned, queued_rows, n_rows - t_len, drained

    # -------------------------------------------------------------------
    def per_rack_telemetry(self) -> List[Telemetry]:
        ts = np.asarray(self._t_hist, float)
        work = self._full("work")
        s_rows = self._full("S")
        cap = self._full("cap")
        perf = self._full("perf")
        rate = self._full("rate")
        active = self._full("active")
        power = self._full("power")
        util = self._full("util")
        empty = np.zeros(0)
        th = self.arrays.thermal
        if th is not None and "temp" in self._hist:
            fan: Optional[np.ndarray] = np.concatenate(self._hist["fan"])
            temp: Optional[np.ndarray] = np.concatenate(self._hist["temp"])
            thr: Optional[np.ndarray] = np.concatenate(self._hist["thr"])
            col_of = {int(r): j for j, r in enumerate(th.t_idx)}
        else:
            fan = temp = thr = None
            col_of = {}
        arr = self.arrays
        out: List[Telemetry] = []
        for r in range(self.n_racks):
            responses = _responses_for_rack(
                ts,
                self.dt_s,
                work[:, r],
                s_rows[:, r],
                cap[:, r],
                perf[:, r],
                float(arr.unit_rate[r]),
            )
            p50, p99 = latency_percentiles(responses)
            j = col_of.get(r)
            if j is None or temp is None or thr is None or fan is None:
                temp_r = thr_r = fan_r = empty
            else:
                temp_r = temp[:, j].copy()
                thr_r = thr[:, j].astype(float)
                fan_r = fan[:, j].copy()
            out.append(
                Telemetry(
                    time_s=ts,
                    offered_load=rate[:, r].copy(),
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
                    responses=responses,
                    workload={
                        "name": arr.names[r],
                        "kind": "fluid",
                        "unit_rate": float(arr.unit_rate[r]),
                    },
                    max_temp_c=temp_r,
                    throttled_units=thr_r,
                    fan_power_w=fan_r,
                )
            )
        return out


# ---------------------------------------------------------------------------
# batched config sweeps


@dataclass
class SweepConfig:
    """One point of a batched fig15-style policy sweep.

    Scalars multiply the corresponding per-rack base arrays (so a
    heterogeneous fleet keeps its shape); ``hedge_after_s`` of ``None``
    keeps each rack's own policy deadline, ``float("inf")`` disables
    hedging for the config, any finite value overrides every rack. The
    power-aware router runs at its default ``util_target`` (0.85).
    """

    router: str = "join-shortest-queue"
    headroom_scale: float = 1.0
    sched_headroom_scale: float = 1.0
    hedge_after_s: Optional[float] = None
    unit_rate_scale: float = 1.0
    trace_scale: float = 1.0
    name: str = ""


def sweep(
    racks: "Sequence[RackConfig]",
    configs: Sequence[SweepConfig],
    trace_rps: Sequence[float],
    dt_s: float = 60.0,
    idle_units_off: bool = True,
    drain_ticks: Optional[int] = None,
    device: str = "cuda",
    graph: bool = True,
) -> List[Dict[str, Any]]:
    """Run every config over the trace as **one** batched step.

    All configs advance together on the config axis, a block of
    :data:`_BLOCK` ticks at a time (a CUDA graph replayed on the card
    unless ``graph=False``; eager on the CPU). Every config runs the full
    trace plus ``drain_ticks`` idle ticks (default ``len(trace) + 100``);
    per-config results are trimmed at each config's own drain point, so
    summaries match a per-config ``Fleet(backend="torch").play_trace``
    within the engines' tolerance (a config that fails to drain inside
    the window reports ``drained=False``). The summaries are reduced on
    the device; only a dozen scalars a config reach the host.

    Returns one summary dict per config (same keys across configs).
    """
    dev = resolve_device(device)
    trace = np.asarray(trace_rps, float)
    assert len(configs) > 0, "need at least one sweep config"
    assert len(trace) > 0, "need a non-empty trace"
    return _sweep(racks, list(configs), trace, dt_s, idle_units_off,
                  drain_ticks, dev, graph)


def _sweep(
    racks: "Sequence[RackConfig]",
    configs: List[SweepConfig],
    trace: np.ndarray,
    dt_s: float,
    idle_units_off: bool,
    drain_ticks: Optional[int],
    device: torch.device,
    graph: bool,
) -> List[Dict[str, Any]]:
    arr = build_fleet_arrays(racks, idle_units_off)
    if arr.generic:
        raise ValueError(
            "sweep() only supports the built-in governors; use the "
            "vector engine for generic governors"
        )
    for cfg in configs:
        if cfg.router not in ROUTER_KINDS:
            raise ValueError(
                f"unknown sweep router {cfg.router!r}; "
                f"choose from {sorted(ROUTER_KINDS)}"
            )
    n = arr.n_racks
    t_len = len(trace)
    n_drain = t_len + 100 if drain_ticks is None else int(drain_ticks)
    total_ticks = t_len + n_drain
    n_cfg = len(configs)
    base = _base_params(arr, dt_s, _full_load_j_per_req(racks))
    base_dl = np.asarray(base["hedge_deadline"], float)
    hedge_dls = np.stack(
        [
            base_dl
            if cfg.hedge_after_s is None
            else np.full(n, float(cfg.hedge_after_s))
            for cfg in configs
        ]
    )
    hedge_on = bool(np.isfinite(hedge_dls).any())
    dims = _make_dims(arr, dt_s, hedge_on)
    params = dict(base)
    params["router_kind"] = np.array(
        [ROUTER_KINDS[cfg.router] for cfg in configs], np.int64
    )
    params["trace_scale"] = np.array(
        [float(cfg.trace_scale) for cfg in configs]
    )
    params["unit_rate"] = np.stack(
        [arr.unit_rate * cfg.unit_rate_scale for cfg in configs]
    )
    params["capacity_rps"] = np.stack(
        [
            arr.n_units.astype(float) * arr.unit_rate * cfg.unit_rate_scale
            for cfg in configs
        ]
    )
    params["headroom"] = np.stack(
        [arr.headroom * cfg.headroom_scale for cfg in configs]
    )
    params["sched_headroom"] = np.stack(
        [arr.sched_headroom * cfg.sched_headroom_scale for cfg in configs]
    )
    params["hedge_deadline"] = hedge_dls
    dparams = _device_params(params, arr, device)
    carry = _device_carry(_fresh_carry(arr, hedge_on, t_len), n_cfg, device)
    run = _Runner(dparams, dims, carry, device, graph)
    hist = {
        k: torch.empty((-(-total_ticks // _BLOCK) * _BLOCK,) + v.shape[1:],
                       dtype=v.dtype, device=device)
        for k, v in run.ys.items()
    }
    for b0 in range(0, total_ticks, _BLOCK):
        ticks = np.arange(b0, b0 + _BLOCK)
        rps = np.zeros(_BLOCK)
        in_trace = ticks < t_len
        rps[in_trace] = trace[ticks[in_trace]]
        ys = run.run_block(rps, ticks < total_ticks, in_trace)
        for k, v in ys.items():
            hist[k][b0 : b0 + _BLOCK].copy_(v)
    summary = _device_summary(
        {k: v[:total_ticks] for k, v in hist.items()}, t_len,
        float(dt_s), dparams["unit_rate"])
    part = {k: _numpy(v) for k, v in summary.items()}
    return [_format_row(cfg, ci, arr, part, ci)
            for ci, cfg in enumerate(configs)]


def _pctl(flat: torch.Tensor, n_ok: torch.Tensor, q: float) -> torch.Tensor:
    """``np.percentile(lat, q)`` (linear interpolation) of each config's
    row of ``flat`` (N, m), sorted and padded with ``+inf`` past
    ``n_ok`` (N,) valid entries."""
    pos = (q / 100.0) * torch.clamp_min(n_ok - 1, 0).to(_F64)
    lo = torch.floor(pos).to(_I64)
    hi = torch.ceil(pos).to(_I64)
    w = pos - lo.to(_F64)
    v = (flat.gather(1, lo[:, None])[:, 0] * (1.0 - w)
         + flat.gather(1, hi[:, None])[:, 0] * w)
    return torch.where(n_ok > 0, v, 0.0)


def _device_summary(
    ys: Dict[str, torch.Tensor],
    t_len: int,
    dt: float,
    unit_rate: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Reduce every config's emitted rows (ticks, N, racks) to summary
    scalars (N,) **on the device**: the per-config trim mask, roll-ups,
    and the latency reconstruction (the ``QueueWorkload``
    completion/finish arithmetic of :func:`_responses_for_rack`,
    vectorized over all submissions), so a sweep ships a dozen scalars a
    config to the host, not its ``(ticks, racks)`` histories."""
    total = ys["empty"].shape[0]
    dev = ys["empty"].device
    allm = ys["empty"].all(dim=2)  # (T, N)
    start_idle = torch.cat([torch.zeros_like(allm[:1]), allm[:-1]], dim=0)
    drain_idle = start_idle[t_len:]
    drained = drain_idle.any(dim=0)
    first = drain_idle.to(_I64).argmax(dim=0)
    n_kept = torch.where(drained, t_len + first + 1, total)
    tick = torch.arange(total, dtype=_I64, device=dev)
    tmask = tick[:, None] < n_kept[None, :]  # (T, N)
    col = tmask[:, :, None]
    nk = n_kept.to(_F64)
    power_t = torch.where(col, ys["power"], 0.0).sum(dim=2)  # (T, N)
    energy_j = power_t.sum(dim=0) * dt
    served = torch.where(col, ys["used"], 0.0).sum(dim=(0, 2))
    active_t = torch.where(col, ys["active"], 0).sum(dim=2)
    hedged = torch.where(col, ys["hedge"], 0).sum(dim=(0, 2))
    scale = torch.where(col, ys["scale"], 0).sum(dim=(0, 2))
    # latency reconstruction: one fluid request per work-carrying tick,
    # completion at the first tick whose cumulative served covers its
    # cumulative cost tail (minus the cumulative-axis forgiveness)
    work = torch.where(col, ys["work"], 0.0)
    a = torch.cumsum(work, dim=0)
    s_col = ys["S"]
    j = torch.searchsorted(
        s_col.permute(1, 2, 0).contiguous(),
        (a - _cum_tol(a)).permute(1, 2, 0).contiguous(),
    ).permute(2, 0, 1)
    ok = (work > 0.0) & (j < n_kept[None, :, None])
    jc = torch.clamp(j, 0, total - 1)
    cap_j = ys["cap"].gather(0, jc)
    perf_j = ys["perf"].gather(0, jc)
    s_prev = torch.where(
        jc > 0, s_col.gather(0, torch.clamp_min(jc - 1, 0)), 0.0)
    safe_cap = torch.where(cap_j > 0.0, cap_j, 1.0)
    frac = torch.where(
        cap_j > 0.0, torch.minimum(a - s_prev, cap_j) / safe_cap, 1.0)
    arrival = (tick.to(_F64) * dt + 0.5 * dt)[:, None, None]
    service = 1.0 / (unit_rate[None] * torch.clamp_min(perf_j, 1e-9))
    finish = torch.maximum(jc.to(_F64) * dt + frac * dt, arrival + service)
    lat = torch.where(ok, finish - arrival, float("inf"))
    flat = torch.sort(lat.permute(1, 0, 2).reshape(lat.shape[1], -1),
                      dim=1).values
    n_ok = ok.sum(dim=(0, 2))
    return {
        "ticks": n_kept,
        "drained": drained,
        "served": served,
        "energy_j": energy_j,
        "mean_power_w": power_t.sum(dim=0) / nk,
        "peak_power_w": torch.where(
            tmask, power_t, float("-inf")).amax(dim=0),
        "mean_active_units": active_t.sum(dim=0).to(_F64) / nk,
        "hedged": hedged,
        "scale_events": scale,
        "p50_latency_s": _pctl(flat, n_ok, 50.0),
        "p95_latency_s": _pctl(flat, n_ok, 95.0),
        "p99_latency_s": _pctl(flat, n_ok, 99.0),
    }


def _format_row(
    cfg: SweepConfig,
    ci: int,
    arr: FleetArrays,
    part: Dict[str, np.ndarray],
    k: int,
) -> Dict[str, Any]:
    energy_j = float(part["energy_j"][k])
    served = float(part["served"][k])
    return {
        "name": cfg.name or f"cfg{ci}",
        "router": cfg.router,
        "racks": arr.n_racks,
        "ticks": int(part["ticks"][k]),
        "served": served,
        "energy_j": energy_j,
        "energy_kwh": energy_j / 3.6e6,
        "tpe": served / max(energy_j, 1e-9),
        "mean_power_w": float(part["mean_power_w"][k]),
        "peak_power_w": float(part["peak_power_w"][k]),
        "mean_active_units": float(part["mean_active_units"][k]),
        "p50_latency_s": float(part["p50_latency_s"][k]),
        "p95_latency_s": float(part["p95_latency_s"][k]),
        "p99_latency_s": float(part["p99_latency_s"][k]),
        "hedged": int(part["hedged"][k]),
        "scale_events": int(part["scale_events"][k]),
        "drained": bool(part["drained"][k]),
    }
