"""The chaos overlay on the port's fleet engine, on the CPU:
``Fleet(backend="torch", device="cpu", chaos=...)`` held to the port's
vector engine (the oracle) over the cases of ``tests/test_chaos.py``:
all four fault kinds with thermal and hedging, seeded random schedules,
voided-request counts under respill and drop, routers that give a dead
rack nothing, unit caps, a continued ``play_trace``, and bitwise repeats.

Integer series and counts must match exactly, the rest within the JAX
engine's tolerances (``tests/test_jax_parity.py``'s ``RTOL``/``ATOL``,
as ``tests/test_chaos.py`` copies them). ``tests/test_torch_fleet_jax.py``
holds the same engine to the JAX engine's chaos runs.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cluster import edge_server_cpu, soc_cluster
from repro_torch.fleet import (ChaosSchedule, Fleet, JoinShortestQueueRouter,
                               PowerAwareRouter, RoundRobinRouter,
                               diurnal_trace, flash_crowd_trace,
                               homogeneous_fleet)
from repro_torch.fleet.chaos import recovery_window_p99
from repro_torch.power import SchedutilGovernor, ThermalParams, sd865_opp_table
from repro_torch.runtime import ScalePolicy

UNIT_RATE = 30.0
DT_S = 60.0
HOUR = 3600.0
FLEET_CAP = 4 * 60 * UNIT_RATE

# tests/test_chaos.py:40-42 (the contract of tests/test_jax_parity.py)
RTOL = {"served": 1e-12, "energy": 1e-12, "power": 1e-9, "queued": 1e-9,
        "lat": 1e-9}
ATOL = 1e-9


def _racks(n=4, governor=True, thermal=None, hedge=None):
    policy = ScalePolicy(
        cooldown_s=300.0, min_units=1, headroom=1.25, hedge_after_s=hedge,
        freq_governor=SchedutilGovernor() if governor else None)
    return homogeneous_fleet(
        soc_cluster(), n, UNIT_RATE, policy=policy,
        opp_table=sd865_opp_table() if governor else None, thermal=thermal)


def _full_schedule(on_kill="respill"):
    """All four fault kinds: rack kill, partial kill, fan rail, power cap
    (tests/test_chaos.py::_full_schedule)."""
    sched = ChaosSchedule(on_kill=on_kill)
    sched.kill_rack(1, start_s=4 * HOUR, end_s=8 * HOUR)
    sched.kill_units(2, 20, start_s=5 * HOUR, end_s=9 * HOUR)
    sched.fail_fan(0, start_s=3 * HOUR, end_s=10 * HOUR)
    sched.power_cap(3, start_s=6 * HOUR, end_s=11 * HOUR)
    return sched


def _backlog_trace(ticks=80):
    """A flash crowd holding through the kill window, so the dead rack has
    a deep queue when the kill lands (tests/test_chaos.py)."""
    h = ticks * DT_S / HOUR
    return flash_crowd_trace(
        base_rps=0.35 * FLEET_CAP, spike_mult=4.0, hours=h, dt_s=DT_S,
        spike_start_h=0.25 * h, spike_ramp_h=0.05 * h, spike_hold_h=0.6 * h,
        seed=3)


def _backlog_schedule(on_kill):
    return ChaosSchedule(on_kill=on_kill).kill_rack(
        1, start_s=30 * DT_S, end_s=60 * DT_S)


def _fleet(backend, sched, *, dt_s=DT_S, router=None, **racks):
    extra = {"device": "cpu"} if backend == "torch" else {}
    return Fleet(_racks(**racks), router=router or JoinShortestQueueRouter(),
                 dt_s=dt_s, backend=backend, chaos=sched, sanitize=True,
                 **extra)


def _both(trace, make_sched, **kw):
    return tuple(_fleet(b, make_sched(), **kw).play_trace(trace)
                 for b in ("vector", "torch"))


def assert_chaos_parity(tv, tt):
    """tv = vector oracle, tt = the torch run of the same scenario."""
    assert tv.ticks == tt.ticks and tv.drained == tt.drained
    assert np.array_equal(tv.active_units, tt.active_units)
    assert np.array_equal(tv.queued, tt.queued)
    assert tv.respilled_requests == tt.respilled_requests
    assert tv.dropped_requests == tt.dropped_requests
    assert [r.hedged for r in tv.per_rack] == [r.hedged for r in tt.per_rack]
    assert [len(r.responses) for r in tv.per_rack] == \
        [len(r.responses) for r in tt.per_rack]
    np.testing.assert_allclose(tt.served, tv.served, rtol=RTOL["served"])
    np.testing.assert_allclose(tt.energy_j, tv.energy_j,
                               rtol=RTOL["energy"])
    np.testing.assert_allclose(tt.power_w, tv.power_w, rtol=RTOL["power"],
                               atol=ATOL)
    np.testing.assert_allclose(tt.assigned_rps, tv.assigned_rps, rtol=1e-9,
                               atol=ATOL)
    np.testing.assert_allclose(tt.offered_rps, tv.offered_rps, rtol=1e-9,
                               atol=ATOL)
    for k in ("p50_latency_s", "p95_latency_s", "p99_latency_s"):
        np.testing.assert_allclose(getattr(tt, k), getattr(tv, k),
                                   rtol=RTOL["lat"], atol=ATOL, err_msg=k)
    for k in ("respilled_cost", "dropped_cost"):
        np.testing.assert_allclose(getattr(tt, k), getattr(tv, k),
                                   rtol=1e-9, atol=ATOL, err_msg=k)
    for rv, rt in zip(tv.per_rack, tt.per_rack):
        np.testing.assert_array_equal(rt.throttled_units, rv.throttled_units)
        np.testing.assert_allclose(rt.max_temp_c, rv.max_temp_c,
                                   rtol=RTOL["power"], atol=ATOL)
        np.testing.assert_allclose(rt.fan_power_w, rv.fan_power_w,
                                   rtol=RTOL["power"], atol=ATOL)
    rv, rt = tv.recovery, tt.recovery
    assert (rv is None) == (rt is None)
    if rv is not None:
        assert rv.reconvergence_ticks == rt.reconvergence_ticks
        np.testing.assert_allclose(rt.p99_blowup, rv.p99_blowup, rtol=1e-9)


# ---------------------------------------------------------------------------
# every fault kind, with thermal and hedging
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("on_kill", ["respill", "drop"])
def test_full_schedule_matches_vector(on_kill):
    """test_chaos.py's JAX parity input: 4 schedutil + thermal racks with
    hedging at 240 s over a 24 h diurnal at 120 s ticks; the partial
    kill must cap rack 2's units."""
    dt = 120.0
    trace = diurnal_trace(peak_rps=0.7 * FLEET_CAP, hours=24, dt_s=dt)
    tv, tt = _both(trace, lambda: _full_schedule(on_kill), dt_s=dt,
                   thermal=ThermalParams(), hedge=240.0)
    assert_chaos_parity(tv, tt)
    assert tt.active_units[2, int(5 * HOUR / dt):int(9 * HOUR / dt)].max() \
        <= 60 - 20


def test_fan_failure_stops_a_spinning_fan():
    """At ThermalParams()'s setpoints the fans of _full_schedule's fleet
    never spin, so its fan failure changes nothing; with the fan curve
    at 27-35 C they run at full power, and the failed one must stop."""
    thermal = ThermalParams(fan_t_low_c=27.0, fan_t_high_c=35.0)
    sched = lambda: ChaosSchedule().fail_fan(  # noqa: E731
        0, start_s=20 * DT_S, end_s=60 * DT_S)
    tv, tt = _both(np.full(80, 0.7 * FLEET_CAP), sched, thermal=thermal)
    fan = tt.per_rack[0].fan_power_w
    assert np.all(fan[20:60] == 0.0)
    assert fan[10:20].min() > 0.0 and fan[60:80].max() > 0.0
    assert tt.per_rack[1].fan_power_w[20:60].min() > 0.0
    assert_chaos_parity(tv, tt)


@pytest.mark.parametrize("seed", [20260808, 7, 11, 2024])
def test_random_schedule_matches_vector(seed):
    horizon = 120 * DT_S
    trace = diurnal_trace(peak_rps=0.6 * FLEET_CAP, hours=horizon / HOUR,
                          dt_s=DT_S)
    on_kill = "respill" if seed % 2 == 0 else "drop"
    tv, tt = _both(trace, lambda: ChaosSchedule.random(
        4, horizon, seed=seed, n_events=4, on_kill=on_kill),
        thermal=ThermalParams())
    assert_chaos_parity(tv, tt)


# ---------------------------------------------------------------------------
# voided requests: a kill on a deep queue
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("on_kill", ["respill", "drop"])
def test_voided_request_counts_match_vector(on_kill):
    tv, tt = _both(_backlog_trace(), lambda: _backlog_schedule(on_kill))
    assert_chaos_parity(tv, tt)
    voided = (tt.respilled_requests if on_kill == "respill"
              else tt.dropped_requests)
    assert voided > 0, "vacuous: no backlog on the rack at kill time"
    cost = tt.respilled_cost if on_kill == "respill" else tt.dropped_cost
    assert cost > 0.0


def test_respill_reoffers_what_drop_discards():
    t_re = _fleet("torch", _backlog_schedule("respill")).play_trace(
        _backlog_trace())
    t_dr = _fleet("torch", _backlog_schedule("drop")).play_trace(
        _backlog_trace())
    extra = float(np.sum(t_re.offered_rps) - np.sum(t_dr.offered_rps))
    assert np.isclose(extra * DT_S, t_re.respilled_cost, rtol=1e-9)


# ---------------------------------------------------------------------------
# routers and unit caps under a fault
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "router", [RoundRobinRouter, JoinShortestQueueRouter, PowerAwareRouter])
def test_routers_assign_zero_to_dead_rack(router):
    sched = lambda: ChaosSchedule().kill_rack(  # noqa: E731
        1, start_s=20 * DT_S, end_s=50 * DT_S)
    trace = np.full(80, 0.5 * FLEET_CAP)
    tv, tt = _both(trace, sched, router=router(), governor=False)
    assert np.all(tt.assigned_rps[1, 20:50] == 0.0), router.name
    assert tt.assigned_rps[1, 50:80].sum() > 0.0, router.name
    assert_chaos_parity(tv, tt)


def test_partial_kill_caps_active_units():
    sched = lambda: ChaosSchedule().kill_units(  # noqa: E731
        2, 40, start_s=10 * DT_S, end_s=30 * DT_S)
    tv, tt = _both(np.full(50, 0.8 * FLEET_CAP), sched)
    assert np.all(tt.active_units[2, 10:30] <= 60 - 40)
    assert tt.active_units[2, 35:].max() > 60 - 40  # recovers
    assert_chaos_parity(tv, tt)


def test_engine_mirrors_the_masks_like_the_vector_engine():
    """The host mirrors Fleet.view and the sanitizer read: the masks at
    the final tick, the evacuated cost by rack, the failure monitor."""
    sched = lambda: ChaosSchedule().kill_rack(2, start_s=10 * DT_S)  # noqa
    fleets = [_fleet(b, sched()) for b in ("vector", "torch")]
    for f in fleets:
        f.play_trace(np.full(40, 0.4 * FLEET_CAP))
    ev, et = (f.engine for f in fleets)
    assert np.array_equal(ev.chaos_dead, et.chaos_dead)
    assert et.chaos_dead[2] == 60
    np.testing.assert_allclose(et.chaos_evac_by_rack, ev.chaos_evac_by_rack,
                               rtol=1e-9, atol=ATOL)
    assert 2 in fleets[1].chaos_monitor.failed_racks()
    assert np.array_equal(fleets[0].view().alive, fleets[1].view().alive)


@pytest.mark.parametrize("kill_tick,load", [(30, 600.0), (31, 900.0)])
def test_hedging_on_respill_routed_during_the_drain(kill_tick, load):
    """A kill after the trace respills a backlogged Xeon rack onto a
    hedging SoC rack during the drain: the host queue ages those
    requests like any other, so the hedges (and the ticks) match only
    if drain ticks are recorded in the hedge ring. (The JAX engine
    records trace ticks alone and hedges far less here.)"""
    def racks():
        soc = homogeneous_fleet(soc_cluster(), 1, UNIT_RATE,
                                policy=ScalePolicy(cooldown_s=300.0,
                                                   min_units=1,
                                                   headroom=0.8,
                                                   hedge_after_s=90.0))
        xeon = homogeneous_fleet(edge_server_cpu(), 1, 9.0,
                                 policy=ScalePolicy(cooldown_s=300.0,
                                                    min_units=1))
        return soc + xeon
    tv, tt = (Fleet(racks(), router=RoundRobinRouter(), dt_s=DT_S,
                    backend=backend, sanitize=True,
                    chaos=ChaosSchedule(on_kill="respill").kill_rack(
                        1, kill_tick * DT_S, (kill_tick + 5) * DT_S),
                    **extra).play_trace(np.full(30, load))
              for backend, extra in (("vector", {}),
                                     ("torch", {"device": "cpu"})))
    assert tt.respilled_requests > 0 and tt.ticks > 30
    assert tt.per_rack[0].hedged > 0
    assert_chaos_parity(tv, tt)


# ---------------------------------------------------------------------------
# continuing a run, repeats, the hedging delta
# ---------------------------------------------------------------------------
def test_play_trace_twice_continues_like_the_vector_engine():
    """A second play_trace continues the same simulation (clock, queues,
    the E carry, the hedge ring) through a kill that spans both calls."""
    trace = _backlog_trace()
    out = {}
    for backend in ("vector", "torch"):
        fleet = _fleet(backend, _backlog_schedule("respill"), hedge=180.0)
        fleet.play_trace(trace[:45], drain=False)
        out[backend] = fleet.play_trace(trace[45:])
    assert_chaos_parity(out["vector"], out["torch"])


def test_run_to_run_bitwise_under_chaos():
    dt = 120.0
    trace = diurnal_trace(peak_rps=0.7 * FLEET_CAP, hours=12, dt_s=dt)
    ta, tb = (_fleet("torch", _full_schedule(), dt_s=dt,
                     thermal=ThermalParams(), hedge=240.0).play_trace(trace)
              for _ in range(2))
    assert np.array_equal(ta.power_w, tb.power_w)
    assert np.array_equal(ta.queued, tb.queued)
    assert np.array_equal(ta.assigned_rps, tb.assigned_rps)
    assert ta.energy_j == tb.energy_j and ta.served == tb.served
    assert ta.p99_latency_s == tb.p99_latency_s
    for ra, rb in zip(ta.per_rack, tb.per_rack):
        assert np.array_equal(ra.max_temp_c, rb.max_temp_c)


def test_hedging_arms_match_vector():
    """Both arms of ``hedging_delta`` (the kill with and without hedging)
    on each engine: hedges fire, and the recovery-window p99 and the
    benefit agree. (``hedging_delta`` itself builds its fleets on the
    default device, the card, so on the CPU the arms are built here.)"""
    fault_t = _backlog_schedule("respill").fault_t
    arms = {b: [_fleet(b, _backlog_schedule("respill"),
                       hedge=hedge).play_trace(_backlog_trace())
                for hedge in (180.0, None)]
            for b in ("vector", "torch")}
    for tv, tt in zip(arms["vector"], arms["torch"]):
        assert_chaos_parity(tv, tt)
    assert sum(r.hedged for r in arms["torch"][0].per_rack) > 0
    p99 = {b: [recovery_window_p99(t, fault_t) for t in tels]
           for b, tels in arms.items()}
    np.testing.assert_allclose(p99["torch"], p99["vector"], rtol=1e-9)


# ---------------------------------------------------------------------------
# on the card: the captured tick under chaos against the CPU's eager one
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_card_matches_cpu_under_chaos():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = 120.0
    trace = diurnal_trace(peak_rps=0.7 * FLEET_CAP, hours=24, dt_s=dt)
    tels = [Fleet(_racks(thermal=ThermalParams(), hedge=240.0),
                  router=JoinShortestQueueRouter(), dt_s=dt,
                  backend="torch", chaos=_full_schedule(), device=dev
                  ).play_trace(trace)
            for dev in ("cpu", "cuda", "cuda")]
    assert_chaos_parity(tels[0], tels[1])
    assert np.array_equal(tels[1].power_w, tels[2].power_w)
    assert tels[1].energy_j == tels[2].energy_j
