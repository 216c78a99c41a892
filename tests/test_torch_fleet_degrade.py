"""The degrade overlay on the port's fleet engine, on the CPU:
``Fleet(backend="torch", device="cpu", degrade=..., chaos=...)`` held to
the port's vector engine (the oracle) over the cases of
``tests/test_degrade.py``: every mechanism at once (tiered admission,
deadline expiry, breakers, seeded retries) through a rack kill, seeded
random policies, the breaker's full cycle under each router, expiry
alone, a drain that ends only when the retry ring is empty, a continued
``play_trace``, and bitwise repeats.

Integer series and counts (breaker states and opens, expired and
per-rack response counts, ticks) must match exactly, the degrade costs
within fig16's ``JAX_RTOL`` of 1e-9 as ``tests/test_degrade.py`` holds
the JAX engine. ``tests/test_torch_fleet_jax.py`` holds the same engine
to the JAX engine's degrade run.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cluster import soc_cluster
from repro_torch.distributed.fault import RetryPolicy
from repro_torch.fleet import (BreakerConfig, ChaosSchedule, DegradePolicy,
                               Fleet, JoinShortestQueueRouter,
                               PowerAwareRouter, RoundRobinRouter, TierSpec,
                               diurnal_trace, homogeneous_fleet,
                               tier_latency_percentiles)
from repro_torch.fleet.degrade import BRK_CLOSED, BRK_HALF, BRK_OPEN
from repro_torch.power import SchedutilGovernor, ThermalParams, sd865_opp_table
from repro_torch.runtime import ScalePolicy

UNIT_RATE = 30.0
DT_S = 60.0
HOUR = 3600.0
N_RACKS = 4
FLEET_CAP = N_RACKS * 60 * UNIT_RATE

#: tests/test_degrade.py's JAX aggregate tolerance (fig16's JAX_RTOL)
JAX_RTOL = 1e-9
ATOL = 1e-9
#: tests/test_jax_parity.py's RTOL for served and energy
RTOL_EXACT_SUMS = 1e-12


def _racks(n=N_RACKS):
    return homogeneous_fleet(soc_cluster(), n, UNIT_RATE,
                             policy=ScalePolicy(cooldown_s=300.0,
                                                min_units=1))


def _saturating_trace(ticks=120, seed=7):
    """~30 % of capacity with a 30-tick flash crowd at ~1.8x capacity
    (tests/test_degrade.py::_saturating_trace)."""
    rng = np.random.default_rng(seed)
    t = np.arange(ticks)
    rps = 2200.0 * (1.0 + 0.2 * np.sin(t / 8.0)) + rng.normal(0, 40.0, ticks)
    rps = np.clip(rps, 0.0, None)
    rps[40:70] *= 6.0
    return rps


def _full_policy():
    return DegradePolicy(
        tiers=(TierSpec("gold", 0.2, 900.0),
               TierSpec("silver", 0.3, 420.0),
               TierSpec("bulk", 0.5, 180.0)),
        queue_deadline_s=900.0,
        breaker=BreakerConfig(open_after_s=300.0, close_below_s=120.0,
                              cooldown_s=600.0, probe_fraction=0.25,
                              fail_timeout_s=120.0),
        retry=RetryPolicy(max_attempts=3, backoff_s=120.0, jitter=0.5),
        seed=11)


def _kill_schedule():
    return ChaosSchedule().kill_rack(1, 10 * DT_S, 25 * DT_S)


def _fleet(backend, *, degrade, chaos=None, router=None):
    extra = {"device": "cpu"} if backend == "torch" else {}
    return Fleet(_racks(), router=router or JoinShortestQueueRouter(),
                 dt_s=DT_S, backend=backend, chaos=chaos, degrade=degrade,
                 sanitize=True, **extra)


def _both(trace, make_policy, make_chaos=None, **kw):
    return tuple(
        _fleet(b, degrade=make_policy(),
               chaos=make_chaos() if make_chaos else None, **kw
               ).play_trace(trace)
        for b in ("vector", "torch"))


def _random_policy(rng):
    """tests/test_degrade.py::_random_policy: any mechanism may be off."""
    n_tiers = int(rng.integers(1, 4))
    shares = rng.dirichlet(np.ones(n_tiers) * 2.0)
    shares = np.round(shares, 6)
    shares[-1] = 1.0 - float(shares[:-1].sum())
    budgets = np.sort(rng.uniform(120.0, 1200.0, n_tiers))[::-1]
    tiers = tuple(
        TierSpec(f"t{k}", float(shares[k]), float(budgets[k]))
        for k in range(n_tiers)) if rng.random() < 0.85 else ()
    breaker = None
    if rng.random() < 0.7:
        open_after = float(rng.uniform(240.0, 900.0))
        breaker = BreakerConfig(
            open_after_s=open_after,
            close_below_s=float(rng.uniform(30.0, open_after - 60.0)),
            cooldown_s=float(rng.uniform(300.0, 1200.0)),
            probe_fraction=float(rng.uniform(0.05, 0.5)),
            use_chaos_signal=bool(rng.random() < 0.5),
            fail_timeout_s=float(rng.uniform(60.0, 300.0)))
    return DegradePolicy(
        tiers=tiers,
        queue_deadline_s=(float(rng.uniform(300.0, 1200.0))
                          if rng.random() < 0.7 else None),
        breaker=breaker,
        retry=RetryPolicy(max_attempts=int(rng.integers(1, 5)),
                          backoff_s=float(rng.uniform(60.0, 240.0)),
                          jitter=float(rng.uniform(0.0, 1.0))),
        seed=int(rng.integers(1, 2**31)))


def assert_degrade_parity(tv, tt):
    """tv = vector oracle, tt = the torch run of the same scenario."""
    assert tv.ticks == tt.ticks and tv.drained == tt.drained
    assert np.array_equal(tv.active_units, tt.active_units)
    assert np.array_equal(tv.queued, tt.queued)
    assert tv.breaker_opens == tt.breaker_opens
    assert np.array_equal(tv.breaker_state_t, tt.breaker_state_t)
    assert tv.breaker_events == tt.breaker_events
    assert tv.expired_requests == tt.expired_requests
    assert tv.respilled_requests == tt.respilled_requests
    assert tv.dropped_requests == tt.dropped_requests
    assert [len(r.responses) for r in tv.per_rack] == \
        [len(r.responses) for r in tt.per_rack]
    np.testing.assert_allclose(tt.served, tv.served, rtol=RTOL_EXACT_SUMS)
    np.testing.assert_allclose(tt.energy_j, tv.energy_j,
                               rtol=RTOL_EXACT_SUMS)
    np.testing.assert_allclose(tt.power_w, tv.power_w, rtol=1e-9, atol=ATOL)
    for k in ("shed_cost", "expired_cost", "retried_cost",
              "retry_dropped_cost", "respilled_cost", "dropped_cost",
              "p50_latency_s", "p95_latency_s", "p99_latency_s"):
        np.testing.assert_allclose(getattr(tt, k), getattr(tv, k),
                                   rtol=JAX_RTOL, atol=ATOL, err_msg=k)
    assert tv.shed_by_tier.keys() == tt.shed_by_tier.keys()
    for name, v in tv.shed_by_tier.items():
        np.testing.assert_allclose(tt.shed_by_tier[name], v, rtol=JAX_RTOL,
                                   atol=ATOL, err_msg=name)
    for k in ("shed_cost_t", "offered_rps", "assigned_rps"):
        a, b = getattr(tv, k), getattr(tt, k)
        assert np.shape(a) == np.shape(b), k
        np.testing.assert_allclose(b, a, rtol=JAX_RTOL, atol=ATOL,
                                   err_msg=k)
    rv, rt = tv.recovery, tt.recovery
    assert (rv is None) == (rt is None)
    if rv is not None:
        assert rv.reconvergence_ticks == rt.reconvergence_ticks
        np.testing.assert_allclose(rt.p99_blowup, rv.p99_blowup,
                                   rtol=JAX_RTOL)


def _injected_balance(tel, trace):
    injected = float(np.sum(trace)) * DT_S
    balance = (tel.served + tel.dropped_cost + tel.expired_cost
               + tel.retry_dropped_cost)
    return balance, injected


# ---------------------------------------------------------------------------
# every mechanism at once, through a rack kill
# ---------------------------------------------------------------------------
def test_all_mechanisms_match_vector():
    trace = _saturating_trace()
    tv, tt = _both(trace, _full_policy, _kill_schedule)
    # all four mechanisms fired (vacuity guard)
    assert tt.shed_cost > 0.0 and tt.expired_cost > 0.0
    assert tt.retried_cost > 0.0 and tt.retry_dropped_cost > 0.0
    assert tt.breaker_opens > 0
    assert_degrade_parity(tv, tt)
    for tier in ("gold", "silver", "bulk"):
        pv = tier_latency_percentiles(tv, tier)
        pt = tier_latency_percentiles(tt, tier)
        assert pv[99.0] > 0.0
        for q in pv:
            np.testing.assert_allclose(pt[q], pv[q], rtol=JAX_RTOL,
                                       err_msg=f"{tier} p{q}")
    # an open breaker's rack gets nothing from the router
    open_ = tt.breaker_state_t == BRK_OPEN
    assert open_.any() and np.all(tt.assigned_rps[open_] == 0.0)
    balance, injected = _injected_balance(tt, trace)
    assert balance == pytest.approx(injected, rel=1e-6)


@pytest.mark.parametrize("case", range(4))
def test_random_policies_match_vector(case):
    """A seeded random plan and chaos schedule (any mechanism may be
    off), as tests/test_degrade.py's lockstep test draws them."""
    rng = np.random.default_rng(20260808 * 100 + case)
    policy = _random_policy(rng)
    horizon = 100 * DT_S
    sched = ChaosSchedule.random(N_RACKS, horizon,
                                 seed=int(rng.integers(2**31)), n_events=3)
    peak = float(rng.uniform(0.5, 1.4)) * FLEET_CAP
    trace = diurnal_trace(peak_rps=peak, hours=horizon / HOUR, dt_s=DT_S)
    tv, tt = _both(trace, lambda: policy, lambda: sched)
    assert_degrade_parity(tv, tt)
    if tt.drained:
        balance, injected = _injected_balance(tt, trace)
        assert balance == pytest.approx(injected, rel=1e-6)


# ---------------------------------------------------------------------------
# single mechanisms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "router", [RoundRobinRouter, JoinShortestQueueRouter, PowerAwareRouter])
def test_breaker_full_cycle_matches_vector(router):
    """A kill trips rack 1's breaker through the chaos failure signal; it
    half-opens after the cooldown and closes (CLOSED, OPEN, HALF, CLOSED),
    and no router sends an open rack anything."""
    def policy():
        return DegradePolicy(
            tiers=(), queue_deadline_s=None,
            breaker=BreakerConfig(open_after_s=1e5, close_below_s=120.0,
                                  cooldown_s=300.0, probe_fraction=0.25,
                                  use_chaos_signal=True,
                                  fail_timeout_s=120.0),
            retry=RetryPolicy(max_attempts=1, backoff_s=60.0))
    trace = np.full(80, 0.4 * FLEET_CAP)
    tv, tt = _both(trace, policy, _kill_schedule, router=router())
    states = tt.breaker_state_t[1]
    assert BRK_OPEN in states and BRK_HALF in states
    assert states[-1] == BRK_CLOSED
    assert np.all(tt.breaker_state_t[0] == BRK_CLOSED)
    assert np.all(tt.assigned_rps[tt.breaker_state_t == BRK_OPEN] == 0.0)
    assert_degrade_parity(tv, tt)


def test_deadline_expiry_alone_matches_vector():
    """No tiers, no breaker: only the lag ring's deadline expiry, which
    must void whole requests as the host queue's expire() pops them."""
    def policy():
        return DegradePolicy(tiers=(), queue_deadline_s=420.0)
    trace = _saturating_trace()
    tv, tt = _both(trace, policy)
    assert tt.expired_requests > 0 and tt.expired_cost > 0.0
    assert tt.shed_cost == 0.0
    assert_degrade_parity(tv, tt)
    np.testing.assert_allclose(tt.served + tt.expired_cost,
                               float(np.sum(trace)) * DT_S, rtol=1e-9)


def test_tier_latency_percentiles_without_chaos():
    tv, tt = _both(_saturating_trace(), _full_policy)
    assert_degrade_parity(tv, tt)
    for tier in ("gold", "bulk"):
        pv = tier_latency_percentiles(tv, tier)
        pt = tier_latency_percentiles(tt, tier)
        assert pv[99.0] > 0.0
        for q in pv:
            np.testing.assert_allclose(pt[q], pv[q], rtol=JAX_RTOL)


def test_drain_ends_only_when_the_retry_ring_is_empty():
    """Shed mass waits out a 10-tick backoff after the trace; the queues
    empty before it is released, so the drain must run on through idle
    ticks until the ring is empty and the released mass served."""
    def policy():
        return DegradePolicy(
            tiers=(TierSpec("gold", 0.5, 60.0), TierSpec("bulk", 0.5, 30.0)),
            retry=RetryPolicy(max_attempts=2, backoff_s=600.0, jitter=0.0))
    trace = np.concatenate([np.full(20, 0.3 * FLEET_CAP),
                            np.full(10, 1.6 * FLEET_CAP)])
    tv, tt = _both(trace, policy)
    assert tt.drained and tt.retried_cost > 0.0
    drain_q = tt.queued.sum(axis=0)[len(trace):]
    idle = np.nonzero(drain_q[:-1] == 0)[0]
    assert len(idle), "vacuous: the queues never emptied mid-drain"
    # released retries arrive after the idle tick, so the run went on
    assert tt.offered_rps[len(trace) + idle[0] + 1:].sum() > 0.0
    assert_degrade_parity(tv, tt)


def test_drain_ends_on_the_tick_that_expires_the_last_queue():
    """After the trace the last queued requests pass their deadline: the
    tick that expires them serves nothing and ends the drain, as the host
    loop's break does (the JAX engine's previous-tick rule runs one idle
    tick more here). The fluid expiry leaves a residue far below the
    cumulative axis's forgiveness, which must not count as served."""
    policy = ScalePolicy(cooldown_s=300.0, min_units=1,
                         freq_governor=SchedutilGovernor())
    trace = np.full(60, 0.6 * FLEET_CAP)
    tv, tt = (Fleet(homogeneous_fleet(soc_cluster(), N_RACKS, UNIT_RATE,
                                      policy=policy,
                                      opp_table=sd865_opp_table(),
                                      thermal=ThermalParams()),
                    dt_s=DT_S, backend=backend,
                    chaos=ChaosSchedule().kill_rack(1, 10 * DT_S, 30 * DT_S),
                    degrade=DegradePolicy(queue_deadline_s=600.0),
                    sanitize=True, **extra).play_trace(trace)
              for backend, extra in (("vector", {}),
                                     ("torch", {"device": "cpu"})))
    assert tt.queued[:, -2].sum() > 0 and tt.queued[:, -1].sum() == 0
    assert tt.expired_requests > 0
    assert_degrade_parity(tv, tt)


# ---------------------------------------------------------------------------
# continuing a run, repeats
# ---------------------------------------------------------------------------
def test_play_trace_twice_continues_like_the_vector_engine():
    """The second call picks up the breaker states, the retry ring, the
    lag ring and the tick counter where the first left them."""
    trace = _saturating_trace()
    out = {}
    for backend in ("vector", "torch"):
        fleet = _fleet(backend, degrade=_full_policy(),
                       chaos=_kill_schedule())
        fleet.play_trace(trace[:55], drain=False)
        out[backend] = fleet.play_trace(trace[55:])
    assert out["torch"].retried_cost > 0.0
    assert_degrade_parity(out["vector"], out["torch"])


def test_run_to_run_bitwise_under_degrade():
    ta, tb = (_fleet("torch", degrade=_full_policy(),
                     chaos=_kill_schedule()).play_trace(_saturating_trace())
              for _ in range(2))
    assert np.array_equal(ta.power_w, tb.power_w)
    assert np.array_equal(ta.queued, tb.queued)
    assert np.array_equal(ta.offered_rps, tb.offered_rps)
    assert np.array_equal(ta.shed_cost_t, tb.shed_cost_t)
    assert np.array_equal(ta.breaker_state_t, tb.breaker_state_t)
    assert ta.energy_j == tb.energy_j and ta.served == tb.served
    assert ta.retried_cost == tb.retried_cost
    assert ta.expired_cost == tb.expired_cost
    assert ta.p99_latency_s == tb.p99_latency_s


# ---------------------------------------------------------------------------
# on the card: the captured tick under degrade against the CPU's eager one
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_card_matches_cpu_under_degrade():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tels = [Fleet(_racks(), dt_s=DT_S, backend="torch", device=dev,
                  chaos=_kill_schedule(), degrade=_full_policy()
                  ).play_trace(_saturating_trace())
            for dev in ("cpu", "cuda", "cuda")]
    assert_degrade_parity(tels[0], tels[1])
    assert np.array_equal(tels[1].power_w, tels[2].power_w)
    assert np.array_equal(tels[1].shed_cost_t, tels[2].shed_cost_t)
    assert tels[1].energy_j == tels[2].energy_j
