"""The port's fleet engine (``Fleet(backend="torch")``, ``sweep``) on the
CPU, held to the port's own vector engine (the bitwise oracle) under the
JAX engine's tolerance contract, to itself run to run (bitwise), and a
sweep's rows to dedicated runs; plus its rejections, its refusal of the
chaos and degrade overlays, its refusal of a missing card, and its
64-bit carry. ``tests/test_torch_fleet_jax.py`` holds it to the JAX
engine itself.

The tests marked ``gpu`` hold the card's run (a CUDA graph replayed a
block at a time) to the CPU's and skip where there is no card; the file
imports no JAX, so they run on a machine without it:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_fleet.py
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core.cluster import edge_server_cpu, soc_cluster
from repro_torch.fleet import (ChaosSchedule, DegradePolicy, Fleet,
                               JoinShortestQueueRouter, PowerAwareRouter,
                               RackConfig, RoundRobinRouter, SweepConfig,
                               diurnal_trace, homogeneous_fleet, sweep)
from repro_torch.fleet import torch_engine as te
from repro_torch.obs import EnergyLedger, FleetObs, MemorySink, ProbeRegistry
from repro_torch.power import (FixedFreqGovernor, RaceToIdleGovernor,
                               SchedutilGovernor, ThermalAwareGovernor,
                               ThermalParams, sd865_opp_table)
from repro_torch.runtime import ScalePolicy

UNIT_RATE = 30.0   # req/s per SD865 unit (fig16 convention)
DT_S = 60.0
CPU = "cpu"

# The JAX engine's tolerance contract, copied as numbers from
# tests/test_jax_parity.py:42-51 (RTOL and ATOL there).
RTOL = {
    "served": 1e-12,
    "energy_j": 1e-12,
    "power_w": 1e-9,
    "queued": 1e-9,
    "p50_latency_s": 1e-9,
    "p95_latency_s": 1e-9,
    "p99_latency_s": 1e-9,
}
ATOL = 1e-9
# what Fleet._wire_obs promises a non-host engine's ledger replay
LEDGER_RTOL = 1e-9

ROUTERS = {"round-robin": RoundRobinRouter,
           "join-shortest-queue": JoinShortestQueueRouter,
           "power-aware": PowerAwareRouter}


def _racks(n=4, governor=None, thermal=None, headroom=1.25, hedge=None):
    policy = ScalePolicy(cooldown_s=300.0, min_units=1,
                         headroom=headroom, hedge_after_s=hedge,
                         freq_governor=governor)
    return homogeneous_fleet(
        soc_cluster(), n, UNIT_RATE, policy=policy,
        opp_table=sd865_opp_table() if governor is not None else None,
        thermal=thermal)


def _mixed_governor_racks():
    """Half race-to-idle, half pinned-frequency racks in one fleet."""
    table = sd865_opp_table()
    racks = []
    for i, gov in enumerate([RaceToIdleGovernor(), RaceToIdleGovernor(),
                             FixedFreqGovernor(), FixedFreqGovernor()]):
        policy = ScalePolicy(cooldown_s=300.0, min_units=1,
                             freq_governor=gov)
        racks.append(RackConfig(soc_cluster(), UNIT_RATE, policy,
                                name=f"mix/{i}", opp_table=table,
                                thermal=ThermalParams()))
    return racks


# tests/test_jax_parity.py's scenario matrix
SCENARIOS = {
    "binary": lambda: _racks(),
    "schedutil": lambda: _racks(governor=SchedutilGovernor(),
                                thermal=ThermalParams()),
    "race+fixed": _mixed_governor_racks,
    "thermal-clamp": lambda: _racks(
        governor=ThermalAwareGovernor(SchedutilGovernor()),
        thermal=ThermalParams(t_trip_c=70.0, t_release_c=60.0)),
    "hedging": lambda: _racks(headroom=0.8, hedge=120.0),
    # a trip point the dies reach at this load, so the latch drags dies
    # to the floor OPP (the clamp scenario above never trips)
    "thermal-trip": lambda: _racks(
        governor=ThermalAwareGovernor(SchedutilGovernor()),
        thermal=ThermalParams(t_trip_c=40.0, t_release_c=35.0)),
}
LOAD_FRAC = {"hedging": 0.95, "thermal-trip": 0.9}


def _trace(racks, name, hours=2, seed=3):
    cap = sum(rc.spec.n_units * rc.unit_rate for rc in racks)
    frac = LOAD_FRAC.get(name, 0.55)
    return frac * cap * diurnal_trace(peak_rps=1.0, hours=hours,
                                      dt_s=DT_S, seed=seed)


def _play(name, router, backend, **kw):
    racks = SCENARIOS[name]()
    extra = {"device": CPU} if backend == "torch" else {}
    fleet = Fleet(racks, router=ROUTERS[router](), dt_s=DT_S,
                  backend=backend, **extra, **kw)
    return fleet.play_trace(_trace(racks, name))


def assert_tolerance_parity(tv, tt):
    """tv = vector oracle, tt = torch run of the same scenario."""
    assert tv.ticks == tt.ticks
    assert tv.drained == tt.drained
    # integer-valued outputs: exact in any accumulation order
    assert np.array_equal(tv.active_units, tt.active_units)
    assert np.array_equal(tv.queued, tt.queued)
    assert [r.hedged for r in tv.per_rack] == \
        [r.hedged for r in tt.per_rack]
    assert [r.scale_events for r in tv.per_rack] == \
        [r.scale_events for r in tt.per_rack]
    np.testing.assert_allclose(tt.power_w, tv.power_w,
                               rtol=RTOL["power_w"], atol=ATOL)
    for field in ("served", "energy_j", "p50_latency_s",
                  "p95_latency_s", "p99_latency_s"):
        np.testing.assert_allclose(getattr(tt, field),
                                   getattr(tv, field),
                                   rtol=RTOL[field], atol=ATOL)
    for rv, rt in zip(tv.per_rack, tt.per_rack):
        np.testing.assert_array_equal(rt.throttled_units, rv.throttled_units)
        np.testing.assert_allclose(rt.max_temp_c, rv.max_temp_c,
                                   rtol=RTOL["power_w"], atol=ATOL)
        np.testing.assert_allclose(rt.fan_power_w, rv.fan_power_w,
                                   rtol=RTOL["power_w"], atol=ATOL)


# ---------------------------------------------------------------------------
# tolerance parity with the vector engine: every scenario, every router
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("router", sorted(ROUTERS))
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenario_parity_with_vector(scenario, router):
    assert_tolerance_parity(_play(scenario, router, "vector"),
                            _play(scenario, router, "torch"))


def test_hedging_fires_and_counts_match():
    """The parity must not be vacuous: the under-provisioned scenario
    has to fire hedges in both engines."""
    tv = _play("hedging", "join-shortest-queue", "vector")
    tt = _play("hedging", "join-shortest-queue", "torch")
    hedged = sum(r.hedged for r in tv.per_rack)
    assert hedged > 0
    assert hedged == sum(r.hedged for r in tt.per_rack)


def test_thermal_latch_engages():
    """The parity must not be vacuous here either: dies trip, and the
    torch engine's throttle history matches the vector engine's."""
    tv = _play("thermal-trip", "round-robin", "vector")
    tt = _play("thermal-trip", "round-robin", "torch")
    assert sum(float(r.throttled_units.sum()) for r in tv.per_rack) > 0
    assert_tolerance_parity(tv, tt)


def test_play_trace_continues_like_the_vector_engine():
    """A second play_trace continues the same simulation (clock, queues,
    energy, the hedge ring) on both engines."""
    out = {}
    for backend in ("vector", "torch"):
        racks = SCENARIOS["hedging"]()
        extra = {"device": CPU} if backend == "torch" else {}
        fleet = Fleet(racks, router=JoinShortestQueueRouter(), dt_s=DT_S,
                      backend=backend, **extra)
        trace = _trace(racks, "hedging", hours=1)
        fleet.play_trace(trace[:30], drain=False)
        out[backend] = fleet.play_trace(trace[30:])
    assert_tolerance_parity(out["vector"], out["torch"])


def test_no_drain_reports_undrained_like_the_vector_engine():
    out = {}
    for backend in ("vector", "torch"):
        racks = SCENARIOS["hedging"]()
        extra = {"device": CPU} if backend == "torch" else {}
        fleet = Fleet(racks, router=JoinShortestQueueRouter(), dt_s=DT_S,
                      backend=backend, **extra)
        out[backend] = fleet.play_trace(_trace(racks, "hedging"),
                                        drain=False)
    assert out["vector"].ticks == out["torch"].ticks
    assert out["vector"].drained == out["torch"].drained
    np.testing.assert_allclose(out["torch"].energy_j, out["vector"].energy_j,
                               rtol=RTOL["energy_j"])


# ---------------------------------------------------------------------------
# determinism: one program, same inputs -> bitwise-equal outputs
# ---------------------------------------------------------------------------
def test_engine_run_to_run_bitwise():
    ta = _play("schedutil", "join-shortest-queue", "torch")
    tb = _play("schedutil", "join-shortest-queue", "torch")
    assert np.array_equal(ta.power_w, tb.power_w)
    assert np.array_equal(ta.queued, tb.queued)
    assert ta.energy_j == tb.energy_j
    assert ta.p99_latency_s == tb.p99_latency_s
    for ra, rb in zip(ta.per_rack, tb.per_rack):
        assert np.array_equal(ra.max_temp_c, rb.max_temp_c)


def _sweep_once(drain_ticks=None):
    racks = _racks(n=3)
    trace = _trace(racks, "binary", hours=1, seed=5)
    configs = [
        SweepConfig(router="round-robin", name="rr"),
        SweepConfig(router="join-shortest-queue",
                    headroom_scale=1.1, name="jsq"),
        SweepConfig(router="power-aware", trace_scale=0.9, name="pa"),
        SweepConfig(router="join-shortest-queue",
                    hedge_after_s=120.0, name="jsq-hedge"),
    ]
    return sweep(racks, configs, trace, dt_s=DT_S,
                 drain_ticks=drain_ticks, device=CPU)


def test_sweep_run_to_run_bitwise():
    rows_a = _sweep_once()
    rows_b = _sweep_once()
    assert len(rows_a) == len(rows_b) == 4
    for ra, rb in zip(rows_a, rows_b):
        assert ra.keys() == rb.keys()
        for key in ra:
            assert ra[key] == rb[key], key


# ---------------------------------------------------------------------------
# sweep rows vs dedicated runs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["torch", "vector"])
def test_sweep_matches_dedicated_runs(backend):
    """Each sweep row matches a per-config run of its own fleet, given a
    drain budget large enough for every config; the configs differ in
    router, headroom and trace scale, so a row that read another
    config's knobs would not match."""
    racks = _racks(n=3, governor=SchedutilGovernor(),
                   thermal=ThermalParams())
    trace = _trace(racks, "binary", hours=1, seed=5)
    # schedutil's headroom is the policy's, so a dedicated fleet with a
    # scaled policy headroom scales both
    configs = [SweepConfig(router=r, headroom_scale=h,
                           sched_headroom_scale=h, trace_scale=s)
               for r, h, s in (("round-robin", 1.0, 1.0),
                               ("join-shortest-queue", 1.2, 0.8),
                               ("power-aware", 0.9, 1.1))]
    rows = sweep(racks, configs, trace, dt_s=DT_S, drain_ticks=600,
                 device=CPU)
    for row, cfg in zip(rows, configs):
        policy = ScalePolicy(cooldown_s=300.0, min_units=1,
                             headroom=1.25 * cfg.headroom_scale,
                             freq_governor=SchedutilGovernor())
        fleet_racks = homogeneous_fleet(
            soc_cluster(), 3, UNIT_RATE, policy=policy,
            opp_table=sd865_opp_table(), thermal=ThermalParams())
        extra = {"device": CPU} if backend == "torch" else {}
        tel = Fleet(fleet_racks, router=ROUTERS[cfg.router](), dt_s=DT_S,
                    backend=backend, **extra).play_trace(
                        cfg.trace_scale * trace)
        assert row["router"] == cfg.router
        assert row["ticks"] == tel.ticks
        assert row["drained"] == tel.drained
        assert row["hedged"] == sum(r.hedged for r in tel.per_rack)
        assert row["scale_events"] == sum(r.scale_events
                                          for r in tel.per_rack)
        np.testing.assert_allclose(row["served"], tel.served,
                                   rtol=1e-12, atol=ATOL)
        np.testing.assert_allclose(row["energy_j"], tel.energy_j,
                                   rtol=1e-12, atol=ATOL)
        for key in ("p50_latency_s", "p95_latency_s", "p99_latency_s"):
            np.testing.assert_allclose(row[key], getattr(tel, key),
                                       rtol=1e-9, atol=ATOL)


def test_sweep_row_does_not_depend_on_its_batch():
    """A config's row is the same whether it runs alone or beside
    others (the config axis is independent)."""
    racks = _racks(n=3)
    trace = _trace(racks, "binary", hours=1, seed=5)
    cfg = SweepConfig(router="power-aware", headroom_scale=1.1)
    alone = sweep(racks, [cfg], trace, dt_s=DT_S, device=CPU)[0]
    batch = sweep(racks, [SweepConfig(router="round-robin"), cfg,
                          SweepConfig(trace_scale=1.3)],
                  trace, dt_s=DT_S, device=CPU)[1]
    for key in alone:
        if key == "name":
            continue
        if isinstance(alone[key], float):
            np.testing.assert_allclose(batch[key], alone[key],
                                       rtol=1e-12, atol=ATOL)
        else:
            assert batch[key] == alone[key], key


# ---------------------------------------------------------------------------
# observability: the ledger, probes, no perturbation, the report CLI
# ---------------------------------------------------------------------------
def _fig16_racks(dvfs=False):
    policy = ScalePolicy(cooldown_s=300.0, min_units=1,
                         freq_governor=SchedutilGovernor() if dvfs else None,
                         hedge_after_s=4 * DT_S if dvfs else None)
    kwargs = dict(opp_table=sd865_opp_table(),
                  thermal=ThermalParams()) if dvfs else {}
    racks = homogeneous_fleet(soc_cluster(), 4, unit_rate=UNIT_RATE,
                              policy=policy, **kwargs)
    racks += homogeneous_fleet(edge_server_cpu(), 2, unit_rate=9.0)
    return racks


def _fig16_trace(hours=2.0):
    return 0.5 * 3e5 * 0.02 * diurnal_trace(peak_rps=1.0, hours=hours,
                                             dt_s=DT_S, seed=9)


def _fresh_obs():
    return FleetObs(probes=ProbeRegistry([MemorySink()]),
                    ledger=EnergyLedger())


@pytest.mark.parametrize("dvfs", [False, True])
def test_fleet_ledger_within_tolerance(dvfs):
    fleet = Fleet(_fig16_racks(dvfs), router=JoinShortestQueueRouter(),
                  dt_s=DT_S, backend="torch", device=CPU, obs=_fresh_obs())
    tel = fleet.play_trace(_fig16_trace())
    ledger = fleet.obs.ledger
    assert ledger.tolerance == LEDGER_RTOL  # set by Fleet._wire_obs
    racks = ledger.rack_energy_j()
    for name, rack_tel in zip(tel.rack_names, tel.per_rack):
        assert racks[name] == pytest.approx(rack_tel.energy_j,
                                            rel=LEDGER_RTOL), name
    assert ledger.total_energy_j() == pytest.approx(tel.energy_j,
                                                    rel=LEDGER_RTOL)
    assert ledger.n_ticks == tel.ticks


def test_probe_history_matches_vector():
    hists = {}
    for backend in ("vector", "torch"):
        obs = _fresh_obs()
        extra = {"device": CPU} if backend == "torch" else {}
        fleet = Fleet(_fig16_racks(dvfs=True),
                      router=JoinShortestQueueRouter(), dt_s=DT_S,
                      backend=backend, obs=obs, **extra)
        fleet.play_trace(_fig16_trace(hours=1.0))
        hists[backend] = obs.probes._sinks[0].history()
    for metric in ("active_units", "queued", "hedge_units", "waking_units",
                   "opp_index", "throttled_units"):
        assert np.array_equal(hists["vector"][metric],
                              hists["torch"][metric]), metric
    for metric in ("power_w", "utilization", "max_temp_c"):
        np.testing.assert_allclose(hists["torch"][metric],
                                   hists["vector"][metric],
                                   rtol=LEDGER_RTOL, atol=ATOL)


def test_obs_on_does_not_perturb_telemetry():
    trace = _fig16_trace(hours=1.0)
    plain = Fleet(_fig16_racks(dvfs=True), router=JoinShortestQueueRouter(),
                  dt_s=DT_S, backend="torch", device=CPU).play_trace(trace)
    obs = Fleet(_fig16_racks(dvfs=True), router=JoinShortestQueueRouter(),
                dt_s=DT_S, backend="torch", device=CPU,
                obs=_fresh_obs()).play_trace(trace)
    assert np.array_equal(plain.power_w, obs.power_w)
    assert np.array_equal(plain.active_units, obs.active_units)
    assert np.array_equal(plain.queued, obs.queued)
    assert plain.energy_j == obs.energy_j
    assert plain.served == obs.served


def test_sanitized_fleet_conserves_requests():
    tel = _play("hedging", "power-aware", "torch", sanitize=True)
    assert tel.drained and tel.served > 0


def test_report_cli_smoke(tmp_path):
    from repro_torch.obs.report import main
    rc = main(["--backend", "torch", "--device", CPU, "--soc", "2",
               "--cpu", "1", "--hours", "0.5", "--out-dir", str(tmp_path)])
    assert rc == 0
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["served"] > 0 and summary["drained"] == 1.0


# ---------------------------------------------------------------------------
# what the engine refuses
# ---------------------------------------------------------------------------
def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="'scalar', 'vector', or 'torch'"):
        Fleet(_racks(n=2), backend="jax")


def test_generic_governor_rejected():
    class WeirdGovernor:
        def select(self, ctx):
            return 0

    policy = ScalePolicy(freq_governor=WeirdGovernor())
    racks = homogeneous_fleet(soc_cluster(), 2, UNIT_RATE, policy=policy,
                              opp_table=sd865_opp_table())
    with pytest.raises(ValueError, match="generic governors"):
        Fleet(racks, backend="torch", device=CPU)
    with pytest.raises(ValueError, match="built-in governors"):
        sweep(racks, [SweepConfig()], [1.0], device=CPU)
    # the vector engine stays the escape hatch the error points at
    Fleet(racks, backend="vector")


def test_custom_router_rejected():
    class MyRouter:
        name = "my-router"

        def route(self, total_rps, view):
            return np.full(view.n_racks, total_rps / view.n_racks)

    with pytest.raises(ValueError, match="custom routers"):
        Fleet(_racks(n=2), router=MyRouter(), backend="torch", device=CPU)


def test_unknown_sweep_router_rejected():
    racks = _racks(n=2)
    trace = _trace(racks, "binary", hours=1)
    with pytest.raises(ValueError, match="unknown sweep router"):
        sweep(racks, [SweepConfig(router="least-loaded")], trace,
              device=CPU)


@pytest.mark.parametrize("overlay", ["chaos", "degrade"])
def test_overlays_are_refused(overlay):
    racks = _racks(n=2)
    kw = ({"chaos": ChaosSchedule().kill_rack(0, start_s=120.0)}
          if overlay == "chaos" else {"degrade": DegradePolicy()})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Fleet(racks, backend="torch", device=CPU, **kw)
    Fleet(_racks(n=2), backend="vector", **kw)  # the escape hatch


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    racks = _racks(n=2)
    with pytest.raises(RuntimeError, match="cuda"):
        Fleet(racks, backend="torch")
    with pytest.raises(RuntimeError, match="cuda"):
        sweep(racks, [SweepConfig()], _trace(racks, "binary", hours=1))


# ---------------------------------------------------------------------------
# 64-bit everywhere, by explicit dtype
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scenario", ["schedutil", "hedging"])
def test_carry_and_params_are_64_bit(scenario):
    racks = SCENARIOS[scenario]()
    eng = Fleet(racks, dt_s=DT_S, backend="torch", device=CPU).engine
    arr = eng.arrays
    hedge = arr.any_hedge
    carry = te._device_carry(te._fresh_carry(arr, hedge, 4), 1,
                             torch.device(CPU))
    dims = te._make_dims(arr, DT_S, hedge, emit_obs=True)
    run = te._Runner(eng._params, dims, carry, torch.device(CPU))
    allowed = (torch.float64, torch.int64, torch.bool)
    for name, group in (("carry", run.carry), ("rows", run.ys),
                        ("params", eng._params)):
        for key, v in group.items():
            if torch.is_tensor(v):
                assert v.dtype in allowed, (name, key, v.dtype)
            else:
                assert key in te._SCALARS and isinstance(v, float), key
    assert run.carry["B"].shape == (1, len(racks))
    assert run.carry["t"].shape == (1, 1)


# ---------------------------------------------------------------------------
# on the card: the captured tick against the CPU's eager one
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_card_engine_matches_cpu(cuda, scenario):
    racks = SCENARIOS[scenario]()
    trace = _trace(racks, scenario)
    tels = [Fleet(SCENARIOS[scenario](), router=PowerAwareRouter(),
                  dt_s=DT_S, backend="torch", device=dev).play_trace(trace)
            for dev in (CPU, cuda, cuda)]
    assert_tolerance_parity(tels[0], tels[1])
    assert np.array_equal(tels[1].power_w, tels[2].power_w)
    assert tels[1].energy_j == tels[2].energy_j


@pytest.mark.gpu
def test_card_sweep_graph_equals_eager_and_cpu(cuda):
    racks = _racks(n=3)
    trace = _trace(racks, "binary", hours=1, seed=5)
    configs = [SweepConfig(router=r, hedge_after_s=120.0)
               for r in sorted(ROUTERS)]
    run = lambda **kw: sweep(racks, configs, trace, dt_s=DT_S, **kw)  # noqa: E731
    graph = run(device=cuda)
    assert run(device=cuda) == graph
    assert run(device=cuda, graph=False) == graph
    for got, want in zip(graph, run(device=CPU)):
        for key, v in want.items():
            if isinstance(v, float):
                np.testing.assert_allclose(got[key], v, rtol=1e-12,
                                           atol=ATOL)
            else:
                assert got[key] == v, key
