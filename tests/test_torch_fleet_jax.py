"""The port's fleet engine held to the JAX engine itself, on the CPU.

``repro.fleet.jax_engine`` imports ``jax.experimental.enable_x64``, which
the installed jax (0.9) no longer has, so it does not import in this
process. A subprocess installs a one-line shim first
(``jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)``),
then runs the JAX engine over this file's cases, a 4-config sweep over
4 racks x 2 h, and the chaos and degrade overlays on the inputs of
``tests/test_chaos.py::test_jax_tolerance_parity_under_chaos``,
``::test_jax_voided_request_parity`` and
``tests/test_degrade.py::test_jax_degrade_parity``, all in one call, and
hands its series back as ``.npz``. The shim
never reaches the pytest process: installed here, it would leak into
every later test on the same worker and flip the JAX package's own
``[jax]`` tests from run to run. ``repro`` itself is not touched.

The same inputs then run through ``Fleet(backend="torch", device="cpu")``
and ``sweep(..., device="cpu")``: integer series must match exactly, the
rest within the JAX engine's tolerances (``tests/test_jax_parity.py``
``RTOL``/``ATOL``, copied as numbers in ``tests/test_torch_fleet.py``);
the overlay cases are held with those three tests' own assertions.
"""
import importlib
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

HERE = pathlib.Path(__file__).resolve()
SRC = HERE.parents[1] / "src"

UNIT_RATE = 30.0
DT_S = 60.0
# tests/test_jax_parity.py:42-51
RTOL = {"served": 1e-12, "energy_j": 1e-12, "power_w": 1e-9,
        "queued": 1e-9, "p50_latency_s": 1e-9, "p95_latency_s": 1e-9,
        "p99_latency_s": 1e-9}
ATOL = 1e-9
SWEEP_RTOL = {"served": 1e-12, "energy_j": 1e-12, "mean_power_w": 1e-12,
              "peak_power_w": 1e-9, "mean_active_units": 1e-12,
              "p50_latency_s": 1e-9, "p95_latency_s": 1e-9,
              "p99_latency_s": 1e-9}
SWEEP_EXACT = ("ticks", "drained", "hedged", "scale_events")

# (scenario, router): every scenario kind of tests/test_torch_fleet.py,
# each router at least once
CASES = [("binary", "round-robin"), ("binary", "power-aware"),
         ("schedutil", "join-shortest-queue"), ("race+fixed", "power-aware"),
         ("thermal-trip", "round-robin"), ("hedging", "join-shortest-queue")]
# (router, headroom_scale, trace_scale, hedge_after_s)
SWEEP = [("round-robin", 1.0, 1.0, None),
         ("join-shortest-queue", 1.1, 0.9, None),
         ("power-aware", 1.0, 1.2, None),
         ("join-shortest-queue", 0.64, 1.7, 120.0)]

HOUR = 3600.0
FLEET_CAP = 4 * 60 * UNIT_RATE
# tests/test_degrade.py:50 (fig16's JAX_RTOL)
JAX_RTOL = 1e-9
# the overlay cases: tests/test_chaos.py's JAX chaos parity input and its
# voided-request input under both kill policies, tests/test_degrade.py's
# JAX degrade parity input
OVERLAY_CASES = ("chaos", "voided-respill", "voided-drop", "degrade")
TIERS = ("gold", "silver", "bulk")

_SHIM = ("import jax, jax.experimental\n"
         "jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)\n")


def _modules(pkg):
    """The fleet, power, cluster and runtime modules of ``repro`` or
    ``repro_torch``, so one builder makes both packages' inputs."""
    return types.SimpleNamespace(**{
        name: importlib.import_module(f"{pkg}.{name}")
        for name in ("fleet", "power", "runtime")},
        cluster=importlib.import_module(f"{pkg}.core.cluster"),
        fault=importlib.import_module(f"{pkg}.distributed.fault"))


def _racks(m, name):
    pw = m.power
    gov, thermal, headroom, hedge = None, None, 1.25, None
    if name == "schedutil":
        gov, thermal = pw.SchedutilGovernor(), pw.ThermalParams()
    elif name == "thermal-trip":
        gov = pw.ThermalAwareGovernor(pw.SchedutilGovernor())
        thermal = pw.ThermalParams(t_trip_c=40.0, t_release_c=35.0)
    elif name == "hedging":
        headroom, hedge = 0.8, 120.0
    elif name == "race+fixed":
        return [m.fleet.RackConfig(
            m.cluster.soc_cluster(), UNIT_RATE,
            m.runtime.ScalePolicy(cooldown_s=300.0, min_units=1,
                                  freq_governor=g),
            name=f"mix/{i}", opp_table=pw.sd865_opp_table(),
            thermal=pw.ThermalParams())
            for i, g in enumerate([pw.RaceToIdleGovernor(),
                                   pw.RaceToIdleGovernor(),
                                   pw.FixedFreqGovernor(),
                                   pw.FixedFreqGovernor()])]
    policy = m.runtime.ScalePolicy(cooldown_s=300.0, min_units=1,
                                   headroom=headroom, hedge_after_s=hedge,
                                   freq_governor=gov)
    return m.fleet.homogeneous_fleet(
        m.cluster.soc_cluster(), 4, UNIT_RATE, policy=policy,
        opp_table=pw.sd865_opp_table() if gov is not None else None,
        thermal=thermal)


def _trace(m, racks, name):
    cap = sum(rc.spec.n_units * rc.unit_rate for rc in racks)
    frac = {"hedging": 0.95, "thermal-trip": 0.9}.get(name, 0.55)
    return frac * cap * m.fleet.diurnal_trace(peak_rps=1.0, hours=2,
                                              dt_s=DT_S, seed=3)


def _series(tel):
    """Every compared series of a FleetTelemetry, as arrays."""
    out = {k: np.asarray(getattr(tel, k)) for k in (
        "ticks", "drained", "active_units", "queued", "power_w", "served",
        "energy_j", "p50_latency_s", "p95_latency_s", "p99_latency_s")}
    out["hedged"] = np.array([r.hedged for r in tel.per_rack])
    out["scale_events"] = np.array([r.scale_events for r in tel.per_rack])
    for k in ("max_temp_c", "throttled_units", "fan_power_w"):
        out[k] = np.concatenate([getattr(r, k) for r in tel.per_rack])
    return out


def _run(pkg, backend, **kw):
    """Every case and the sweep on one package's engine:
    {"case/<scenario>/<router>/<series>": array, "sweep/<key>": array}."""
    m = _modules(pkg)
    out = {}
    for name, router in CASES:
        racks = _racks(m, name)
        fleet = m.fleet.Fleet(racks, router=m.fleet.ROUTERS[router](),
                              dt_s=DT_S, backend=backend, **kw)
        for k, v in _series(fleet.play_trace(_trace(m, racks, name))).items():
            out[f"case/{name}/{router}/{k}"] = v
    racks = _racks(m, "binary")
    configs = [m.fleet.SweepConfig(router=r, headroom_scale=h,
                                   trace_scale=s, hedge_after_s=dl)
               for r, h, s, dl in SWEEP]
    rows = m.fleet.sweep(racks, configs, _trace(m, racks, "binary"),
                         dt_s=DT_S, **kw)
    for k in (*SWEEP_EXACT, *SWEEP_RTOL):
        out[f"sweep/{k}"] = np.array([row[k] for row in rows])
    for case in OVERLAY_CASES:
        fleet, trace = _overlay_fleet(m, case, backend, **kw)
        for k, v in _overlay_series(m, fleet.play_trace(trace)).items():
            out[f"overlay/{case}/{k}"] = v
    return out


def _overlay_fleet(m, case, backend, **kw):
    """The fleet and trace of one overlay case, as the JAX package's own
    chaos and degrade tests build them."""
    pw, fl = m.power, m.fleet
    if case == "degrade":
        racks = fl.homogeneous_fleet(
            m.cluster.soc_cluster(), 4, UNIT_RATE,
            policy=m.runtime.ScalePolicy(cooldown_s=300.0, min_units=1))
        rng = np.random.default_rng(7)
        t = np.arange(120)
        trace = np.clip(2200.0 * (1.0 + 0.2 * np.sin(t / 8.0))
                        + rng.normal(0, 40.0, 120), 0.0, None)
        trace[40:70] *= 6.0
        policy = fl.DegradePolicy(
            tiers=tuple(fl.TierSpec(n, sh, b) for n, sh, b in (
                ("gold", 0.2, 900.0), ("silver", 0.3, 420.0),
                ("bulk", 0.5, 180.0))),
            queue_deadline_s=900.0,
            breaker=fl.BreakerConfig(open_after_s=300.0, close_below_s=120.0,
                                     cooldown_s=600.0, probe_fraction=0.25,
                                     fail_timeout_s=120.0),
            retry=m.fault.RetryPolicy(max_attempts=3, backoff_s=120.0,
                                      jitter=0.5),
            seed=11)
        sched = fl.ChaosSchedule().kill_rack(1, 10 * DT_S, 25 * DT_S)
        return fl.Fleet(racks, dt_s=DT_S, backend=backend, chaos=sched,
                        degrade=policy, sanitize=True, **kw), trace
    chaos = case == "chaos"
    policy = m.runtime.ScalePolicy(
        cooldown_s=300.0, min_units=1, headroom=1.25,
        hedge_after_s=240.0 if chaos else None,
        freq_governor=pw.SchedutilGovernor())
    racks = fl.homogeneous_fleet(
        m.cluster.soc_cluster(), 4, UNIT_RATE, policy=policy,
        opp_table=pw.sd865_opp_table(),
        thermal=pw.ThermalParams() if chaos else None)
    if chaos:
        dt = 120.0
        sched = fl.ChaosSchedule(on_kill="respill")
        sched.kill_rack(1, start_s=4 * HOUR, end_s=8 * HOUR)
        sched.kill_units(2, 20, start_s=5 * HOUR, end_s=9 * HOUR)
        sched.fail_fan(0, start_s=3 * HOUR, end_s=10 * HOUR)
        sched.power_cap(3, start_s=6 * HOUR, end_s=11 * HOUR)
        trace = fl.diurnal_trace(peak_rps=0.7 * FLEET_CAP, hours=24,
                                 dt_s=dt)
    else:
        dt, h = DT_S, 80 * DT_S / HOUR
        sched = fl.ChaosSchedule(on_kill=case.split("-")[1]).kill_rack(
            1, start_s=30 * dt, end_s=60 * dt)
        trace = fl.flash_crowd_trace(
            base_rps=0.35 * FLEET_CAP, spike_mult=4.0, hours=h, dt_s=dt,
            spike_start_h=0.25 * h, spike_ramp_h=0.05 * h,
            spike_hold_h=0.6 * h, seed=3)
    return fl.Fleet(racks, router=fl.JoinShortestQueueRouter(), dt_s=dt,
                    backend=backend, chaos=sched, sanitize=True, **kw), trace


def _overlay_series(m, tel):
    """Every series the overlay tests compare, as arrays."""
    out = {k: np.asarray(getattr(tel, k)) for k in (
        "ticks", "drained", "served", "energy_j", "power_w", "queued",
        "active_units", "assigned_rps", "offered_rps", "p50_latency_s",
        "p99_latency_s", "respilled_requests", "dropped_requests",
        "respilled_cost", "dropped_cost", "shed_cost", "expired_cost",
        "retried_cost", "retry_dropped_cost", "breaker_opens",
        "breaker_state_t", "shed_cost_t")}
    rec = tel.recovery
    out["reconvergence_ticks"] = np.array(
        -1 if rec is None or rec.reconvergence_ticks is None
        else rec.reconvergence_ticks)
    out["p99_blowup"] = np.array(np.nan if rec is None else rec.p99_blowup)
    out["responses"] = np.array([len(r.responses) for r in tel.per_rack])
    if tel.degrade_on:
        for tier in TIERS:
            pct = m.fleet.tier_latency_percentiles(tel, tier)
            out[f"tier_{tier}"] = np.array([pct[50.0], pct[99.0]])
    return out


def write_reference(path):
    """Run in the shimmed subprocess: the JAX engine's series."""
    np.savez(path, **_run("repro", "jax"))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_fleet") / "ref.npz"
    code = _SHIM + (
        "import importlib.util\n"
        f"spec = importlib.util.spec_from_file_location('cases', {str(HERE)!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        f"mod.write_reference({str(out)!r})\n")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # one host device: the sweep's vmap path
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(out) as ref:
        return dict(ref)


@pytest.fixture(scope="module")
def torch_run():
    return _run("repro_torch", "torch", device="cpu")


def _close(got, want, rtol, what):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("name,router", CASES,
                         ids=[f"{n}-{r}" for n, r in CASES])
def test_engine_matches_jax(jax_ref, torch_run, name, router):
    key = f"case/{name}/{router}/"
    got = {k[len(key):]: v for k, v in torch_run.items() if k.startswith(key)}
    want = {k[len(key):]: v for k, v in jax_ref.items() if k.startswith(key)}
    assert got.keys() == want.keys()
    for k in ("ticks", "drained", "active_units", "queued", "hedged",
              "scale_events", "throttled_units"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("power_w", "served", "energy_j", "p50_latency_s",
              "p95_latency_s", "p99_latency_s"):
        _close(got[k], want[k], RTOL[k], k)
    for k in ("max_temp_c", "fan_power_w"):
        _close(got[k], want[k], RTOL["power_w"], k)


def test_cases_are_not_vacuous(jax_ref):
    """The JAX reference itself hedges and throttles where the cases
    mean it to, so the comparisons above cover those paths."""
    assert jax_ref["case/hedging/join-shortest-queue/hedged"].sum() > 0
    assert jax_ref["case/thermal-trip/round-robin/throttled_units"].sum() > 0
    assert jax_ref["sweep/hedged"][3] > 0


def test_sweep_matches_jax(jax_ref, torch_run):
    for k in SWEEP_EXACT:
        np.testing.assert_array_equal(torch_run[f"sweep/{k}"],
                                      jax_ref[f"sweep/{k}"], err_msg=k)
    for k, rtol in SWEEP_RTOL.items():
        _close(torch_run[f"sweep/{k}"], jax_ref[f"sweep/{k}"], rtol, k)


def _overlay(run, case):
    key = f"overlay/{case}/"
    return {k[len(key):]: v for k, v in run.items() if k.startswith(key)}


def test_chaos_matches_jax(jax_ref, torch_run):
    """tests/test_chaos.py::test_jax_tolerance_parity_under_chaos's
    assertions, the JAX engine in the vector engine's place."""
    tj, tt = _overlay(jax_ref, "chaos"), _overlay(torch_run, "chaos")
    assert np.isclose(tj["served"], tt["served"], rtol=RTOL["served"])
    assert np.isclose(tj["energy_j"], tt["energy_j"], rtol=RTOL["energy_j"])
    assert np.allclose(tj["power_w"], tt["power_w"], rtol=RTOL["power_w"],
                       atol=ATOL)
    assert np.allclose(tj["queued"], tt["queued"], rtol=RTOL["queued"],
                       atol=ATOL)
    assert np.array_equal(tj["active_units"], tt["active_units"])
    assert np.allclose(tj["assigned_rps"], tt["assigned_rps"], rtol=1e-9,
                       atol=ATOL)
    assert np.allclose(tj["offered_rps"], tt["offered_rps"], rtol=1e-9,
                       atol=ATOL)
    for k in ("p50_latency_s", "p99_latency_s"):
        assert np.isclose(tj[k], tt[k], rtol=RTOL[k]), k
    assert tj["respilled_requests"] == tt["respilled_requests"]
    assert tj["dropped_requests"] == tt["dropped_requests"]
    assert np.isclose(tj["respilled_cost"], tt["respilled_cost"], rtol=1e-9,
                      atol=ATOL)
    assert tj["reconvergence_ticks"] == tt["reconvergence_ticks"] >= 0
    assert np.isclose(tj["p99_blowup"], tt["p99_blowup"], rtol=1e-9)


@pytest.mark.parametrize("on_kill", ["respill", "drop"])
def test_voided_requests_match_jax(jax_ref, torch_run, on_kill):
    """tests/test_chaos.py::test_jax_voided_request_parity's assertions."""
    case = f"voided-{on_kill}"
    tj, tt = _overlay(jax_ref, case), _overlay(torch_run, case)
    assert tj["respilled_requests"] == tt["respilled_requests"]
    assert tj["dropped_requests"] == tt["dropped_requests"]
    assert np.isclose(tj["respilled_cost"], tt["respilled_cost"], rtol=1e-9)
    assert np.isclose(tj["dropped_cost"], tt["dropped_cost"], rtol=1e-9)
    assert np.isclose(tj["served"], tt["served"], rtol=1e-11)
    assert np.allclose(tj["queued"], tt["queued"], rtol=1e-9, atol=ATOL)
    voided = (tt["respilled_requests"] if on_kill == "respill"
              else tt["dropped_requests"])
    assert voided > 0, "vacuous: no backlog on the rack at kill time"


def test_degrade_matches_jax(jax_ref, torch_run):
    """tests/test_degrade.py::test_jax_degrade_parity's assertions."""
    tj, tt = _overlay(jax_ref, "degrade"), _overlay(torch_run, "degrade")
    assert tt["shed_cost"] > 0.0 and tt["breaker_opens"] > 0
    for k in ("served", "energy_j", "shed_cost", "expired_cost",
              "retried_cost", "retry_dropped_cost", "p99_latency_s"):
        assert np.isclose(tj[k], tt[k], rtol=JAX_RTOL), k
    assert tj["breaker_opens"] == tt["breaker_opens"]
    assert np.array_equal(tj["breaker_state_t"], tt["breaker_state_t"])
    for k in ("shed_cost_t", "offered_rps"):
        assert tj[k].shape == tt[k].shape, k
        assert np.allclose(tj[k], tt[k], rtol=JAX_RTOL, atol=1e-9), k
    assert tj["ticks"] == tt["ticks"] and tj["drained"] == tt["drained"]
    assert np.array_equal(tj["responses"], tt["responses"])
    for tier in TIERS:
        assert tt[f"tier_{tier}"][1] > 0.0
        assert np.allclose(tj[f"tier_{tier}"], tt[f"tier_{tier}"],
                           rtol=JAX_RTOL, atol=0.0), tier
