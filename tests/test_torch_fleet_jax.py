"""The port's fleet engine held to the JAX engine itself, on the CPU.

``repro.fleet.jax_engine`` imports ``jax.experimental.enable_x64``, which
the installed jax (0.9) no longer has, so it does not import in this
process. A subprocess installs a one-line shim first
(``jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)``),
then runs the JAX engine over this file's cases and a 4-config sweep
over 4 racks x 2 h, and hands its series back as ``.npz``. The shim
never reaches the pytest process: installed here, it would leak into
every later test on the same worker and flip the JAX package's own
``[jax]`` tests from run to run. ``repro`` itself is not touched.

The same inputs then run through ``Fleet(backend="torch", device="cpu")``
and ``sweep(..., device="cpu")``: integer series must match exactly, the
rest within the JAX engine's tolerances (``tests/test_jax_parity.py``
``RTOL``/``ATOL``, copied as numbers in ``tests/test_torch_fleet.py``).
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

_SHIM = ("import jax, jax.experimental\n"
         "jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)\n")


def _modules(pkg):
    """The fleet, power, cluster and runtime modules of ``repro`` or
    ``repro_torch``, so one builder makes both packages' inputs."""
    return types.SimpleNamespace(**{
        name: importlib.import_module(f"{pkg}.{name}")
        for name in ("fleet", "power", "runtime")},
        cluster=importlib.import_module(f"{pkg}.core.cluster"))


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
