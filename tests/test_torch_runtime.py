"""The port's request-lifecycle runtime (``repro_torch.runtime``) against
the JAX package's ``repro.runtime`` on the same inputs.

The numpy layer (cluster specs, pools, policies, power, fluid workloads)
is an own copy, so every scenario below is written once, run through each
package, and its telemetry held equal with ``==``. LM serving runs the
JAX engine's ``init_random(0)`` weights in both packages (moved over by
``repro_torch.convert``) in fp32 at smoke size: tokens per request and
telemetry must be identical. The launcher's report must carry the JAX
launcher's keys and activation telemetry.
"""
import importlib
import io
import json
import sys
import types
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JServeConfig
from repro.config import get_config as jget_config
from repro.config import smoke_config as jsmoke_config
from repro.serving.engine import ServingEngine as JEngine
from repro.workloads.transcoding import VIDEOS
from repro_torch.config import ServeConfig, get_config, smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.serving.engine import ServingEngine

PACKAGES = ("repro", "repro_torch")
BACKENDS = ("scalar", "vector")
CPU = torch.device("cpu")


def _pkg(name: str) -> types.SimpleNamespace:
    """The numpy-layer modules of one package, under common names."""
    imp = lambda m: importlib.import_module(f"{name}.{m}")
    return types.SimpleNamespace(
        cluster=imp("core.cluster"), scheduler=imp("core.scheduler"),
        runtime=imp("runtime"), power=imp("power"))


def _both(scenario, *args):
    """Run ``scenario(pkg, *args)`` once per package."""
    return [scenario(_pkg(name), *args) for name in PACKAGES]


def _assert_telemetry_equal(a, b):
    assert a.summary() == b.summary()
    assert a.energy_j == b.energy_j
    assert a.unit_energy_j == b.unit_energy_j
    for f in ("time_s", "power_w", "active_units", "utilization",
              "offered_load", "max_temp_c", "throttled_units",
              "fan_power_w"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert [(r.rid, r.arrival_s, r.finish_s) for r in a.responses] == \
        [(r.rid, r.arrival_s, r.finish_s) for r in b.responses]
    assert a.per_tenant.keys() == b.per_tenant.keys()
    for name in a.per_tenant:
        _assert_telemetry_equal(a.per_tenant[name], b.per_tenant[name])


# ---------------------------------------------------------------------------
# Numpy layer, exact.
# ---------------------------------------------------------------------------
def _dl_diurnal(p, backend):
    wl = p.runtime.DLServingWorkload.from_point("resnet-50", "fp32",
                                                "soc-gpu")
    rt = p.runtime.ClusterRuntime(
        p.cluster.soc_cluster(), wl,
        policy=p.runtime.ScalePolicy(cooldown_s=120.0), dt_s=60.0,
        backend=backend)
    trace = p.scheduler.diurnal_trace(peak_rps=1500.0, hours=6, dt_s=60.0,
                                      seed=0)
    return rt.play_trace(trace, dt_s=60.0)


def _two_tenants(p, backend):
    """DL serving and transcoding a quarter day apart on one cluster,
    offered more than it holds where their peaks overlap, so weighted
    fair share arbitrates."""
    spec = p.cluster.soc_cluster()
    # the port keeps no copy of the video table: the workload reads the
    # record's fields only, so both runtimes take the reference's
    video = VIDEOS[0]
    tenants = [
        p.runtime.Tenant("dl", p.runtime.DLServingWorkload(unit_rate=30.0),
                         policy=p.runtime.ScalePolicy(cooldown_s=60.0,
                                                      min_units=5),
                         weight=1.0),
        p.runtime.Tenant("video", p.runtime.TranscodingWorkload(video),
                         policy=p.runtime.ScalePolicy(cooldown_s=60.0,
                                                      min_units=5),
                         weight=2.0, group_units=5),
    ]
    rt = p.runtime.MultiTenantRuntime(spec, tenants, dt_s=600.0,
                                      backend=backend)
    day = dict(hours=24, dt_s=600.0)
    dl = p.scheduler.diurnal_trace(peak_rps=30.0 * spec.n_units * 0.8,
                                   seed=1, **day)
    tv = p.scheduler.diurnal_trace(
        peak_rps=video.soc_cpu_streams * spec.n_units * 0.8, seed=2, **day)
    return rt.play_traces({"dl": dl, "video": np.roll(tv, len(tv) // 4)},
                          dt_s=600.0)


def _dvfs_thermal(p, backend):
    spec = p.cluster.soc_cluster()
    rt = p.runtime.ClusterRuntime(
        spec, p.runtime.QueueWorkload(unit_rate=10.0),
        policy=p.runtime.ScalePolicy(
            cooldown_s=30.0, freq_governor=p.power.SchedutilGovernor()),
        opp_table=p.power.sd865_opp_table(),
        # low trip point: the latch engages within the run
        thermal=p.power.ThermalParams(t_trip_c=70.0, t_release_c=60.0),
        dt_s=1.0, backend=backend)
    tel = rt.play_trace(np.concatenate([
        np.full(120, 10.0 * spec.n_units * 1.5),
        np.full(120, 10.0 * spec.n_units * 0.25)]), dt_s=1.0)
    return tel, rt.pool


def _hedging(p, backend):
    """A burst that outruns the governor window, so backlog ages past the
    hedge deadline while free units exist."""
    spec = p.cluster.ClusterSpec(
        name="tiny", n_units=6, p_shared=10.0, group_size=1,
        unit=p.cluster.UnitSpec("u", p_off=0.0, p_idle=0.5, p_peak=4.0))
    rt = p.runtime.ClusterRuntime(
        spec, p.runtime.QueueWorkload(unit_rate=2.0),
        policy=p.runtime.ScalePolicy(headroom=1.0, cooldown_s=1e9,
                                     hedge_after_s=1.5),
        dt_s=1.0, window_s=30.0, backend=backend)
    for _ in range(5):
        rt.submit(cost=6.0, count=6.0)
        rt.tick()
    for _ in range(40):
        if rt.tick().queued == 0:
            break
    return rt.telemetry()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scenario", [_dl_diurnal, _two_tenants, _hedging],
                         ids=["dl-diurnal", "two-tenants", "hedging"])
def test_numpy_layer_telemetry_equals_reference(scenario, backend):
    ref, port = _both(scenario, backend)
    assert ref.served > 0
    _assert_telemetry_equal(ref, port)
    if scenario is _hedging:
        assert ref.hedged > 0, "the scenario must hedge"
    if scenario is _two_tenants:
        units = sum(t.active_units for t in ref.per_tenant.values())
        assert units.max() == 60, "the tenants must contend for the pool"


@pytest.mark.parametrize("backend", BACKENDS)
def test_dvfs_thermal_telemetry_equals_reference(backend):
    (ref, ref_pool), (port, port_pool) = _both(_dvfs_thermal, backend)
    _assert_telemetry_equal(ref, port)
    for f in ("power_hist", "max_temp_hist", "throttled_hist",
              "fan_power_hist"):
        assert [float(x) for x in getattr(ref_pool, f)] == \
            [float(x) for x in getattr(port_pool, f)], f
    assert max(ref_pool.throttled_hist) > 0, "the latch must engage"


def _elastic_diurnal(p):
    sched = p.scheduler.ElasticScheduler(
        p.cluster.soc_cluster(), unit_rate=1.0,
        policy=p.runtime.ScalePolicy(cooldown_s=10.0))
    return sched.simulate(p.scheduler.diurnal_trace(peak_rps=50.0,
                                                    hours=24.0, dt_s=60.0),
                          dt_s=60.0)


def _elastic_hedged_burst(p):
    sched = p.scheduler.ElasticScheduler(
        p.cluster.soc_cluster(), unit_rate=1.0,
        policy=p.runtime.ScalePolicy(cooldown_s=1e9, wake_latency_s=20.0,
                                     hedge_after_s=2.0))
    return sched.simulate(np.concatenate([np.full(30, 2.0),
                                          np.full(30, 30.0)]), dt_s=1.0)


@pytest.mark.parametrize("scenario", [_elastic_diurnal,
                                      _elastic_hedged_burst],
                         ids=["diurnal", "hedged-burst"])
def test_elastic_scheduler_equals_reference(scenario):
    """The copied ``core.scheduler`` packages a trace into a one-tenant
    run (wake latency modelled) as the original does, on the scenarios of
    ``tests/test_energy_tco.py``."""
    ref, port = _both(scenario)
    assert ref.served > 0
    _assert_telemetry_equal(ref, port)
    assert ref.served == port.served and ref.hedged == port.hedged
    if scenario is _elastic_hedged_burst:
        assert ref.hedged > 0, "the scenario must hedge"


def test_weighted_fair_share_equals_reference():
    rng = np.random.default_rng(0)
    for _ in range(50):
        names = [f"t{i}" for i in range(rng.integers(1, 5))]
        demands = {m: int(rng.integers(0, 30)) for m in names}
        floors = {m: int(rng.integers(0, 4)) for m in names}
        weights = {m: float(rng.uniform(0.5, 3.0)) for m in names}
        groups = {m: int(rng.choice([1, 2, 5])) for m in names}
        cap = int(rng.integers(1, 60))
        ref, port = (p.runtime.weighted_fair_share(demands, floors, weights,
                                                   cap, groups)
                     for p in map(_pkg, PACKAGES))
        assert ref == port


# ---------------------------------------------------------------------------
# The H100 spec.
# ---------------------------------------------------------------------------
def test_h100_spec_is_one_card_in_shares():
    """8 shares in groups of 4, the JAX launcher's ``tpu_v5e_pod(8)``
    layout, summing to one card."""
    from repro.core.cluster import tpu_v5e_pod
    from repro_torch.core.cluster import h100_sxm
    spec, ref = h100_sxm(), tpu_v5e_pod(8)
    assert (spec.n_units, spec.group_size) == (ref.n_units, ref.group_size)
    n = spec.n_units
    assert spec.unit.p_peak * n == pytest.approx(700.0)
    assert spec.unit.peak_tflops * n == pytest.approx(989.0)
    assert spec.unit.mem_gb * n == pytest.approx(80.0)
    assert spec.peak_power == pytest.approx(700.0)
    assert spec.p_shared == 0.0
    assert spec.unit.p_off == spec.unit.p_idle


def test_h100_shares_cannot_be_gated_off():
    """p_off = p_idle: gating a share saves nothing, so a gated and an
    ungated run of the same load cost the same modelled energy."""
    from repro_torch.core.cluster import h100_sxm
    from repro_torch.runtime import ClusterRuntime, QueueWorkload, ScalePolicy

    def run(idle_units_off):
        rt = ClusterRuntime(h100_sxm(), QueueWorkload(unit_rate=1.0),
                            policy=ScalePolicy(min_units=1),
                            idle_units_off=idle_units_off)
        return rt.play_trace(np.full(30, 2.0), dt_s=1.0)

    gated, ungated = run(True), run(False)
    assert gated.mean_active < 8
    assert gated.energy_j == ungated.energy_j


# ---------------------------------------------------------------------------
# LM serving through both runtimes, exact.
# ---------------------------------------------------------------------------
LM_ARCHS = ("internlm2-1.8b", "mamba2-130m")
# <= the smoke SSD chunk (32) or a multiple of it, as mamba prompts need
LM_PROMPTS = (5, 11, 32, 5, 11, 32)


@pytest.fixture(scope="module", params=LM_ARCHS)
def engine_pair(request):
    jcfg = jsmoke_config(jget_config(request.param)).replace(dtype="float32")
    cfg = smoke_config(get_config(request.param)).replace(dtype="float32")
    jeng = JEngine(jcfg, JServeConfig(max_seq_len=64))
    jeng.init_random(0)
    eng = ServingEngine(cfg, ServeConfig(max_seq_len=64), device="cpu")
    eng.load(from_jax_params(jax.tree.map(np.asarray, jeng.params), cfg,
                             CPU))
    return jeng, eng


def _serve_lm(p, engine, slots=4, max_new_tokens=5):
    wl = p.runtime.LMServingWorkload(engine, slots=slots,
                                     max_new_tokens=max_new_tokens)
    rt = p.runtime.ClusterRuntime(p.cluster.tpu_v5e_pod(8), wl,
                                  policy=p.runtime.ScalePolicy(min_units=1),
                                  unit_rate=0.25)
    rng = np.random.default_rng(3)
    for n in LM_PROMPTS:
        rt.submit(rng.integers(0, engine.cfg.vocab_size, n).astype(np.int32))
    return rt.run(max_ticks=1000)


def test_lm_serving_equals_reference(engine_pair):
    jeng, eng = engine_pair
    ref = _serve_lm(_pkg("repro"), jeng)
    port = _serve_lm(_pkg("repro_torch"), eng)
    assert ref.served == len(LM_PROMPTS)
    want = {r.rid: [int(t) for t in r.output] for r in ref.responses}
    got = {r.rid: r.output for r in port.responses}
    assert got == want
    assert all(len(v) == 5 for v in got.values())
    for f in ("ticks", "served", "mean_active", "energy_j", "tpe",
              "scale_events", "p99_latency_s"):
        assert getattr(port, f) == getattr(ref, f), f
    _assert_telemetry_equal(ref, port)


# ---------------------------------------------------------------------------
# Gating of the torch workload (tests/test_runtime.py's, on the port).
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lm_workload_factory():
    from repro_torch.runtime import LMServingWorkload
    cfg = smoke_config(get_config("internlm2-1.8b")).replace(dtype="float32")
    eng = ServingEngine(cfg, ServeConfig(max_seq_len=64), device="cpu")
    eng.init_random(0)

    def make(slots=4, **kw):
        return LMServingWorkload(eng, slots=slots, **kw)

    return make


def _tiny_cluster(n_units):
    from repro_torch.core.cluster import ClusterSpec, UnitSpec
    return ClusterSpec(
        name="tiny",
        unit=UnitSpec("u", p_off=0.0, p_idle=1.0, p_peak=10.0, gamma=1.0),
        n_units=n_units, p_shared=5.0)


def test_runtime_gates_lm_concurrency(lm_workload_factory):
    from repro_torch.runtime import Request
    wl = lm_workload_factory(slots=4, max_new_tokens=3)
    for _ in range(8):
        wl.submit(Request(payload=np.ones(4, np.int32)))
    # one active unit x one slot/unit -> at most 1 in flight per tick
    seen = []
    for _ in range(40):
        stats = wl.step(1, 1.0)
        seen.append(stats.concurrency)
        if stats.queued == 0 and stats.concurrency == 0:
            break
    assert max(seen) == 1
    assert sum(s.rid is not None for s in wl.drain()) == 8


def test_scale_down_keeps_inflight_powered(lm_workload_factory):
    """In-flight slots outliving a scale-down stay powered and charged."""
    from repro_torch.runtime import ClusterRuntime, ScalePolicy
    wl = lm_workload_factory(slots=4, max_new_tokens=6)
    spec = _tiny_cluster(4)
    rt = ClusterRuntime(spec, wl, policy=ScalePolicy(min_units=4,
                                                     cooldown_s=0.0),
                        unit_rate=1.0)
    for _ in range(4):
        rt.submit(np.ones(4, np.int32))
    stats = rt.tick()
    assert stats.concurrency == 4
    # force the governor target down; in-flight work keeps its units
    rt.governor.active_units = 1
    rt.governor.policy.min_units = 1
    stats = rt.tick()
    assert stats.concurrency == 4
    assert stats.active_units == 4          # powered for the overflow
    assert stats.power_w == pytest.approx(
        spec.power(4, stats.utilization, idle_units_off=True))


def test_no_hedge_when_slot_cap_binds(lm_workload_factory):
    """Borrowing a unit beyond the batcher's slot cap adds no capacity,
    so the runtime must not hedge (or charge) it."""
    from repro_torch.runtime import ClusterRuntime, ScalePolicy
    wl = lm_workload_factory(slots=2, max_new_tokens=8)
    assert wl.max_useful_units() == 2
    rt = ClusterRuntime(_tiny_cluster(8), wl, unit_rate=1.0,
                        policy=ScalePolicy(min_units=2, cooldown_s=1e9,
                                           hedge_after_s=1.0))
    for _ in range(6):
        rt.submit(np.ones(4, np.int32))
    for _ in range(4):
        stats = rt.tick()
        assert stats.hedge_units == 0       # slots already saturated
        assert stats.active_units <= 2
    assert rt.telemetry().hedged == 0


# ---------------------------------------------------------------------------
# The launcher.
# ---------------------------------------------------------------------------
ACTIVATION = ("mean_active_units", "scale_events", "p99_latency_ticks")


def _jax_launcher(monkeypatch, arch, requests, prompt_len, new_tokens):
    from repro.launch import serve as jserve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", arch, "--smoke", "--requests", str(requests),
        "--prompt-len", str(prompt_len),
        "--max-new-tokens", str(new_tokens)])
    out = io.StringIO()
    with redirect_stdout(out):
        jserve.main()
    return json.loads(out.getvalue())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_launcher_reports_what_the_jax_launcher_reports(monkeypatch, arch):
    from repro_torch.launch.serve import serve
    want = _jax_launcher(monkeypatch, arch, requests=6, prompt_len=8,
                         new_tokens=4)
    got = serve(smoke_config(get_config(arch)), [8] * 6, max_new_tokens=4,
                device="cpu")
    assert set(got) == set(want) | {"device", "kernel_launches"}
    assert set(got["telemetry"]) == set(want["telemetry"]) == {
        "mean_active_units", "energy_j_modeled", "tpe", "scale_events",
        "p99_latency_ticks"}
    for k in ("arch", "requests", "served", "ticks", "tokens_generated"):
        assert got[k] == want[k], k
    for k in ACTIVATION:
        assert got["telemetry"][k] == want["telemetry"][k], k
    assert got["device"] == "cpu"
    assert set(got["kernel_launches"].values()) == {0}
    assert got["telemetry"]["energy_j_modeled"] > 0


def test_launcher_telemetry_depends_on_counts_only():
    """No EOS, one decode a tick: telemetry is the same for any prompt
    lengths and either arch, which is what lets a card run be held to a
    CPU run at smoke size."""
    from repro_torch.launch.serve import serve
    reps = [serve(smoke_config(get_config(arch)), lens, max_new_tokens=6,
                  slots=4, device="cpu")["telemetry"]
            for arch, lens in (("internlm2-1.8b", [3, 40, 17, 9, 25]),
                               ("internlm2-1.8b", [16] * 5),
                               ("mamba2-130m", [32, 5, 64, 31, 1]))]
    assert reps[0] == reps[1] == reps[2]
