"""``repro_torch.obs`` — fleet observability: probes, traces, attribution, SLOs.

The paper's claims are observability claims (power tracking load,
energy per request, tail latency under diurnal/flash-crowd traffic);
this package makes them watchable *during* a run instead of only in
post-hoc roll-ups:

  * :mod:`~repro_torch.obs.probe` — zero-cost-when-off per-tick fleet
    metric streaming (power, queues, activation, OPPs, thermals);
  * :mod:`~repro_torch.obs.trace` — sampled request-lifecycle spans and
    per-rack counter tracks as Chrome trace-event JSON (Perfetto);
  * :mod:`~repro_torch.obs.attribution` — an exact energy ledger whose
    per-cause components replay **bitwise** to the pools' / vector
    engine's ``energy_j`` (jax: within the engine's documented
    tolerance) — the repo's parity contract, extended to the
    observability surface;
  * :mod:`~repro_torch.obs.slo` — burn-rate alert rules (rolling p95,
    energy budget, throttle storms, queue blow-up), streaming or
    post-hoc, surfaced on ``FleetTelemetry.alerts``;
  * :mod:`~repro_torch.obs.export` / :mod:`~repro_torch.obs.report` — JSONL,
    Prometheus text, chrome-trace writers and the
    ``python -m repro_torch.obs.report`` markdown/HTML run report.

Wire-up: build a :class:`FleetObs` and pass it to ``Fleet(obs=...)``.
All three engines emit into it — scalar and vector per tick, the jax
engine by expanding its scanned telemetry rows host-side after
``lax.scan`` (the jitted hot path stays pure).

    from repro_torch.obs import (FleetObs, ProbeRegistry, MemorySink,
                           EnergyLedger, SloPolicy, LatencyBurnRule)

    sink = MemorySink()
    obs = FleetObs(probes=ProbeRegistry([sink]),
                   ledger=EnergyLedger(),
                   slo=SloPolicy([LatencyBurnRule(target_s=120.0)]))
    fleet = Fleet(racks, backend="vector", obs=obs)
    tel = fleet.play_trace(trace)
    assert obs.ledger.total_energy_j() == tel.energy_j   # bitwise
    tel.alerts                                           # SLO windows
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.obs.attribution import CAUSES, EnergyLedger
from repro_torch.obs.probe import (PROBE_METRICS, CallbackSink, MemorySink,
                             MetricSink, ProbeRegistry)
from repro_torch.obs.slo import (Alert, EnergyBudgetRule, LatencyBurnRule,
                           QueueBlowupRule, ShedStormRule, SloPolicy,
                           SloRule, ThrottleStormRule)
from repro_torch.obs.trace import (TraceConfig, TraceRecorder, build_chrome_trace,
                             validate_chrome_trace)

__all__ = [
    "FleetObs",
    # probes
    "PROBE_METRICS", "MetricSink", "MemorySink", "CallbackSink",
    "ProbeRegistry",
    # attribution
    "EnergyLedger", "CAUSES",
    # slo
    "Alert", "SloRule", "SloPolicy", "LatencyBurnRule", "EnergyBudgetRule",
    "ThrottleStormRule", "QueueBlowupRule", "ShedStormRule",
    # traces
    "TraceConfig", "TraceRecorder", "build_chrome_trace",
    "validate_chrome_trace",
]


@dataclass
class FleetObs:
    """Observability configuration handed to ``Fleet(obs=...)``.

    Every field is optional; engines pay one ``is None`` check per
    tick for whatever is absent. ``probes`` and ``ledger`` are fed by
    the engines during the run; ``slo`` is evaluated post-hoc on every
    telemetry build (alerts land on ``FleetTelemetry.alerts``);
    ``tracer`` is *not* auto-fed (a recorder accumulates events, and
    ``play_trace`` may be called repeatedly on the same fleet) — build
    traces post-hoc with ``tracer.record_fleet(tel, sink)`` or
    :func:`~repro_torch.obs.trace.build_chrome_trace`.
    """

    probes: Optional[ProbeRegistry] = None
    ledger: Optional[EnergyLedger] = None
    slo: Optional[SloPolicy] = None
    tracer: Optional[TraceRecorder] = None
