"""Energy-proportional elastic scheduler with straggler hedging.

The paper's observation (§2.3, Fig 5): edge load is user-driven and swings
25x within a day while deployed clusters sit below 20% utilization. Its
thesis (§5.2): a cluster of small units saves energy by *activating only
the units the offered load needs*, and requests stuck past a latency
deadline are hedged onto an extra unit (the cross-unit analogue of backup
tasks).

Since the unit-allocation refactor, :class:`ElasticScheduler` is a **thin
wrapper**: ``simulate()`` builds a one-tenant
:class:`~repro_torch.runtime.MultiTenantRuntime` over a fluid
:class:`~repro_torch.runtime.QueueWorkload` and plays the trace through the
canonical runtime loop — the wake/cooldown/hedge policy lives once, in
:class:`~repro_torch.runtime.UnitGovernor` and the runtime's hedging pass, not
in a duplicated simulation loop here. Both report the unified
:class:`repro_torch.runtime.Telemetry` (``SimResult`` is a deprecated alias).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.cluster import ClusterSpec
# Deprecation shims: ScalePolicy now lives in repro_torch.runtime.policy and the
# result struct is the unified repro_torch.runtime.Telemetry; both are
# re-exported here so existing imports keep working.
from repro_torch.runtime.multi_tenant import MultiTenantRuntime, Tenant
from repro_torch.runtime.policy import ScalePolicy
from repro_torch.runtime.result import Telemetry
from repro_torch.runtime.workload import QueueWorkload

SimResult = Telemetry


class ElasticScheduler:
    """Fluid model of the unit-activation policy (thin runtime wrapper).

    Each unit serves ``unit_rate`` req/s at full utilization; queued
    requests are FIFO. The heavy lifting happens in the runtime stack —
    this class only packages a trace into a one-tenant run and trims the
    result to the legacy report shape.
    """

    def __init__(self, spec: ClusterSpec, unit_rate: float,
                 policy: Optional[ScalePolicy] = None):
        self.spec = spec
        self.unit_rate = unit_rate
        self.policy = policy or ScalePolicy()

    def target_units(self, offered: float) -> int:
        need = offered * self.policy.headroom / self.unit_rate
        return int(min(self.spec.n_units,
                       max(self.policy.min_units, np.ceil(need))))

    def simulate(self, load_trace: Sequence[float], dt_s: float = 1.0
                 ) -> SimResult:
        """Play ``load_trace`` through a one-tenant runtime.

        The runtime keeps ticking past the trace to drain the backlog
        (so latencies are real completion times, not estimates); the
        per-tick series and the energy integral are then trimmed back to
        the trace window, which is what the legacy simulator reported.
        """
        trace = np.asarray(load_trace, float)
        workload = QueueWorkload(self.unit_rate, name="elastic-sim")
        runtime = MultiTenantRuntime(
            self.spec,
            [Tenant("sim", workload, policy=self.policy,
                    unit_rate=self.unit_rate)],
            dt_s=dt_s, model_wake_latency=True)
        tel = runtime.play_traces({"sim": trace}, dt_s=dt_s)
        n = len(trace)
        energy = float(np.sum(tel.power_w[:n]) * dt_s)
        served = float(np.sum(runtime.pool.served_hist[:n]))
        return Telemetry(
            time_s=tel.time_s[:n],
            offered_load=trace,
            active_units=tel.active_units[:n],
            power_w=tel.power_w[:n],
            utilization=tel.utilization[:n],
            served=served,
            hedged=tel.hedged,
            scale_events=tel.scale_events,
            p50_latency_s=tel.p50_latency_s,
            p99_latency_s=tel.p99_latency_s,
            energy_j=energy,
            responses=tel.responses,
            workload=tel.workload,
        )


def diurnal_trace(peak_rps: float, hours: float = 24.0, dt_s: float = 60.0,
                  trough_frac: float = 0.04, noise: float = 0.05,
                  seed: int = 0) -> np.ndarray:
    """Synthetic diurnal load like the paper's Fig 5 (25x peak/trough)."""
    rng = np.random.default_rng(seed)
    n = int(hours * 3600 / dt_s)
    t = np.linspace(0, hours, n)
    base = 0.5 * (1 + np.sin((t - 9.0) / 24.0 * 2 * np.pi))
    load = trough_frac + (1 - trough_frac) * base ** 2
    load = load * (1 + noise * rng.standard_normal(n))
    return np.clip(load, 0.0, 1.0) * peak_rps
