"""Per-tick fleet probes: zero-cost when off, row-based when on.

A :class:`ProbeRegistry` fans one per-tick emission out to its sinks.
Engines hold a single ``obs`` reference and perform exactly one
``is None`` check per tick when observability is not configured — the
"probes off = no measurable cost" half of the overhead contract. When
on, the scalar and vector engines emit one row per tick; the jax
engine's jitted scan stays pure and its rows are expanded host-side
after ``lax.scan`` (``Fleet._obs_expand_jax``), so enabling probes
never perturbs simulation arithmetic on any backend.

A row is a ``{metric: (n_racks,) array}`` mapping — one numpy op per
metric per tick, not per-rack Python objects — which is what keeps the
probes-on vector tick rate within the perf-gated 5% budget
(``obs/fleet_probe_overhead_ratio`` in ``benchmarks/BENCH_baseline.json``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence

import numpy as np

__all__ = ["PROBE_METRICS", "MetricSink", "MemorySink", "CallbackSink",
           "ProbeRegistry"]

#: Standard per-tick fleet metrics (per-rack arrays). Thermal metrics
#: are only emitted by fleets with a thermal model; ``max_temp_c`` is
#: NaN for racks without one.
PROBE_METRICS: Dict[str, str] = {
    "power_w": "rack power incl. shared rail (W)",
    "queued": "requests waiting after the tick",
    "active_units": "powered units (incl. hedge borrows)",
    "waking_units": "units mid wake transition (0 in the fleet "
                    "engines' instantaneous-activation model)",
    "utilization": "fraction of powered capacity used",
    "opp_index": "operating point selected this tick (0 for racks "
                 "without an OPP table)",
    "hedge_units": "straggler-hedge units borrowed this tick",
    "max_temp_c": "hottest die (NaN for racks without a thermal model)",
    "throttled_units": "trip-latched dies",
}


class MetricSink:
    """Receives per-tick rows. Subclass and override ``on_tick``."""

    def bind(self, rack_names: Sequence[str]) -> None:
        """Called once, before the first row, with the rack labels."""
        self.rack_names = list(rack_names)

    def on_tick(self, t: float, dt_s: float,
                metrics: Mapping[str, np.ndarray]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """Flush/teardown hook for streaming sinks."""


class MemorySink(MetricSink):
    """Accumulates rows in memory; the default sink for tests, traces,
    and reports. ``history()`` stacks each metric into a
    ``(ticks, racks)`` array."""

    def __init__(self) -> None:
        self.rack_names: List[str] = []
        self._t: List[float] = []
        self._dt: List[float] = []
        self._rows: Dict[str, List[np.ndarray]] = {}

    def on_tick(self, t: float, dt_s: float,
                metrics: Mapping[str, np.ndarray]) -> None:
        self._t.append(t)
        self._dt.append(dt_s)
        for name, row in metrics.items():
            self._rows.setdefault(name, []).append(row)

    @property
    def n_ticks(self) -> int:
        return len(self._t)

    def times(self) -> np.ndarray:
        return np.asarray(self._t, float)

    def dts(self) -> np.ndarray:
        return np.asarray(self._dt, float)

    def history(self) -> Dict[str, np.ndarray]:
        """``{metric: (ticks, racks)}`` stacked history."""
        return {name: np.stack(rows) for name, rows in self._rows.items()}

    def last(self) -> Dict[str, np.ndarray]:
        """The most recent row per metric (Prometheus-style gauges)."""
        return {name: rows[-1] for name, rows in self._rows.items() if rows}


class CallbackSink(MetricSink):
    """Adapts a plain callable ``fn(t, dt_s, metrics)`` into a sink."""

    def __init__(self, fn: Callable[[float, float,
                                     Mapping[str, np.ndarray]], None]) -> None:
        self.rack_names: List[str] = []
        self._fn = fn

    def on_tick(self, t: float, dt_s: float,
                metrics: Mapping[str, np.ndarray]) -> None:
        self._fn(t, dt_s, metrics)


class ProbeRegistry:
    """Routes per-tick rows from an engine to every registered sink."""

    def __init__(self, sinks: Sequence[MetricSink] = ()) -> None:
        self.rack_names: List[str] = []
        self._sinks: List[MetricSink] = list(sinks)

    def add_sink(self, sink: MetricSink) -> MetricSink:
        self._sinks.append(sink)
        if self.rack_names:
            sink.bind(self.rack_names)
        return sink

    @property
    def active(self) -> bool:
        """True when at least one sink is listening — engines skip row
        construction entirely when this is False."""
        return bool(self._sinks)

    def bind(self, rack_names: Sequence[str]) -> None:
        self.rack_names = list(rack_names)
        for sink in self._sinks:
            sink.bind(rack_names)

    def emit_tick(self, t: float, dt_s: float,
                  metrics: Mapping[str, np.ndarray]) -> None:
        for sink in self._sinks:
            sink.on_tick(t, dt_s, metrics)

    def close(self) -> None:
        for sink in self._sinks:
            sink.close()
