"""Exporters: JSONL metric streams, Prometheus text exposition, chrome
traces, and attribution tables.

These writers format *finished* observability state — they are not on
any engine hot path and are deliberately exempt from the reprolint
parity gate (see ``tools/reprolint/config.py``): they never compute
new telemetry, only serialize what the probes/ledger recorded.
:mod:`repro_torch.obs.attribution` stays parity-critical; this module does
not.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Mapping, Optional

import numpy as np

from repro_torch.obs.attribution import EnergyLedger
from repro_torch.obs.probe import MemorySink
from repro_torch.obs.slo import Alert

__all__ = ["metric_records", "write_jsonl", "write_metrics_jsonl",
           "prometheus_text", "write_prometheus", "write_chrome_trace",
           "write_attribution_json"]

_PROM_PREFIX = "repro_fleet"


def metric_records(sink: MemorySink) -> Iterable[Dict[str, Any]]:
    """One JSON-able record per (tick, metric): ``{t, dt_s, metric,
    values: {rack: value}}``."""
    if not sink.n_ticks:
        return
    times = sink.times()
    dts = sink.dts()
    names = sink.rack_names
    hist = sink.history()
    for i in range(sink.n_ticks):
        for metric, rows in hist.items():
            vals = {
                names[r] if r < len(names) else f"rack{r}": _scalar(rows[i, r])
                for r in range(rows.shape[1])
            }
            yield {"t": float(times[i]), "dt_s": float(dts[i]),
                   "metric": metric, "values": vals}


def _scalar(v: Any) -> Any:
    """numpy scalar → plain python (NaN → None for strict JSON)."""
    f = float(v)
    if np.isnan(f):
        return None
    if float(f).is_integer() and isinstance(v, (np.integer, int)):
        return int(v)
    return f


def write_jsonl(path: str, records: Iterable[Mapping[str, Any]]) -> int:
    """Write records as JSON Lines; returns the number written."""
    n = 0
    with open(path, "w") as fh:
        for rec in records:
            fh.write(json.dumps(rec))
            fh.write("\n")
            n += 1
    return n


def write_metrics_jsonl(path: str, sink: MemorySink) -> int:
    return write_jsonl(path, metric_records(sink))


def prometheus_text(sink: MemorySink,
                    alerts: Optional[List[Alert]] = None) -> str:
    """Prometheus text exposition (v0.0.4) of the *latest* tick's
    gauges, one time series per rack, plus alert counts per rule."""
    lines: List[str] = []
    names = sink.rack_names
    for metric, row in sorted(sink.last().items()):
        prom = f"{_PROM_PREFIX}_{metric}"
        lines.append(f"# HELP {prom} per-rack fleet probe gauge")
        lines.append(f"# TYPE {prom} gauge")
        for r in range(len(row)):
            v = _scalar(row[r])
            if v is None:
                continue
            rack = names[r] if r < len(names) else f"rack{r}"
            lines.append(f'{prom}{{rack="{rack}"}} {v}')
    if alerts is not None:
        prom = f"{_PROM_PREFIX}_slo_alerts_total"
        lines.append(f"# HELP {prom} SLO alert windows per rule")
        lines.append(f"# TYPE {prom} counter")
        counts: Dict[str, int] = {}
        for alert in alerts:
            counts[alert.rule] = counts.get(alert.rule, 0) + 1
        for rule, cnt in sorted(counts.items()):
            lines.append(f'{prom}{{rule="{rule}"}} {cnt}')
    return "\n".join(lines) + "\n"


def write_prometheus(path: str, sink: MemorySink,
                     alerts: Optional[List[Alert]] = None) -> None:
    with open(path, "w") as fh:
        fh.write(prometheus_text(sink, alerts))


def write_chrome_trace(path: str, trace: Mapping[str, Any]) -> None:
    with open(path, "w") as fh:
        json.dump(trace, fh)


def write_attribution_json(path: str, ledger: EnergyLedger) -> None:
    """The full rack x tenant x cause breakdown plus replay totals."""
    doc = {
        "total_energy_j": ledger.total_energy_j(),
        "tolerance": ledger.tolerance,
        "by_cause": ledger.by_cause(),
        "by_tenant": ledger.by_tenant(),
        "rack_energy_j": ledger.rack_energy_j(),
        "records": ledger.to_records(),
    }
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2)
