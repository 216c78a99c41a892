"""Request-lifecycle traces as Chrome trace-event JSON (Perfetto).

:class:`TraceRecorder` turns a finished
:class:`~repro_torch.fleet.telemetry.FleetTelemetry` (plus, optionally, a
probe :class:`~repro_torch.obs.probe.MemorySink` history) into the Chrome
``traceEvents`` format: open ``ui.perfetto.dev`` (or
``chrome://tracing``) and load the saved JSON.

Per sampled request, one rack-thread track carries the lifecycle
spans: an outer ``request`` slice (submit → serve done) containing a
``queue`` slice (waiting in the rack's FIFO) and a ``serve`` slice
(the final tick's fluid drain — the fluid model serves a request
within one tick, so the serve span is ``min(dt, latency)`` wide, an
explicitly documented approximation). Routing is an instant event at
submission; hedge fires are instant events on the rack that borrowed
a unit. Per-rack counter tracks (power, queue depth, active units,
throttled dies) ride alongside from the probe history or, where
absent, from the telemetry itself.

Sampling is deterministic — request ``rid % sample_every == 0`` — so
traces are reproducible and reprolint-clean (no RNG).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["TraceConfig", "TraceRecorder", "build_chrome_trace",
           "validate_chrome_trace"]

#: trace-event phases this exporter emits
_PH_META, _PH_COMPLETE, _PH_COUNTER, _PH_INSTANT = "M", "X", "C", "i"


@dataclass
class TraceConfig:
    """Knobs bounding trace size (Perfetto handles ~1e6 events)."""

    sample_every: int = 1          # keep rids where rid % sample_every == 0
    max_spans_per_rack: int = 2000
    counter_stride: int = 1        # emit every Nth tick's counters
    counters: Tuple[str, ...] = ("power_w", "queued", "active_units",
                                 "throttled_units")


@dataclass
class TraceRecorder:
    """Accumulates trace events; ``record_fleet`` ingests one run."""

    config: TraceConfig = field(default_factory=TraceConfig)
    events: List[Dict[str, Any]] = field(default_factory=list)

    def _meta(self, pid: int, tid: int, what: str, name: str) -> None:
        self.events.append({"ph": _PH_META, "pid": pid, "tid": tid,
                            "name": what, "args": {"name": name}})

    def record_fleet(self, tel: Any,
                     probes: Optional[Any] = None) -> None:
        """Ingest one :class:`FleetTelemetry` (and optional
        :class:`MemorySink`) worth of spans, instants, and counters."""
        cfg = self.config
        names = list(tel.rack_names) or [
            f"rack{r}" for r in range(tel.n_racks)]
        self._meta(1, 0, "process_name",
                   f"fleet ({tel.router}, backend={tel.backend})")
        for r, name in enumerate(names):
            self._meta(1, r + 1, "thread_name", name)
        times = np.asarray(tel.time_s, float)
        dt = float(times[1] - times[0]) if len(times) > 1 else 1.0
        # --- request lifecycle spans (deterministic rid sampling) -------
        for r, rack_tel in enumerate(tel.per_rack):
            tid = r + 1
            kept = 0
            for resp in rack_tel.responses:
                if resp.rid % cfg.sample_every:
                    continue
                if kept >= cfg.max_spans_per_rack:
                    break
                kept += 1
                sub_us = resp.arrival_s * 1e6
                fin_us = resp.finish_s * 1e6
                lat_us = max(fin_us - sub_us, 0.0)
                serve_us = min(dt * 1e6, lat_us)
                args = {"rid": resp.rid, "rack": names[r],
                        "latency_s": resp.latency_s}
                self.events.append({
                    "ph": _PH_INSTANT, "name": "route", "cat": "router",
                    "pid": 1, "tid": tid, "ts": sub_us, "s": "t",
                    "args": args})
                self.events.append({
                    "ph": _PH_COMPLETE, "name": "request", "cat": "request",
                    "pid": 1, "tid": tid, "ts": sub_us, "dur": lat_us,
                    "args": args})
                if lat_us > serve_us:
                    self.events.append({
                        "ph": _PH_COMPLETE, "name": "queue", "cat": "queue",
                        "pid": 1, "tid": tid, "ts": sub_us,
                        "dur": lat_us - serve_us, "args": args})
                self.events.append({
                    "ph": _PH_COMPLETE, "name": "serve", "cat": "serve",
                    "pid": 1, "tid": tid, "ts": fin_us - serve_us,
                    "dur": serve_us, "args": args})
        # --- per-rack counter tracks ------------------------------------
        series = self._series(tel, probes)
        for metric, rows in series.items():
            if metric not in cfg.counters:
                continue
            for i in range(0, rows.shape[0], cfg.counter_stride):
                ts_us = float(times[i]) * 1e6 if i < len(times) else 0.0
                for r, name in enumerate(names):
                    v = float(rows[i, r])
                    if not np.isfinite(v):
                        continue
                    self.events.append({
                        "ph": _PH_COUNTER, "name": f"{metric}/{name}",
                        "pid": 1, "ts": ts_us, "args": {metric: v}})
        # --- hedge fires as instants ------------------------------------
        hedge = series.get("hedge_units")
        if hedge is not None:
            ticks_idx, racks_idx = np.nonzero(hedge > 0)
            for i, r in zip(ticks_idx.tolist(), racks_idx.tolist()):
                self.events.append({
                    "ph": _PH_INSTANT, "name": "hedge_fire", "cat": "hedge",
                    "pid": 1, "tid": r + 1,
                    "ts": float(times[i]) * 1e6, "s": "t",
                    "args": {"rack": names[r],
                             "borrowed": int(hedge[i, r])}})
        # --- chaos fault windows as instants ----------------------------
        # one instant at each event's start (and, for bounded windows,
        # one at its end) on the afflicted rack's track, so fault
        # injection lines up visually with the latency/power response
        for rec in getattr(tel, "chaos_events", []) or []:
            r = int(rec.get("rack", 0))
            if not 0 <= r < len(names):
                continue
            kind = str(rec.get("kind", "fault"))
            args = {"rack": names[r], **rec}
            if not np.isfinite(args.get("end_s", 0.0)):
                args["end_s"] = None  # open-ended fault, keep strict JSON
            self.events.append({
                "ph": _PH_INSTANT, "name": f"chaos_{kind}", "cat": "chaos",
                "pid": 1, "tid": r + 1,
                "ts": float(rec.get("start_s", 0.0)) * 1e6, "s": "t",
                "args": args})
            end_s = float(rec.get("end_s", np.inf))
            if np.isfinite(end_s):
                self.events.append({
                    "ph": _PH_INSTANT, "name": f"chaos_{kind}_clear",
                    "cat": "chaos", "pid": 1, "tid": r + 1,
                    "ts": end_s * 1e6, "s": "t", "args": args})
        # --- circuit-breaker transitions as instants --------------------
        # the degrade control plane derives these from the breaker state
        # matrix (one shared code path for every backend); plotting them
        # on the rack's track shows open/half/close lining up with the
        # queue-delay and chaos signals that caused them
        state_names = {0: "closed", 1: "open", 2: "half_open"}
        for ev in getattr(tel, "breaker_events", []) or []:
            rack = str(ev.get("rack", ""))
            try:
                tid = names.index(rack) + 1
            except ValueError:
                continue
            state = state_names.get(int(ev.get("state", 0)), "unknown")
            self.events.append({
                "ph": _PH_INSTANT, "name": f"breaker_{state}",
                "cat": "degrade", "pid": 1, "tid": tid,
                "ts": float(ev.get("t_s", 0.0)) * 1e6, "s": "t",
                "args": {"rack": rack,
                         "state": state,
                         "prev": state_names.get(
                             int(ev.get("prev", 0)), "unknown")}})

    @staticmethod
    def _series(tel: Any, probes: Optional[Any]) -> Dict[str, np.ndarray]:
        """(ticks, racks) series: probe history when available, the
        telemetry's own arrays otherwise."""
        if probes is not None and getattr(probes, "n_ticks", 0):
            return dict(probes.history())
        out = {
            "power_w": np.asarray(tel.power_w, float).T,
            "queued": np.asarray(tel.queued, float).T,
            "active_units": np.asarray(tel.active_units, float).T,
        }
        ticks = out["power_w"].shape[0]
        thr = np.full((ticks, tel.n_racks), np.nan)
        any_thr = False
        for r, rack_tel in enumerate(tel.per_rack):
            if len(rack_tel.throttled_units):
                thr[:, r] = rack_tel.throttled_units
                any_thr = True
        if any_thr:
            out["throttled_units"] = thr
        return out

    def to_chrome_trace(self) -> Dict[str, Any]:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_chrome_trace(), fh)


def build_chrome_trace(tel: Any, probes: Optional[Any] = None,
                       config: Optional[TraceConfig] = None
                       ) -> Dict[str, Any]:
    """One-shot: telemetry (+ optional probe history) → chrome trace."""
    rec = TraceRecorder(config=config or TraceConfig())
    rec.record_fleet(tel, probes)
    return rec.to_chrome_trace()


def validate_chrome_trace(trace: Mapping[str, Any]) -> List[str]:
    """Schema check against the trace-event format; returns a list of
    violations (empty = valid). Covers what Perfetto's importer
    requires: the ``traceEvents`` array, per-event ``ph``/``pid``, a
    numeric ``ts`` on timed events, ``dur >= 0`` on complete events,
    and JSON-serializability of the whole document."""
    errors: List[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents must be a list"]
    try:
        json.dumps(trace)
    except (TypeError, ValueError) as exc:
        errors.append(f"not JSON-serializable: {exc}")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in (_PH_META, _PH_COMPLETE, _PH_COUNTER, _PH_INSTANT,
                      "B", "E", "b", "e", "n", "s", "t", "f"):
            errors.append(f"event {i}: unknown phase {ph!r}")
            continue
        if "pid" not in ev:
            errors.append(f"event {i}: missing pid")
        if "name" not in ev:
            errors.append(f"event {i}: missing name")
        if ph != _PH_META:
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or not np.isfinite(ts):
                errors.append(f"event {i}: bad ts {ts!r}")
        if ph == _PH_COMPLETE:
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or not dur >= 0.0:
                errors.append(f"event {i}: complete event needs dur >= 0")
        if ph == _PH_COUNTER and not isinstance(ev.get("args"), dict):
            errors.append(f"event {i}: counter event needs args")
        if ph == _PH_INSTANT and ev.get("s", "t") not in ("g", "p", "t"):
            errors.append(f"event {i}: bad instant scope {ev.get('s')!r}")
    return errors
