"""``python -m repro_torch.obs.report`` — one-shot observability run report.

Drives a fig16-style mini-fleet (mixed SoC + Xeon racks, optionally
the full DVFS + thermal stack) through a diurnal trace with the whole
observability surface attached, then writes, under ``--out-dir``:

  * ``report.md`` / ``report.html`` — run summary, energy attribution
    table, SLO alert list, probe extremes;
  * ``trace.json`` — Chrome trace-event JSON (open in Perfetto);
  * ``metrics.jsonl`` — the per-tick probe stream;
  * ``prometheus.txt`` — last-tick gauges in text exposition format;
  * ``attribution.json`` — the full rack x tenant x cause ledger.

The attribution parity contract is asserted inline: the replayed
ledger total must equal the telemetry's ``energy_j`` bitwise on the
scalar/vector backends (within the fig16 jax tolerance on ``--backend
jax``), so a passing report is itself a parity check. CI runs this as
a smoke test and uploads the HTML + trace as artifacts.
"""
from __future__ import annotations

import argparse
import html as _html
import json
import os
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.obs import (EnergyLedger, FleetObs, LatencyBurnRule, MemorySink,
                       ProbeRegistry, QueueBlowupRule, SloPolicy,
                       ThrottleStormRule, TraceConfig, TraceRecorder,
                       validate_chrome_trace)
from repro_torch.obs.export import (write_attribution_json, write_chrome_trace,
                              write_metrics_jsonl, write_prometheus)

#: fig16's documented jax tolerance (the engine reorders float ops)
JAX_RTOL = 1e-9


def _build_fleet(backend: str, n_soc: int, n_cpu: int, dvfs: bool,
                 obs: FleetObs, dt_s: float, device: str = "cuda"
                 ) -> "object":
    from repro_torch.core.cluster import edge_server_cpu, soc_cluster
    from repro_torch.fleet import Fleet, JoinShortestQueueRouter, homogeneous_fleet
    from repro_torch.power import SchedutilGovernor, ThermalParams, sd865_opp_table
    from repro_torch.runtime import ScalePolicy

    policy = ScalePolicy(
        cooldown_s=300.0, min_units=1,
        freq_governor=SchedutilGovernor() if dvfs else None)
    racks = homogeneous_fleet(
        soc_cluster(), n_soc, 30.0, policy=policy,
        opp_table=sd865_opp_table() if dvfs else None,
        thermal=ThermalParams() if dvfs else None)
    if n_cpu:
        racks += homogeneous_fleet(
            edge_server_cpu(), n_cpu, 9.0,
            policy=ScalePolicy(cooldown_s=300.0, min_units=1))
    return Fleet(racks, router=JoinShortestQueueRouter(), dt_s=dt_s,
                 backend=backend, obs=obs, device=device)


def _markdown(tel: "object", ledger: EnergyLedger, sink: MemorySink,
              trace_events: int, backend: str) -> str:
    s = tel.summary()  # type: ignore[attr-defined]
    alerts = tel.alerts  # type: ignore[attr-defined]
    hist = sink.history() if sink.n_ticks else {}
    lines: List[str] = [
        "# Fleet observability report",
        "",
        f"Backend `{backend}` · {int(s['racks'])} racks · "
        f"{int(s['ticks'])} ticks · router `{tel.router}`"  # type: ignore[attr-defined]
        f" · drained={bool(s['drained'])}",
        "",
        "## Run summary",
        "",
        "| metric | value |",
        "|---|---:|",
    ]
    for key in ("served", "energy_kwh", "tpe", "mean_power_w",
                "peak_power_w", "mean_active_units", "p50_latency_s",
                "p95_latency_s", "p99_latency_s", "proportionality",
                "monthly_electricity_usd"):
        lines.append(f"| {key} | {s[key]:.4g} |")
    lines += ["", "## Energy attribution (exact ledger)", ""]
    tol = ("bitwise" if ledger.tolerance is None
           else f"rtol {ledger.tolerance:g}")
    lines.append(f"Replay contract vs `energy_j`: **{tol}** "
                 f"(verified inline by this report).")
    lines += ["", ledger.to_markdown(), ""]
    lines += ["## SLO alerts", ""]
    if alerts:
        lines += ["| rule | severity | window | worst | threshold |",
                  "|---|---|---|---:|---:|"]
        for a in alerts:
            lines.append(
                f"| {a.rule} | {a.severity} | "
                f"[{a.t_start:.0f}s, {a.t_end:.0f}s) | "
                f"{a.worst_value:.4g} | {a.threshold:.4g} |")
    else:
        lines.append("No alerts fired.")
    if hist:
        lines += ["", "## Probe extremes", "",
                  "| metric | min | max |", "|---|---:|---:|"]
        for metric in sorted(hist):
            rows = hist[metric]
            with np.errstate(invalid="ignore"):
                lo, hi = np.nanmin(rows), np.nanmax(rows)
            lines.append(f"| {metric} | {lo:.4g} | {hi:.4g} |")
    lines += ["", "## Artifacts", "",
              f"- `trace.json` — {trace_events} chrome-trace events "
              "(open at https://ui.perfetto.dev)",
              "- `metrics.jsonl` — per-tick probe stream",
              "- `prometheus.txt` — last-tick text exposition",
              "- `attribution.json` — full rack x tenant x cause ledger",
              ""]
    return "\n".join(lines)


def _md_to_html(md: str) -> str:
    """Minimal markdown → HTML (headers, tables, inline code, bold) —
    enough for the artifacts viewer, no external dependency."""
    out: List[str] = ["<!doctype html><html><head><meta charset='utf-8'>",
                      "<title>Fleet observability report</title><style>",
                      "body{font-family:sans-serif;margin:2em;max-width:60em}",
                      "table{border-collapse:collapse}",
                      "td,th{border:1px solid #999;padding:0.3em 0.8em}",
                      "code{background:#eee;padding:0 0.2em}",
                      "</style></head><body>"]
    in_table = False

    def inline(text: str) -> str:
        text = _html.escape(text)
        for mark, tag in (("**", "b"), ("`", "code")):
            parts = text.split(mark)
            if len(parts) > 2:
                rebuilt = parts[0]
                for j, part in enumerate(parts[1:], 1):
                    rebuilt += (f"<{tag}>" if j % 2 else f"</{tag}>") + part
                if len(parts) % 2:  # balanced marks only
                    text = rebuilt
        return text

    for line in md.splitlines():
        if line.startswith("|"):
            cells = [c.strip() for c in line.strip("|").split("|")]
            if all(set(c) <= {"-", ":", " "} and c for c in cells):
                continue  # separator row
            if not in_table:
                out.append("<table>")
                in_table = True
            out.append("<tr>" + "".join(
                f"<td>{inline(c)}</td>" for c in cells) + "</tr>")
            continue
        if in_table:
            out.append("</table>")
            in_table = False
        if line.startswith("#"):
            level = len(line) - len(line.lstrip("#"))
            out.append(f"<h{level}>{inline(line.lstrip('# '))}</h{level}>")
        elif line.startswith("- "):
            out.append(f"<p>• {inline(line[2:])}</p>")
        elif line.strip():
            out.append(f"<p>{inline(line)}</p>")
    if in_table:
        out.append("</table>")
    out.append("</body></html>")
    return "\n".join(out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="fig16-style mini-run with the full observability "
                    "surface; writes a markdown/HTML report + artifacts")
    ap.add_argument("--backend", default="vector",
                    choices=("scalar", "vector", "torch"))
    ap.add_argument("--device", default="cuda",
                    help="device of --backend torch (default cuda; cpu "
                         "runs the same step eagerly)")
    ap.add_argument("--out-dir", default="obs_report")
    ap.add_argument("--soc", type=int, default=8,
                    help="SoC-cluster racks (default 8)")
    ap.add_argument("--cpu", type=int, default=2,
                    help="Xeon edge racks (default 2)")
    ap.add_argument("--hours", type=float, default=2.0,
                    help="diurnal trace length (default 2 h)")
    ap.add_argument("--dvfs", action="store_true",
                    help="attach schedutil + SD865 OPP table + RC "
                         "thermal network to the SoC racks")
    ap.add_argument("--load", type=float, default=0.5,
                    help="trace peak as a fraction of fleet capacity")
    ap.add_argument("--sample-every", type=int, default=1,
                    help="trace-span request sampling stride")
    args = ap.parse_args(argv)

    from repro_torch.fleet import diurnal_trace

    dt_s = 60.0
    sink = MemorySink()
    ledger = EnergyLedger()
    slo = SloPolicy([
        LatencyBurnRule(target_s=3.0 * dt_s, window_s=30 * dt_s),
        ThrottleStormRule(max_throttled_units=0),
        QueueBlowupRule(max_queued=50),
    ])
    obs = FleetObs(probes=ProbeRegistry([sink]), ledger=ledger, slo=slo)
    fleet = _build_fleet(args.backend, args.soc, args.cpu, args.dvfs,
                         obs, dt_s, device=args.device)
    trace = args.load * fleet.capacity_rps * diurnal_trace(
        peak_rps=1.0, hours=args.hours, dt_s=dt_s, seed=7)
    tel = fleet.play_trace(trace)

    # the parity contract, asserted inline
    replay = ledger.total_energy_j()
    if args.backend == "torch":
        err = abs(replay - tel.energy_j) / max(abs(tel.energy_j), 1e-30)
        assert err <= JAX_RTOL, \
            f"ledger replay off by rel {err:.3e} (> {JAX_RTOL})"
    else:
        assert replay == tel.energy_j, \
            f"ledger replay {replay!r} != energy_j {tel.energy_j!r}"

    os.makedirs(args.out_dir, exist_ok=True)
    rec = TraceRecorder(config=TraceConfig(sample_every=args.sample_every))
    rec.record_fleet(tel, sink)
    chrome = rec.to_chrome_trace()
    problems = validate_chrome_trace(chrome)
    assert not problems, f"invalid chrome trace: {problems[:5]}"
    write_chrome_trace(os.path.join(args.out_dir, "trace.json"), chrome)
    write_metrics_jsonl(os.path.join(args.out_dir, "metrics.jsonl"), sink)
    write_prometheus(os.path.join(args.out_dir, "prometheus.txt"), sink,
                     tel.alerts)
    write_attribution_json(
        os.path.join(args.out_dir, "attribution.json"), ledger)
    md = _markdown(tel, ledger, sink, len(chrome["traceEvents"]),
                   args.backend)
    with open(os.path.join(args.out_dir, "report.md"), "w") as fh:
        fh.write(md)
    with open(os.path.join(args.out_dir, "report.html"), "w") as fh:
        fh.write(_md_to_html(md))
    with open(os.path.join(args.out_dir, "summary.json"), "w") as fh:
        json.dump({k: float(v) for k, v in tel.summary().items()}, fh,
                  indent=2)
    print(f"report: {os.path.join(args.out_dir, 'report.md')} "
          f"(+ html, trace.json, metrics.jsonl, prometheus.txt, "
          f"attribution.json)")
    print(f"energy {tel.energy_j:.1f} J, ledger replay {replay:.1f} J, "
          f"{len(tel.alerts)} alert(s), "
          f"{len(chrome['traceEvents'])} trace events")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
