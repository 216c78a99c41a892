"""Fleet-scale arrival traces: diurnal, flash-crowd, and replay files.

A fleet trace is a 1-D array of offered load (requests/s) per tick for
the *whole* fleet; the :class:`~repro_torch.fleet.router.Router` shards it
across racks each tick. Three sources:

  * :func:`diurnal_trace` (re-exported from ``core.scheduler``) — the
    paper's Fig 5 day/night swing (25x peak/trough);
  * :func:`flash_crowd_trace` — a baseline with a sudden multiplicative
    spike (the "breaking-news" case public edge platforms provision
    for);
  * :func:`replay_trace` — arrival rates replayed from a file, one
    requests/s value per line (``#`` comments and a trailing CSV column
    layout ``t,rps`` are accepted), so measured traces from production
    load balancers can drive the simulation.

:func:`scale_to_users` rescales any trace so its peak corresponds to a
target user population — this is how the fig16 sweep turns a unit-less
diurnal shape into "millions of users" of offered load.
"""
from __future__ import annotations

import os
from typing import Sequence, Union

import numpy as np

from repro_torch.core.scheduler import diurnal_trace

__all__ = [
    "diurnal_trace",
    "flash_crowd_trace",
    "replay_trace",
    "save_trace",
    "scale_to_users",
]


def flash_crowd_trace(
    base_rps: float,
    spike_mult: float = 8.0,
    hours: float = 2.0,
    dt_s: float = 60.0,
    spike_start_h: float = 0.75,
    spike_ramp_h: float = 0.05,
    spike_hold_h: float = 0.35,
    noise: float = 0.03,
    seed: int = 0,
) -> np.ndarray:
    """A steady baseline with one flash crowd: load ramps linearly to
    ``spike_mult`` x baseline over ``spike_ramp_h``, holds, and ramps
    back down. The shape stresses routers (queue imbalance) and
    governors (wake storms) far more than a smooth diurnal."""
    rng = np.random.default_rng(seed)
    n = int(hours * 3600 / dt_s)
    t_h = np.arange(n) * dt_s / 3600.0
    up0, up1 = spike_start_h, spike_start_h + spike_ramp_h
    dn0 = up1 + spike_hold_h
    dn1 = dn0 + spike_ramp_h
    ramp_up = np.clip((t_h - up0) / max(up1 - up0, 1e-9), 0.0, 1.0)
    ramp_dn = np.clip((t_h - dn0) / max(dn1 - dn0, 1e-9), 0.0, 1.0)
    mult = 1.0 + (spike_mult - 1.0) * (ramp_up - ramp_dn)
    load = base_rps * mult * (1.0 + noise * rng.standard_normal(n))
    return np.clip(load, 0.0, None)


def replay_trace(path: Union[str, os.PathLike], scale: float = 1.0) -> np.ndarray:
    """Load an arrival-rate trace from a text file: one requests/s value
    per line (blank lines and ``#`` comments skipped). Lines with
    commas are treated as CSV and the *last* column is used, so both
    bare dumps and ``timestamp,rps`` exports replay unchanged."""
    values = []
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            values.append(float(line.split(",")[-1]))
    if not values:
        raise ValueError(f"replay trace {path!r} contains no samples")
    return np.asarray(values, float) * scale


def save_trace(path: Union[str, os.PathLike], trace: Sequence[float]) -> None:
    """Write a trace in the :func:`replay_trace` format."""
    with open(path, "w") as fh:
        fh.write("# requests/s, one tick per line\n")
        for v in np.asarray(trace, float):
            fh.write(f"{v:.6f}\n")


def scale_to_users(
    trace: Sequence[float],
    users: float,
    rps_per_user: float = 0.02,
) -> np.ndarray:
    """Rescale ``trace`` so its peak equals ``users * rps_per_user``
    (every user contributing ``rps_per_user`` requests/s at the daily
    peak — the ROADMAP's "millions of users" knob)."""
    tr = np.asarray(trace, float)
    peak = float(tr.max())
    if peak <= 0.0:
        raise ValueError("trace has no positive samples to scale")
    return tr * (users * rps_per_user / peak)
