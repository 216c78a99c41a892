"""The port's copy of the numpy cluster layer.

cluster    — the cluster-of-small-units hardware model, plus an H100 spec
energy     — TpE + energy-proportionality accounting (the fleet telemetry's)
scheduler  — diurnal traces and the re-exported activation policy
tco        — total-cost-of-ownership constants and model
"""
from repro_torch.core import cluster, energy, scheduler, tco

__all__ = ["cluster", "energy", "scheduler", "tco"]
