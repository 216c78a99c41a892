"""The port's copy of the numpy cluster layer.

cluster    — the cluster-of-small-units hardware model, plus an H100 spec
scheduler  — diurnal traces and the re-exported activation policy
"""
from repro_torch.core import cluster, scheduler

__all__ = ["cluster", "scheduler"]
