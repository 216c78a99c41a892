"""Roofline analysis of a traced dry-run step: the JAX package's
``roofline/analysis.py``, less its HLO parser.

Three terms per (arch x shape x mesh) cell, per the methodology:

    compute    = FLOPs_per_chip            / peak_FLOP/s
    memory     = HBM_bytes_per_chip        / HBM_bw
    collective = collective_wire_bytes     / link_bw        (per chip)

The JAX package reads FLOPs and bytes from XLA's cost analysis of the
per-device SPMD module and parses the collectives out of its HLO text
(``parse_collectives``). The port has no HLO: its dry run traces the step
on fake tensors under a recorder (``roofline/counter.py``) that counts
rank 0's local ops and the collectives they issue, so
``parse_collectives`` has no counterpart here. What it keeps is the rule
that turns one collective into ring wire bytes per chip
(:func:`wire_bytes`), from its kind, result bytes and group size A:

    all-gather      (A-1)/A * result_bytes          (received)
    all-reduce      2 (A-1)/A * result_bytes        (RS + AG)
    reduce-scatter  (A-1)/A * A * result_bytes      (operand streamed)
    all-to-all      (A-1)/A * result_bytes
    collective-permute  result_bytes
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, Optional

from repro_torch.roofline.hw import TPU_V5E, ChipSpec

_COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                     "all-to-all", "collective-permute")


def wire_bytes(kind: str, result_bytes: float, group: int) -> float:
    """Ring wire bytes a chip moves for one collective of ``kind`` whose
    result is ``result_bytes`` over a group of ``group`` chips (the JAX
    package's ``parse_collectives`` rule)."""
    rb, a = float(result_bytes), group
    if kind == "all-gather":
        return rb * (a - 1) / a
    if kind == "all-reduce":
        return 2 * rb * (a - 1) / a
    if kind == "reduce-scatter":
        return rb * (a - 1)          # operand = A x result
    if kind == "all-to-all":
        return rb * (a - 1) / a
    if kind == "collective-permute":
        return rb
    raise ValueError(f"unknown collective kind {kind!r}")


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=dict)
    result_bytes: Dict[str, float] = field(default_factory=dict)
    wire_bytes: Dict[str, float] = field(default_factory=dict)

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    def add(self, kind: str, result_bytes: float, group: int) -> None:
        """Count one collective by :func:`wire_bytes`' rule."""
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.result_bytes[kind] = self.result_bytes.get(kind, 0.0) + \
            result_bytes
        self.wire_bytes[kind] = self.wire_bytes.get(kind, 0.0) + \
            wire_bytes(kind, result_bytes, group)


# ---------------------------------------------------------------------------
@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    step_kind: str
    chips: int
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_wire_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    bound: str
    model_flops_total: float
    useful_flops_ratio: float     # MODEL_FLOPS / (flops_per_chip * chips)
    roofline_fraction: float      # bound-term share of the sum? see note
    collective_detail: Dict[str, float] = field(default_factory=dict)
    memory_analysis: Dict[str, float] = field(default_factory=dict)
    note: str = ""

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)


def roofline_from_artifacts(*, arch: str, shape: str, mesh_name: str,
                            step_kind: str, chips: int,
                            cost: Dict[str, float],
                            collectives: CollectiveStats,
                            model_flops_total: float,
                            memory_analysis: Optional[Dict[str, float]] = None,
                            chip: ChipSpec = TPU_V5E,
                            note: str = "") -> RooflineTerms:
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    coll = collectives.total_wire_bytes
    compute_s = flops / chip.peak_flops_bf16
    memory_s = hbm / chip.hbm_bw
    collective_s = coll / chip.ici_link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bound = max(terms, key=terms.get)  # type: ignore[arg-type]
    total_hlo_flops = flops * chips
    useful = (model_flops_total / total_hlo_flops
              if total_hlo_flops > 0 else 0.0)
    # roofline fraction: useful model-FLOPs time over the dominating term
    # (an MFU-style bound: what fraction of the bottleneck's time would a
    # perfect implementation of the model math need).
    ideal_s = (model_flops_total / chips) / chip.peak_flops_bf16
    frac = ideal_s / max(terms[bound], 1e-30)
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, step_kind=step_kind,
        chips=chips, flops_per_chip=flops, hbm_bytes_per_chip=hbm,
        collective_wire_bytes_per_chip=coll,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bound=bound, model_flops_total=model_flops_total,
        useful_flops_ratio=useful, roofline_fraction=min(frac, 1.0),
        collective_detail=dict(collectives.wire_bytes),
        memory_analysis=memory_analysis or {},
        note=note,
    )


def model_flops(num_params_active: float, tokens: float,
                step_kind: str) -> float:
    """MODEL_FLOPS: 6 N D for a train step (fwd+bwd), 2 N D forward-only
    (prefill / decode-per-step)."""
    if step_kind == "train":
        return 6.0 * num_params_active * tokens
    return 2.0 * num_params_active * tokens
