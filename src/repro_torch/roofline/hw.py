"""Hardware constants for the roofline analysis (deployment target:
TPU v5e), plus the paper platforms for cross-regime comparisons."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float       # FLOP/s
    hbm_bw: float                # bytes/s
    ici_link_bw: float           # bytes/s per link
    hbm_bytes: float


TPU_V5E = ChipSpec(
    name="tpu-v5e",
    peak_flops_bf16=197e12,
    hbm_bw=819e9,
    ici_link_bw=50e9,
    hbm_bytes=16 * 1024**3,
)

# The paper's units, through the same lens (per-unit).
SD865 = ChipSpec(
    name="sd865",
    peak_flops_bf16=1.2e12,      # Adreno 650 fp16 ~1.2 TFLOPS
    hbm_bw=34.1e9,               # LPDDR5 quad-channel
    ici_link_bw=0.125e9 * 0.903,  # 1 GbE PCB port at measured TCP eff.
    hbm_bytes=12 * 1024**3,
)

A40 = ChipSpec(
    name="a40",
    peak_flops_bf16=149.7e12,    # bf16 w/ sparsity off
    hbm_bw=696e9,
    ici_link_bw=8e9,             # PCIe4 x16 effective
    hbm_bytes=48 * 1024**3,
)

# The port's card: NVIDIA's H100 SXM5 data sheet, dense rates. bf16 on the
# tensor cores 989.4 TFLOP/s (``core/cluster.py::h100_sxm`` rounds it to
# 989), HBM3 3.35 TB/s. NVLink 4 is 18 links of 25 GB/s each way: the
# collective term divides a chip's wire bytes by one rate, so
# ``ici_link_bw`` here is the whole card's one-way NVLink rate, 450 GB/s,
# not one link's. ``hbm_bytes`` is ``total_memory`` as an H100 80GB HBM3
# reports it to torch (``chip_smoke.py`` prints it beside the card).
H100_SXM = ChipSpec(
    name="h100-sxm",
    peak_flops_bf16=989.4e12,
    hbm_bw=3.35e12,
    ici_link_bw=450e9,
    hbm_bytes=85017493504,     # NVIDIA H100 80GB HBM3, 700.00 W
)
