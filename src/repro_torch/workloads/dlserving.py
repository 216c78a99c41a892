"""DL-serving workload profiles (paper §5, Fig 11/12, Tables 5/7).

Latency/power reference points are the paper's measurements (Table 7
physical-SoC numbers where published); the executable side (benchmarks)
runs the actual JAX models on this host and scales through the
compute-ratio model to cross-check the shape of the comparisons.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ServingPoint:
    model: str
    precision: str            # fp32 | int8
    platform: str
    latency_ms: float         # batch-1 unless noted
    batch: int
    unit_power_w: float       # per serving unit at load
    units: int                # units per server

    @property
    def throughput(self) -> float:
        return 1000.0 / self.latency_ms * self.batch * self.units

    @property
    def samples_per_joule(self) -> float:
        return self.throughput / (self.unit_power_w * self.units)


# Paper Table 7 (physical SoC) + §5.1 text + A40/A100 figures (Fig 11).
PAPER_POINTS = [
    # SoC GPU / DSP (per-SoC; x60 for the cluster)
    ServingPoint("resnet-50", "fp32", "soc-gpu", 32.5, 1, 6.0, 60),
    ServingPoint("resnet-50", "int8", "soc-dsp", 8.8, 1, 4.0, 60),
    ServingPoint("resnet-152", "fp32", "soc-gpu", 100.9, 1, 6.0, 60),
    ServingPoint("resnet-152", "int8", "soc-dsp", 20.4, 1, 4.0, 60),
    ServingPoint("yolov5x", "fp32", "soc-gpu", 620.6, 1, 6.5, 60),
    ServingPoint("bert-base", "fp32", "soc-gpu", 93.0, 1, 6.0, 60),
    # Intel CPU (8-core container; x10 per server)
    ServingPoint("resnet-50", "fp32", "intel-cpu", 81.2, 1, 48.0, 10),
    ServingPoint("resnet-152", "fp32", "intel-cpu", 258.3, 1, 48.0, 10),
    ServingPoint("yolov5x", "fp32", "intel-cpu", 1121.3, 1, 48.0, 10),
    ServingPoint("bert-base", "fp32", "intel-cpu", 130.0, 1, 48.0, 10),
    # NVIDIA A40 (batch 64) / A100 (batch 64)
    ServingPoint("resnet-50", "fp32", "a40", 157.0, 64, 220.0, 8),
    ServingPoint("resnet-152", "fp32", "a40", 360.0, 64, 220.0, 8),
    ServingPoint("resnet-50", "fp32", "a100", 115.0, 64, 330.0, 1),
    ServingPoint("resnet-152", "fp32", "a100", 230.0, 64, 330.0, 1),
]


def point(model: str, precision: str, platform: str
          ) -> Optional[ServingPoint]:
    for p in PAPER_POINTS:
        if (p.model, p.precision, p.platform) == (model, precision,
                                                  platform):
            return p
    return None


# Key published ratios for validation (Fig 11b / §5.2 text).
PAPER_CLAIMS = {
    # SoC GPU resnet-50 fp32 vs Intel CPU: 7.09x; vs A40: 1.78x;
    # vs A100: 1.15x. DSP resnet-152 int8 vs Intel: 42x, vs A100: 1.5x.
    "r50_gpu_vs_intel": 7.09,
    "r50_gpu_vs_a40": 1.78,
    "r50_gpu_vs_a100": 1.15,
    "r152_dsp_vs_intel": 42.0,
    "max_tpe_vs_a40": 6.5,
    "light_load_vs_a100": 5.71,
}


# Host-measurable model set (executed by benchmarks/fig11): name ->
# (constructor module, flops estimate per sample).
EXECUTABLE_MODELS = {
    "resnet-50": 8.2e9,
    "resnet-152": 23.2e9,
    "yolov5x": 205e9 * 2 / 2,   # ~205 GMACs at 640x640 -> 410 GFLOPs? use half-res in bench
    "bert-base": 2 * 110e6 * 128,  # fwd, seq 128
}
