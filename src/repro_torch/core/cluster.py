"""The SoC-Cluster abstraction: a server/pod as a set of small units.

Calibrated to the paper's prototype (60x Snapdragon 865 in 2U, §2.2,
Table 1/4) and mapped onto the TPU deployment target (chip ≙ SoC,
ICI neighborhood ≙ PCB group, pod ≙ server). All downstream layers
(energy model, elastic scheduler, TCO) consume this description.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass(frozen=True)
class UnitSpec:
    """One compute unit (a mobile SoC, a GPU, or a TPU chip)."""

    name: str
    # power (watts)
    p_off: float
    p_idle: float
    p_peak: float
    # proportionality exponent: P(u) = idle + (peak - idle) * u**gamma.
    # gamma ~ 1 is proportional (mobile SoCs); gamma < 1 is the GPU-style
    # "jumps to high power at first request" behavior the paper measures.
    gamma: float = 1.0
    # nominal compute (used by the scheduler's capacity model)
    peak_tflops: float = 0.0
    mem_gb: float = 0.0

    def power(self, util: float) -> float:
        u = min(max(util, 0.0), 1.0)
        return self.p_idle + (self.p_peak - self.p_idle) * (u ** self.gamma)


@dataclass(frozen=True)
class ClusterSpec:
    """A server/pod: n units + shared infrastructure."""

    name: str
    unit: UnitSpec
    n_units: int
    p_shared: float              # fans, switch boards, BMC / host, links
    group_size: int = 1          # units per PCB / ICI neighborhood
    net_unit_gbps: float = 0.0   # per-unit network bandwidth
    net_shared_gbps: float = 0.0  # server/pod uplink

    def groups(self) -> List[List[int]]:
        return [list(range(i, min(i + self.group_size, self.n_units)))
                for i in range(0, self.n_units, self.group_size)]

    def power(self, active_units: int, util: float = 1.0,
              idle_units_off: bool = False) -> float:
        """Server power with `active_units` at `util`; the rest idle (or
        powered off — the SoC Cluster's per-SoC power gating, §5.2)."""
        active = min(active_units, self.n_units)
        rest = self.n_units - active
        p_rest = rest * (self.unit.p_off if idle_units_off
                         else self.unit.p_idle)
        return self.p_shared + active * self.unit.power(util) + p_rest

    @property
    def peak_power(self) -> float:
        return self.power(self.n_units, 1.0)


# ---------------------------------------------------------------------------
# Calibrated platforms.
# ---------------------------------------------------------------------------
def soc_cluster() -> ClusterSpec:
    """The paper's prototype: 60x SD865, 2U. Calibration: measured avg peak
    589 W (Table 4) = 60 x ~8 W (SoC full load) + ~109 W shared (8 fans,
    ESB, 12 PCBs, BMC); per-SoC idle ~0.6 W (Android suspended)."""
    return ClusterSpec(
        name="soc-cluster",
        unit=UnitSpec("sd865", p_off=0.0, p_idle=0.6, p_peak=8.0,
                      gamma=1.0, peak_tflops=1.2, mem_gb=12.0),
        n_units=60,
        p_shared=109.0,
        group_size=5,                 # 5 SoCs per PCB
        net_unit_gbps=1.0,            # PCB ethernet
        net_shared_gbps=20.0,         # dual SFP+ uplink
    )


def edge_server_cpu() -> ClusterSpec:
    """Traditional edge server, CPU only (Intel Xeon Gold, Table 1).
    Avg peak 633 W (Table 4); 8-core container ≙ one schedulable unit
    (the paper's Docker partitioning, §3 Setups)."""
    return ClusterSpec(
        name="edge-cpu",
        unit=UnitSpec("xeon-8core", p_off=0.0, p_idle=15.0, p_peak=48.0,
                      gamma=1.0, peak_tflops=0.6, mem_gb=76.0),
        n_units=10,
        p_shared=153.0,
        group_size=10,
        net_shared_gbps=20.0,
    )


def edge_server_gpu() -> ClusterSpec:
    """Traditional edge server GPU pool: 8x NVIDIA A40. Measured avg peak
    1231 W total (Table 4) => ~(1231-633)/8 ≈ 75 W avg per GPU during
    transcoding; DL serving drives them to ~220 W. High idle floor + sub-
    linear gamma reproduce the paper's poor proportionality (Fig 7/12)."""
    return ClusterSpec(
        name="edge-a40",
        unit=UnitSpec("a40", p_off=0.0, p_idle=55.0, p_peak=220.0,
                      gamma=0.45, peak_tflops=37.4, mem_gb=48.0),
        n_units=8,
        p_shared=633.0,   # host CPU/DRAM/fans (the CPU server underneath)
        group_size=1,
        net_shared_gbps=20.0,
    )


def a100_server() -> ClusterSpec:
    """High-end comparison GPU (GCP A100, §3 Hardware)."""
    return ClusterSpec(
        name="a100",
        unit=UnitSpec("a100", p_off=0.0, p_idle=60.0, p_peak=330.0,
                      gamma=0.45, peak_tflops=156.0, mem_gb=40.0),
        n_units=1,
        p_shared=250.0,
        group_size=1,
        net_shared_gbps=100.0,
    )


def tpu_v5e_pod(n_chips: int = 256) -> ClusterSpec:
    """The deployment target: one v5e pod as a 'SoC Cluster' of chips."""
    return ClusterSpec(
        name=f"tpu-v5e-{n_chips}",
        unit=UnitSpec("v5e", p_off=0.0, p_idle=60.0, p_peak=170.0,
                      gamma=0.9, peak_tflops=197.0, mem_gb=16.0),
        n_units=n_chips,
        p_shared=0.06 * n_chips * 170.0,   # hosts/fans amortized
        group_size=4,                       # one host board
        net_unit_gbps=400.0,                # ~50 GB/s/link ICI
        net_shared_gbps=800.0,              # DCN per pod
    )


# Shares of the one card in :func:`h100_sxm`: 8, as the JAX launcher's
# ``tpu_v5e_pod(8)``, so that both launchers gate the same pool size in
# the same groups of 4 and give the same activation telemetry.
H100_SHARES = 8


def h100_sxm() -> ClusterSpec:
    """One NVIDIA H100 SXM card modelled as ``H100_SHARES`` equal shares.
    Each active share admits one decode slot under
    :class:`~repro_torch.runtime.LMServingWorkload`'s cap, as each active
    v5e chip does in the JAX launcher. Per share: ``p_peak`` is 700 W / n
    (the data sheet's maximum TDP, which is also the power limit the card
    reports), ``peak_tflops`` 989 / n (dense bf16 on the tensor cores) and
    ``mem_gb`` 80 / n. ``p_idle`` and ``gamma`` are assumed, not measured:
    they follow :func:`a100_server`, the idle floor at its 60/330 share of
    peak and gamma 0.45. ``p_off = p_idle``: a share of a powered card
    cannot be gated off, the cost the paper sets against the SoC
    Cluster's per-SoC gating. ``p_shared`` is 0: the host is not
    modelled. Four shares to a group, as in :func:`tpu_v5e_pod`."""
    n = H100_SHARES
    p_peak = 700.0 / n
    p_idle = p_peak * 60.0 / 330.0
    return ClusterSpec(
        name=f"h100-sxm-{n}",
        unit=UnitSpec("h100-share", p_off=p_idle, p_idle=p_idle,
                      p_peak=p_peak, gamma=0.45,
                      peak_tflops=989.0 / n, mem_gb=80.0 / n),
        n_units=n,
        p_shared=0.0,
        group_size=4,
    )


PLATFORMS = {
    "soc-cluster": soc_cluster,
    "edge-cpu": edge_server_cpu,
    "edge-a40": edge_server_gpu,
    "a100": a100_server,
    "tpu-v5e": tpu_v5e_pod,
}
