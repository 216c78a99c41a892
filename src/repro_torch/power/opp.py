"""Per-unit operating-point (OPP) tables — the frequency axis of the
power model.

The paper's energy proportionality argument (§5.2) is about *how many*
units run; real mobile SoCs add a second axis — *how fast* each runs.
A Snapdragon 865 exposes per-cluster DVFS operating points: each point
pairs a clock frequency with the minimum supply voltage that sustains
it, and dynamic power follows P ≈ P_idle + k·f·V². Because V itself
rises with f, the top of the table costs super-linearly more energy per
unit of work than the middle — which is what makes the wide-and-slow
(more units, low OPP) vs narrow-and-fast (fewer units, high OPP) Pareto
non-trivial.

Everything here is expressed *relative to the nominal point* so it
composes with the calibrated :class:`~repro_torch.core.cluster.UnitSpec`
wattages unchanged:

  * ``perf_scale``  = f / f_nom — service-rate multiplier;
  * ``power_scale`` = (f · V²) / (f_nom · V_nom²) — dynamic-power
    multiplier.

At the nominal OPP both scales are exactly 1.0 and
:func:`unit_power` reduces to ``UnitSpec.power`` — the power layer is
strictly additive by default.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

from repro_torch.core.cluster import UnitSpec


@dataclass(frozen=True)
class OperatingPoint:
    """One DVFS point: frequency + normalized voltage + derived scales."""

    freq_mhz: float
    volt: float          # supply voltage normalized to the nominal point
    perf_scale: float    # service-rate multiplier vs nominal (≈ f/f_nom)
    power_scale: float   # dynamic-power multiplier vs nominal (f·V²)


@dataclass(frozen=True)
class OPPTable:
    """An ascending-frequency tuple of operating points.

    ``nominal`` indexes the point the :class:`UnitSpec` wattages were
    calibrated at (``perf_scale == power_scale == 1.0``); governors and
    throttling move units up and down this table.
    """

    points: Tuple[OperatingPoint, ...]
    nominal: int

    def __post_init__(self) -> None:
        assert self.points, "OPP table needs at least one point"
        freqs = [p.freq_mhz for p in self.points]
        assert freqs == sorted(freqs), "OPP table must ascend in frequency"
        assert 0 <= self.nominal < len(self.points)
        nom = self.points[self.nominal]
        assert abs(nom.perf_scale - 1.0) < 1e-9 \
            and abs(nom.power_scale - 1.0) < 1e-9, \
            "the nominal OPP must carry unit perf/power scales"

    def __len__(self) -> int:
        return len(self.points)

    def __getitem__(self, i: int) -> OperatingPoint:
        return self.points[i]

    def __iter__(self) -> Iterator[OperatingPoint]:
        return iter(self.points)

    @property
    def lowest(self) -> int:
        return 0

    @property
    def highest(self) -> int:
        return len(self.points) - 1

    def clamp(self, idx: int) -> int:
        return max(0, min(len(self.points) - 1, int(idx)))


def unit_power(unit: UnitSpec, util: float, opp: OperatingPoint) -> float:
    """Unit power at ``util`` on ``opp``: the calibrated idle floor plus
    the dynamic swing scaled by the OPP's f·V² factor (P ≈ P_idle +
    k·f·V²). At the nominal OPP this is exactly ``unit.power(util)``."""
    u = min(max(util, 0.0), 1.0)
    return unit.p_idle \
        + (unit.p_peak - unit.p_idle) * opp.power_scale * (u ** unit.gamma)


# ---------------------------------------------------------------------------
# Builders.
# ---------------------------------------------------------------------------
def build_table(freqs_mhz: Sequence[float], volts: Sequence[float],
                nominal: Optional[int] = None) -> OPPTable:
    """Build a table from raw (frequency, voltage) pairs; scales are
    normalized to the ``nominal`` point (default: the highest)."""
    assert len(freqs_mhz) == len(volts) and freqs_mhz, \
        "need matching, non-empty freq/volt lists"
    n = len(freqs_mhz) - 1 if nominal is None else nominal
    f_nom, v_nom = float(freqs_mhz[n]), float(volts[n])
    pts = tuple(
        OperatingPoint(
            freq_mhz=float(f), volt=float(v) / v_nom,
            perf_scale=float(f) / f_nom,
            power_scale=(float(f) / f_nom) * (float(v) / v_nom) ** 2)
        for f, v in zip(freqs_mhz, volts))
    return OPPTable(points=pts, nominal=n)


def single_opp_table(freq_mhz: float = 2841.6) -> OPPTable:
    """The degenerate no-DVFS table: one nominal point. A pool configured
    with this behaves bit-for-bit like one with no power layer at all."""
    return OPPTable(points=(OperatingPoint(freq_mhz, 1.0, 1.0, 1.0),),
                    nominal=0)


# Snapdragon 865 prime-cluster (Kryo 585 Gold Prime) operating points.
# Frequencies are the kernel's freq-table steps; voltages follow the
# near-linear V(f) ramp of the 7 nm bin, normalized to the 2841.6 MHz
# point the paper's 8 W full-load calibration was measured at.
SD865_FREQS_MHZ = (844.8, 1420.8, 1804.8, 2227.2, 2841.6)
SD865_VOLTS = (0.65, 0.737, 0.80, 0.88, 1.0)


def sd865_opp_table() -> OPPTable:
    """The calibrated SD865 table (nominal = 2841.6 MHz, the point
    behind ``soc_cluster()``'s 8 W per-SoC peak)."""
    return build_table(SD865_FREQS_MHZ, SD865_VOLTS)


def opp_table_for_unit(unit: UnitSpec, n_points: int = 5,
                       f_min_frac: float = 0.4, v_min: float = 0.6,
                       f_nom_mhz: float = 1000.0) -> OPPTable:
    """Generic table builder for any :class:`UnitSpec` (a GPU's clock
    ladder, a TPU chip's SKU steps): ``n_points`` evenly-spaced
    frequencies from ``f_min_frac``·f_nom to f_nom, voltage ramping
    linearly from ``v_min`` to 1.0. The top point is nominal, so the
    unit's calibrated wattages are reproduced exactly there."""
    assert n_points >= 1 and 0.0 < f_min_frac <= 1.0 and 0.0 < v_min <= 1.0
    assert unit.p_peak > unit.p_idle, \
        f"{unit.name}: no dynamic power range to scale"
    if n_points == 1:
        return single_opp_table(f_nom_mhz)
    fracs = [f_min_frac + (1.0 - f_min_frac) * i / (n_points - 1)
             for i in range(n_points)]
    freqs = [f * f_nom_mhz for f in fracs]
    volts = [v_min + (1.0 - v_min) * (f - fracs[0]) / (1.0 - fracs[0])
             for f in fracs]
    return build_table(freqs, volts)
