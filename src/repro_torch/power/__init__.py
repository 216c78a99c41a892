"""``repro_torch.power`` — thermal-aware DVFS: the frequency axis of the
cluster power model.

Three pieces, composing with the runtime stack:

  * :mod:`repro_torch.power.opp` — per-unit operating-point tables
    (frequency → perf-scale, power via P ≈ P_idle + k·f·V²); a
    calibrated SD865 table plus a generic builder for any
    :class:`~repro_torch.core.cluster.UnitSpec`;
  * :mod:`repro_torch.power.thermal` — a discrete-time RC thermal network
    (SoC die → PCB group → rack inlet, fan curve on the shared rail)
    with trip-point throttling that forces hot units down the table;
  * :mod:`repro_torch.power.governor` — pluggable frequency policies
    (``fixed``, ``race-to-idle``, ``schedutil``, ``thermal-aware``)
    that compose with the activation-count policy in
    :class:`~repro_torch.runtime.policy.UnitGovernor`.

Attach a table (and optionally thermal params) to a runtime and pick a
governor per tenant::

    from repro_torch.power import (sd865_opp_table, ThermalParams,
                             SchedutilGovernor)
    from repro_torch.runtime import ClusterRuntime, ScalePolicy

    rt = ClusterRuntime(soc_cluster(), workload,
                        policy=ScalePolicy(freq_governor=SchedutilGovernor()),
                        opp_table=sd865_opp_table(),
                        thermal=ThermalParams())

With no table configured (the default) nothing changes: the power layer
is strictly additive.
"""
from repro_torch.power.governor import (GOVERNORS, FixedFreqGovernor, FreqContext,
                                  FreqGovernor, RaceToIdleGovernor,
                                  SchedutilGovernor, ThermalAwareGovernor)
from repro_torch.power.opp import (OperatingPoint, OPPTable, build_table,
                             opp_table_for_unit, sd865_opp_table,
                             single_opp_table, unit_power)
from repro_torch.power.thermal import (ThermalModel, ThermalParams,
                                 VectorThermalModel)

__all__ = [
    "OperatingPoint", "OPPTable", "build_table", "opp_table_for_unit",
    "sd865_opp_table", "single_opp_table", "unit_power",
    "ThermalModel", "ThermalParams", "VectorThermalModel",
    "FreqContext", "FreqGovernor", "FixedFreqGovernor",
    "RaceToIdleGovernor", "SchedutilGovernor", "ThermalAwareGovernor",
    "GOVERNORS",
]
