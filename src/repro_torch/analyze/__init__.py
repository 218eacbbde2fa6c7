"""Post-hoc analysis toolkit over the per-invocation event log.

The pipeline mirrors the classic parse → stats → graphs layout:

  reader      load + schema-validate an ``events.jsonl`` file
  stats       join events into per-invocation records; latency-breakdown
              percentiles per phase/tier/function; cold-start attribution;
              tier-occupancy GB-s (cross-checkable against the QoSLedger)
  plots       dependency-free SVG emitters (container timeline, stacked
              phase breakdown, per-function Pareto scatter)
  calibrate   invert measured startup phases back into CostModel
              parameters + the sim-predicted vs measured fidelity report
  cli         ``python -m repro_torch.analyze <events.jsonl> [...]``

Everything consumes the one event schema from :mod:`repro_torch.core.events`,
so the same commands work on simulator, fleet, and real-engine logs.
"""
from repro_torch.analyze.calibrate import (fidelity_report, format_fidelity,
                                           measured_costs, write_calibration)
from repro_torch.analyze.reader import read_events
from repro_torch.analyze.stats import (InvocationStat, cold_attribution,
                                       invocations, phase_percentiles,
                                       serving_paths, tier_occupancy)

__all__ = [
    "read_events", "InvocationStat", "invocations", "phase_percentiles",
    "cold_attribution", "serving_paths", "tier_occupancy",
    "measured_costs", "fidelity_report", "format_fidelity",
    "write_calibration",
]
