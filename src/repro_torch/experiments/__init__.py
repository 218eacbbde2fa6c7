"""Declarative experiments: Scenario x Sweep x driver, everywhere.

The paper's taxonomy is a grid — mitigation policies x workloads x
platforms x QoS metrics.  This package makes each cell a one-line
declaration:

    from repro_torch.experiments import Scenario, WorkloadSpec, run, compare

    sc = Scenario(name="mine",
                  workload=WorkloadSpec("azure_like",
                                        {"horizon": 600.0,
                                         "num_functions": 20}),
                  policy="tiered_spes", seed=0)
    sim = run(sc, driver="sim")
    fleet = run(sc, driver="fleet")
    assert compare(sim, fleet).identical       # the calibration gate
    batch = run(sc, driver="batch")            # the card; device="cpu" asks for the CPU

Named cells live in the registry (``get("calib/tiered_spes")``), grids in
``Sweep``\\ s (``run_sweep("csf_table5")``), and everything is reachable
from the CLI: ``python -m repro_torch.experiments {list,run,sweep}``.
The ``engine`` and ``batch`` drivers run on the card unless the caller
passes ``device="cpu"``.
"""
from repro_torch.experiments.registry import (UnknownScenarioError, get, get_sweep,
                                              names, register, register_sweep,
                                              resolve, resolve_sweep, sweep_names)
from repro_torch.experiments.runner import (DRIVERS, LedgerDiff, build_trace,
                                            compare, run, run_summary, run_sweep,
                                            summarize)
from repro_torch.experiments.spec import (ClusterSpec, EngineSpec, Scenario,
                                          WorkloadSpec, derive_seed)
from repro_torch.experiments.sweep import AxisValue, Sweep

# importing the catalog populates the registry with the taxonomy grid
from repro_torch.experiments import catalog  # noqa: E402,F401  (registration side effect)

__all__ = [
    "Scenario", "WorkloadSpec", "ClusterSpec", "EngineSpec", "derive_seed",
    "AxisValue", "Sweep",
    "register", "register_sweep", "get", "get_sweep", "names",
    "sweep_names", "resolve", "resolve_sweep", "UnknownScenarioError",
    "DRIVERS", "run", "run_summary", "run_sweep", "summarize",
    "build_trace", "compare", "LedgerDiff",
]
