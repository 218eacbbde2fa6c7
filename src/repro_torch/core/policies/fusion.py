"""Function fusion (CSL reduction, Lee et al. Sensors'21): merge sequential
chain stages into one deployable function, eliminating every downstream
cold start by construction (one container, one compile).

Implemented as a *trace transform*: invocations carrying a chain are
rewritten to a fused function whose package is the union of stage packages
and whose execution time is the sum of stage times.  The real-engine analogue
(serving/engine.py: ``fuse_bundles``) composes the model stages into a single
jitted program — one XLA compile instead of N.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from repro_torch.core.lifecycle import FunctionSpec
from repro_torch.core.workload import Invocation, Trace


def fuse_chain_specs(stages: Sequence[FunctionSpec], name: str) -> FunctionSpec:
    return FunctionSpec(
        name=name,
        package_mb=sum(s.package_mb for s in stages),
        memory_mb=max(s.memory_mb for s in stages),
        runtime=stages[0].runtime,
        exec_time_s=sum(s.exec_time_s for s in stages),
        compile_cost=sum(s.compile_cost for s in stages) * 0.9,  # one fused
        # program compiles slightly cheaper than N separate ones (shared
        # fusion across stage boundaries) — measured in bench_csl.py
    )


def apply_fusion(trace: Trace) -> Trace:
    """Rewrite chained invocations into fused single invocations."""
    fused_specs: Dict[str, FunctionSpec] = dict(trace.functions)
    new_inv: List[Invocation] = []
    for inv in trace.invocations:
        if not inv.chain:
            new_inv.append(inv)
            continue
        stages = [trace.functions[inv.function]] + [
            trace.functions[c] for c in inv.chain]
        fname = "fused__" + "_".join(s.name for s in stages)
        if fname not in fused_specs:
            fused_specs[fname] = fuse_chain_specs(stages, fname)
        new_inv.append(Invocation(inv.time, fname))
    return Trace(new_inv, fused_specs, trace.horizon)
