"""Scheduling/placement policies (§5.3.2): CAS lifecycle-aware placement and
ENSURE-style latency-aware scaling."""
from __future__ import annotations

from typing import Optional

from repro_torch.core.lifecycle import Container, ContainerState, FunctionSpec
from repro_torch.core.policies.base import Placement, Prewarm


class CASPlacement(Placement):
    """Container-lifecycle-Aware Scheduling (Wu et al., SPE'22): prefer the
    worker that already holds a warm container for the function; among warm
    containers pick the one whose lifecycle stage is most advanced (most
    uses — best locality / JIT warmth); for cold placements pick the worker
    with the most free memory to reduce contention."""

    name = "cas"

    def choose_container(self, function: str, ctx) -> Optional[Container]:
        warm = ctx.warm_idle(function)
        if not warm:
            return None
        return max(warm, key=lambda c: (c.uses, c.last_used))

    def choose_worker(self, fn: FunctionSpec, ctx) -> Optional[int]:
        # best-fit from the kernel's free-capacity index: O(log W), same
        # semantics as the old scan (most free memory, ties to lowest id)
        w, free = ctx.max_free_worker()
        return w if free >= fn.memory_mb else None


class ENSUREScaling(Prewarm):
    """ENSURE (Suresh et al., ACSOS'20): queue-length-driven proactive
    scaling.  When a function's in-flight demand approaches its warm
    capacity, add containers *before* requests queue — expressed as a
    prewarm policy that requests extra warm containers."""

    name = "ensure"
    tick_interval = 0.25

    def __init__(self, headroom: float = 0.8):
        self.headroom = headroom
        self.seen = set()

    def observe(self, function: str, t: float) -> None:
        self.seen.add(function)

    def decisions(self, t: float, ctx) -> list:
        out = []
        for fn in self.seen:
            active = ctx.active_count(fn)
            warm = len(ctx.warm_idle(fn))
            queued = ctx.queued_count(fn)
            capacity = active + warm
            if capacity and (active + queued) / capacity >= self.headroom:
                out.append(fn)
            elif queued and not capacity:
                out.append(fn)
        return out
