"""Keep-alive / eviction policies (CSF reduction, §5.3.2).

* :class:`FixedTTL` — the provider default (AWS/GCF-style fixed τ).
* :class:`GreedyDualKeepAlive` — FaasCache (Fuerst & Sharma, ASPLOS'21):
  keep-alive as a GreedyDual-Size-Frequency cache. Each warm container gets
  priority = clock + freq × cost / size; evictions take the lowest priority
  and advance the clock to it.  TTL is effectively unbounded — containers
  die only under memory pressure.
* :class:`LCS` — LRU warm-container approach (Sethi et al., ICDCN'23):
  a bounded warm pool per cluster; least-recently-used container is
  reclaimed when the pool overflows (expressed here as eviction order +
  a long TTL).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

from repro_torch.core.lifecycle import Container
from repro_torch.core.policies.base import KeepAlive


class FixedTTL(KeepAlive):
    """Provider-default keep-warm window (τ)."""

    def __init__(self, ttl_s: float = 600.0):
        self.ttl_s = ttl_s
        self.name = f"fixed_ttl({ttl_s:g}s)"

    def ttl(self, container: Container, ctx) -> float:
        return self.ttl_s


class GreedyDualKeepAlive(KeepAlive):
    """FaasCache: GreedyDual-Size-Frequency keep-alive."""

    name = "greedy_dual"

    def __init__(self):
        self.clock = 0.0
        self.freq: Dict[str, int] = defaultdict(int)

    def ttl(self, container: Container, ctx) -> float:
        return float("inf")           # pressure-driven only

    def _priority(self, c: Container, ctx) -> float:
        fn = ctx.functions[c.function]
        cost = ctx.cost_model.breakdown(fn).total
        size = max(fn.memory_mb, 1.0)
        return self.clock + self.freq[c.function] * cost / size

    def on_reuse(self, container: Container, ctx) -> None:
        self.freq[container.function] += 1

    def evict_order(self, candidates: Sequence[Container], ctx) -> List[Container]:
        ordered = sorted(candidates, key=lambda c: self._priority(c, ctx))
        if ordered:
            self.clock = self._priority(ordered[0], ctx)
        return ordered


class LCS(KeepAlive):
    """LRU warm-container scheme with a bounded warm-pool budget."""

    def __init__(self, pool_budget_mb: float = 8192.0, ttl_s: float = 3600.0):
        self.pool_budget_mb = pool_budget_mb
        self.ttl_s = ttl_s
        self.name = f"lcs(lru,{pool_budget_mb:g}MB)"

    def ttl(self, container: Container, ctx) -> float:
        # enforce budget: if warm pool over budget, shortest-possible TTL for
        # the LRU tail (the cluster re-asks on every idle transition).  The
        # pool footprint comes from the kernel's running warm-idle counter
        # (which already includes ``container`` — it transitions to
        # WARM_IDLE before the TTL is asked for — counted twice here to
        # preserve the pre-kernel budget semantics); only the LRU pick
        # still walks the warm set.
        used = ctx.warm_idle_mb() + container.memory_mb
        if used > self.pool_budget_mb:
            lru = min(ctx.all_warm_idle() + [container],
                      key=lambda c: c.last_used)
            if lru.id == container.id:
                return 0.0
        return self.ttl_s
