"""Policy interfaces — the taxonomy of Fig. 13 as composable components.

A :class:`PolicySuite` bundles one choice from each mitigation family:

  keepalive   CSF: when does a warm container scale to zero (τ), and which
              idle container is evicted first under memory pressure
  lifetime    CSF/CSL bridge: the graded warmth-tier ladder — *how* a
              container cools (warm → paused → snapshot-resident → dead)
              as a per-edge demotion schedule; a plain keep-alive TTL is
              the binary special case (one warm → dead edge)
  prewarm     CSF: proactive container preparation (periodic ping,
              histogram/EWMA/Markov/LSTM/RL predictors)
  placement   CSF: request→worker scheduling (CAS lifecycle-awareness)
  startup     CSL: how a cold start is shortened (snapshot restore, pause
              pool, image caching, partial dependency loading)

Every policy sees one ``Context`` protocol —
:class:`~repro.core.cluster.ClusterContext` — whether the cluster
underneath is the discrete-event simulator (``core/simulator.py``), the
live fleet (``repro.fleet``), or the synchronous serving router
(``serving/router.py``); all three drive the same
:class:`~repro.core.cluster.ClusterState` kernel.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, TYPE_CHECKING

from repro_torch.core.lifecycle import Container, FunctionSpec, WarmthTier

if TYPE_CHECKING:
    from repro_torch.core.cluster import ClusterContext

# one demotion-schedule edge: (seconds to dwell in the *current* tier,
# the tier to demote to when the dwell elapses)
TierEdge = Tuple[float, WarmthTier]


class KeepAlive:
    """Decides τ per container and the eviction order under pressure."""

    name = "base"

    def ttl(self, container: Container, ctx: "ClusterContext") -> float:
        raise NotImplementedError

    def evict_order(self, candidates: Sequence[Container],
                    ctx: "ClusterContext") -> List[Container]:
        """Least-valuable first.  Default: LRU."""
        return sorted(candidates, key=lambda c: c.last_used)

    def on_reuse(self, container: Container, ctx: "ClusterContext") -> None:
        pass


class Lifetime:
    """Graded container-lifetime policy: returns a *demotion schedule*.

    ``schedule`` answers, for a container that just went idle: how long
    does it dwell in each warmth tier before sliding down the ladder?
    The returned edges are consumed in order by the drivers (simulator
    and fleet identically), each edge re-armed only after the previous
    demotion actually fires; any reuse or promotion cancels the rest.

    ``[(60, PAUSED), (240, SNAPSHOT_READY), (1800, DEAD)]`` reads: stay
    warm 60 s, then freeze; stay frozen 240 s, then write the snapshot
    and drop to the disk tier; linger restorable for 1800 s, then die.
    """

    name = "lifetime"

    def observe(self, function: str, t: float) -> None:
        """Arrival feed (same stream prewarm policies see)."""

    def schedule(self, container: Container,
                 ctx: "ClusterContext") -> List[TierEdge]:
        raise NotImplementedError


class Prewarm:
    """Proactive warm-container preparation from invocation history."""

    name = "none"
    tick_interval: float = 1.0

    def observe(self, function: str, t: float) -> None:
        pass

    def decisions(self, t: float, ctx: "ClusterContext") -> List[str]:
        """Functions that should have (at least) one warm container *now*."""
        return []


class Placement:
    """Request routing across workers (the scheduler of §5.3.2).

    Worker selection is served from the kernel's free-capacity index
    (``ClusterContext.first_fit_worker`` / ``max_free_worker``), so the
    default policies stay O(log W) at thousands of workers instead of
    rescanning every worker per cold start."""

    name = "first-fit"

    def choose_container(self, function: str, ctx: "ClusterContext") -> Optional[Container]:
        warm = ctx.warm_idle(function)
        return warm[0] if warm else None

    def choose_worker(self, fn: FunctionSpec, ctx: "ClusterContext") -> Optional[int]:
        return ctx.first_fit_worker(fn.memory_mb)


@dataclass(frozen=True)
class Startup:
    """Cold-start-latency reduction settings (CSL half of the taxonomy)."""

    snapshot: bool = False            # vHive/Catalyzer/SEUSS restore path
    pause_pool_size: int = 0          # PCPM paused containers (generic)
    pause_pool_mb: float = 128.0      # footprint of a paused container
    deps_fraction: float = 1.0        # FaaSLight partial load (<1.0)
    first_run_penalty_frac: float = 0.0  # deferred-load cost on first exec
    img_cache: bool = False           # repeat spawns skip the image pull
                                      # (IMG_CACHED rung of the ladder)


@dataclass
class PolicySuite:
    name: str
    keepalive: KeepAlive
    prewarm: Optional[Prewarm] = None
    placement: Placement = field(default_factory=Placement)
    startup: Startup = field(default_factory=Startup)
    lifetime: Optional[Lifetime] = None   # graded ladder; None = binary TTL

    def describe(self) -> str:
        bits = [f"keepalive={self.keepalive.name}"]
        if self.lifetime:
            bits.append(f"lifetime={self.lifetime.name}")
        if self.prewarm:
            bits.append(f"prewarm={self.prewarm.name}")
        bits.append(f"placement={self.placement.name}")
        st = self.startup
        if st.snapshot:
            bits.append("snapshot")
        if st.pause_pool_size:
            bits.append(f"pause_pool={st.pause_pool_size}")
        if st.deps_fraction < 1.0:
            bits.append(f"faaslight={st.deps_fraction}")
        if st.img_cache:
            bits.append("img_cache")
        return f"{self.name}({', '.join(bits)})"
