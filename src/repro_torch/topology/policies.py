"""Offloading policies — where should this request run?

The faas-offloading-sim policy family over the repo's cluster kernel:

  always_local    never leave the ingress node (edge-only baseline)
  always_cloud    ship everything to the last node tier (cloud baseline)
  local_first     serve at the ingress if it can (warm container, free
                  concurrency slot, promotable resident, or room to cold
                  start); otherwise the first other node that can, else
                  the last tier (basic offloading)
  greedy          per-request expected-response-time minimizer: for every
                  node, score = network delay from the ingress + expected
                  startup there (0 if warm, promote edge if a demoted
                  resident exists, cold estimate otherwise, plus an
                  eviction penalty when the node is full) + execution
                  estimate; route to the argmin
  probabilistic   per-QoS-class routing probabilities, re-solved every
                  ``update_interval_s`` from EWMA arrival-rate estimates
                  against per-node service-capacity budgets (the
                  faas-offloading-sim periodic-LP idiom, solved here by
                  deterministic greedy water-filling); requests then
                  sample a node from their class's distribution

Every policy is deterministic given (scenario seed, arrival sequence), so
the scalar simulator and the fleet driver make identical routing
decisions — that is what lets ``calib/topo_basic`` hold sim-vs-fleet
*event-sequence* identity through the topology layer.

Policies see the cluster only through :class:`OffloadContext` /
:class:`NodeView` — read-only probes over each node's
:class:`~repro_torch.core.cluster.ClusterState` plus the network model — never
the drivers themselves.
"""
from __future__ import annotations

import random
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.core.costmodel import CostModel
from repro_torch.topology.spec import TopologySpec


class NodeView:
    """Read-only offload-decision probes over one node's kernel state."""

    __slots__ = ("name", "state", "suite", "cost_model")

    def __init__(self, name: str, state, suite, cost_model: CostModel):
        self.name = name
        self.state = state
        self.suite = suite
        self.cost_model = cost_model

    def warm_available(self, fn_name: str) -> bool:
        """A request arriving now would start executing immediately."""
        return (bool(self.state.warm_idle(fn_name))
                or self.state.free_slot(fn_name) is not None)

    def promotable(self, fn_name: str) -> bool:
        c = self.state.best_resident(fn_name)
        return c is not None and self.state.can_promote(c)

    def fits(self, fn_name: str) -> bool:
        """Room for a fresh container without evicting anything."""
        fn = self.state.functions[fn_name]
        return self.state.first_fit_worker(fn.memory_mb) is not None

    def cold_estimate(self, fn_name: str) -> float:
        fn = self.state.functions[fn_name]
        img = getattr(self.suite.startup, "img_cache", False)
        tier = self.state.spawn_tier(fn_name, img_cache=img)
        return self.cost_model.promote_breakdown(fn, tier).total

    def startup_estimate(self, fn_name: str) -> float:
        """Expected seconds before execution could begin on this node."""
        if self.warm_available(fn_name):
            return 0.0
        c = self.state.best_resident(fn_name)
        if c is not None and self.state.can_promote(c):
            fn = self.state.functions[fn_name]
            return self.cost_model.promote_breakdown(fn, c.tier).total
        return self.cold_estimate(fn_name)

    def exec_estimate(self, fn_name: str) -> float:
        return self.cost_model.exec_time(self.state.functions[fn_name])

    def service_rate_rps(self, mean_exec_s: float) -> float:
        """Crude node throughput budget: concurrency slots over the mean
        execution time, scaled by worker speeds."""
        if mean_exec_s <= 0.0:
            return float("inf")
        speed = sum(self.state.worker_speed)
        return max(speed, 1e-9) / mean_exec_s


class OffloadContext:
    """What an offloading policy sees: per-node views + the network."""

    __slots__ = ("topo", "views", "now")

    def __init__(self, topo: TopologySpec, views: "Dict[str, NodeView]"):
        self.topo = topo
        self.views = views
        self.now = 0.0

    @property
    def ingress(self) -> str:
        return self.topo.ingress_node

    @property
    def node_names(self) -> Tuple[str, ...]:
        return self.topo.node_names

    def view(self, node: str) -> NodeView:
        return self.views[node]

    def net_delay(self, dst: str, src: Optional[str] = None) -> float:
        """RTT + payload transfer from ``src`` (default: ingress)."""
        a = self.ingress if src is None else src
        rtt, xfer = self.topo.network.delay(a, dst, self.topo.payload_kb)
        return rtt + xfer

    def response_estimate(self, node: str, fn_name: str, *,
                          evict_penalty: float = 1.0) -> float:
        """The greedy policy's score: network + startup + execution, with
        a penalty when placing here would evict resident containers
        (``evict_penalty`` x the cold estimate — the future cold start the
        eviction is likely to cause)."""
        v = self.views[node]
        score = (self.net_delay(node) + v.startup_estimate(fn_name)
                 + v.exec_estimate(fn_name))
        if (not v.warm_available(fn_name) and not v.promotable(fn_name)
                and not v.fits(fn_name)):
            score += evict_penalty * v.cold_estimate(fn_name)
        return score


class OffloadingPolicy:
    """Base: route one classified invocation to a node name."""

    name = "?"

    def observe(self, function: str, qos_class: str, t: float) -> None:
        """Arrival feed (before routing) — estimators hook in here."""

    def choose(self, function: str, qos_class: str,
               ctx: OffloadContext) -> str:
        raise NotImplementedError


class AlwaysLocal(OffloadingPolicy):
    name = "always_local"

    def choose(self, function, qos_class, ctx):
        return ctx.ingress


class AlwaysRemote(OffloadingPolicy):
    """Everything to one remote tier (default: the last node = cloud)."""

    name = "always_cloud"

    def __init__(self, target: Optional[str] = None):
        self.target = target

    def choose(self, function, qos_class, ctx):
        return self.target if self.target is not None else ctx.node_names[-1]


class LocalFirst(OffloadingPolicy):
    """Basic offloading: stay home unless the ingress cannot serve."""

    name = "local_first"

    def choose(self, function, qos_class, ctx):
        ing = ctx.view(ctx.ingress)
        if (ing.warm_available(function) or ing.promotable(function)
                or ing.fits(function)):
            return ctx.ingress
        others = [n for n in ctx.node_names if n != ctx.ingress]
        for n in others:
            if (ctx.view(n).warm_available(function)
                    or ctx.view(n).promotable(function)):
                return n
        for n in others:
            if ctx.view(n).fits(function):
                return n
        return ctx.node_names[-1]


class GreedyOffload(OffloadingPolicy):
    """Expected-response-time argmin: warm-hit availability per node
    weighed against the network price of getting there."""

    name = "greedy"

    def __init__(self, evict_penalty: float = 1.0):
        self.evict_penalty = evict_penalty

    def choose(self, function, qos_class, ctx):
        best, best_score = ctx.node_names[0], float("inf")
        for n in ctx.node_names:
            score = ctx.response_estimate(
                n, function, evict_penalty=self.evict_penalty)
            if score < best_score - 1e-12:
                best, best_score = n, score
        return best


class ProbabilisticOffload(OffloadingPolicy):
    """Per-class routing distributions, periodically re-solved.

    Every ``update_interval_s`` the policy re-estimates per-class arrival
    rates (EWMA over the last window's counts, weight ``alpha``) and
    re-solves the class -> node distribution: classes in descending
    arrival-weight order water-fill the nodes in ascending
    (network + startup) score order, each node capped by a service-rate
    budget, so heavy classes claim the cheap capacity first and overflow
    is pushed to the next tier.  Requests then *sample* their class's
    distribution with a seeded RNG — the draw sequence follows the
    arrival sequence, so two drivers replaying one trace make identical
    picks.  Before the first re-solve it routes like ``local_first``.
    """

    name = "probabilistic"

    def __init__(self, update_interval_s: float = 60.0, alpha: float = 0.3,
                 seed: int = 0, class_weights: Optional[Mapping[str, float]]
                 = None):
        self.update_interval_s = max(1e-9, update_interval_s)
        self.alpha = alpha
        self.rng = random.Random(seed)
        self.class_weights = dict(class_weights or {})
        self._window_counts: Dict[str, int] = {}
        self._rate_est: Dict[str, float] = {}
        self._probs: Dict[str, List[Tuple[str, float]]] = {}
        self._next_update = self.update_interval_s
        self._fallback = LocalFirst()

    def observe(self, function, qos_class, t):
        self._window_counts[qos_class] = \
            self._window_counts.get(qos_class, 0) + 1

    def _class_order(self) -> List[str]:
        """Descending arrival weight, ties by name — premium first."""
        seen = set(self._rate_est) | set(self.class_weights)
        return sorted(seen,
                      key=lambda c: (-self.class_weights.get(c, 0.0), c))

    def _resolve(self, ctx: OffloadContext) -> None:
        w = self.update_interval_s
        for c in set(self._window_counts) | set(self._rate_est):
            inst = self._window_counts.get(c, 0) / w
            prev = self._rate_est.get(c)
            self._rate_est[c] = inst if prev is None \
                else self.alpha * inst + (1 - self.alpha) * prev
        self._window_counts.clear()

        fns = sorted(ctx.view(ctx.ingress).state.functions)
        scores: Dict[str, float] = {}
        caps: Dict[str, float] = {}
        for n in ctx.node_names:
            v = ctx.view(n)
            ests = [v.startup_estimate(f) for f in fns]
            execs = [v.exec_estimate(f) for f in fns]
            mean_start = sum(ests) / len(ests) if ests else 0.0
            mean_exec = sum(execs) / len(execs) if execs else 0.0
            scores[n] = ctx.net_delay(n) + mean_start + mean_exec
            caps[n] = v.service_rate_rps(mean_exec)

        order = sorted(ctx.node_names, key=lambda n: (scores[n], n))
        remaining = dict(caps)
        self._probs = {}
        for c in self._class_order():
            demand = self._rate_est.get(c, 0.0)
            alloc: List[Tuple[str, float]] = []
            if demand <= 0.0:
                self._probs[c] = [(order[0], 1.0)]
                continue
            left = demand
            for n in order:
                take = min(left, remaining[n])
                if take > 0.0:
                    alloc.append((n, take / demand))
                    remaining[n] -= take
                    left -= take
                if left <= 0.0:
                    break
            if left > 0.0:
                # over-capacity residue queues at the cheapest tier
                alloc.append((order[0], left / demand))
            self._probs[c] = alloc

    def choose(self, function, qos_class, ctx):
        while ctx.now >= self._next_update:
            self._resolve(ctx)
            self._next_update += self.update_interval_s
        dist = self._probs.get(qos_class)
        if not dist:
            return self._fallback.choose(function, qos_class, ctx)
        u = self.rng.random()
        acc = 0.0
        for node, p in dist:
            acc += p
            if u < acc:
                return node
        return dist[-1][0]


OFFLOAD_POLICIES = ("always_local", "always_cloud", "local_first",
                    "greedy", "probabilistic")


def make_policy(topo: TopologySpec, *, seed: int = 0,
                class_weights: Optional[Mapping[str, float]] = None
                ) -> OffloadingPolicy:
    """Instantiate ``topo.offload`` (seeded; parameters from the spec)."""
    name = topo.offload
    if name == "always_local":
        return AlwaysLocal()
    if name == "always_cloud":
        return AlwaysRemote()
    if name == "local_first":
        return LocalFirst()
    if name == "greedy":
        return GreedyOffload()
    if name == "probabilistic":
        return ProbabilisticOffload(
            update_interval_s=topo.update_interval_s,
            alpha=topo.arrival_alpha, seed=seed,
            class_weights=class_weights)
    raise ValueError(f"unknown offload policy {name!r}; "
                     f"one of {OFFLOAD_POLICIES}")
