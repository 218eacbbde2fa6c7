"""The topology orchestrator: one cluster kernel per node, one router.

``run_topology(scenario, driver)`` runs an edge–cloud scenario by
instantiating one sub-driver per node tier — a
:class:`~repro_torch.core.simulator.Simulator` (``driver="sim"``) or a
:class:`~repro_torch.fleet.loadgen.FleetRunner` (``driver="fleet"``), each over
its OWN :class:`~repro_torch.core.cluster.ClusterState` kernel shaped by the
node's ``ClusterSpec`` — and interleaving them under one global virtual
clock.  The orchestration loop is *shared* between the two drivers: it
pops the globally-earliest pending event (the next trace arrival, or any
node's next internal event), routes arrivals through the QoS classifier
and the offloading policy, and injects them into the chosen node after
the network delay.  Because routing state (policy RNG, EWMA windows,
QoS draws) lives here — outside either sub-driver — both drivers see
byte-identical routing decisions, which is what lets ``calib/topo_basic``
hold sim-vs-fleet *event-sequence* identity through the topology layer.

End-to-end latency = network RTT + payload transfer + (cold/warm startup
+ queue + execution at the serving node): the injected request keeps its
original ingress arrival stamp, so the network price lands in the same
latency distributions every ledger consumer already reads.  Chain
successors execute on the node that ran their predecessor (locality-
preserving; re-offloading mid-chain would pay the payload transfer again
without a fresh routing signal).

Event streams: each node's kernel events are stamped with a ``node``
annotation via :class:`NodeEventLog`; the router itself emits one
``offload`` event per external arrival at ingress time.  Container ids
are offset per node (``CID_STRIDE``) so cids are globally unique and
identical across drivers.

Scope: topology runs need a materialized trace (streamed sources raise)
and support the ``sim`` and ``fleet`` drivers; ``batch`` and ``engine``
raise in the runner.  The fleet's per-function-queue-vs-global-FIFO
divergence under sustained memory pressure (see ``fleet/loadgen.py``)
applies per node, so identity cells must stay clear of pressure — same
contract as the flat calib cells.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

from repro_torch.core.events import EventLog
from repro_torch.core.metrics import QoSLedger, _pct
from repro_torch.core.workload import Trace
from repro_torch.topology.policies import (NodeView, OffloadContext, make_policy)
from repro_torch.topology.qos import assign_class, class_names
from repro_torch.topology.spec import TopologySpec

# per-node container-id offset: cids stay globally unique and identical
# across drivers (each node's kernel counts up from its own base)
CID_STRIDE = 1_000_000


class NodeEventLog(EventLog):
    """A node's view of the shared event log: every emission is appended
    to the PARENT log with a ``node`` annotation, so one merged,
    time-ordered stream carries all nodes (and ``diff_events`` checks
    routing identity for free)."""

    __slots__ = ("_parent", "_node")

    def __init__(self, parent: EventLog, node: str):
        super().__init__()
        self._parent = parent
        self._node = node

    def emit(self, kind: str, t: float, **fields) -> None:
        self._parent.emit(kind, t, node=self._node, **fields)


@dataclass
class TopologyLedger:
    """Per-node :class:`QoSLedger`\\ s plus the global merged view.

    ``summary()`` returns the merged ledger's flat schema extended with
    deterministic per-node (``node:<name>:<field>``) and per-QoS-class
    (``class:<name>:<field>``) breakdowns — every node and every class
    from the spec gets its keys even at zero traffic, so two drivers'
    summaries always share a keyset and ``compare()`` stays a strict
    schema check.  Per-class attribution is recomputed from the request
    records via the same pure :func:`assign_class` hash the router used,
    so class totals sum to the global totals *exactly*.
    """

    merged: QoSLedger
    per_node: Dict[str, QoSLedger]
    node_names: Tuple[str, ...]
    classes: Mapping[str, float]
    class_seed: int
    offload_counts: Dict[str, int] = field(default_factory=dict)
    net_overhead_s: float = 0.0
    routed: int = 0                     # external arrivals routed
    offloaded: int = 0                  # routed off the ingress node
    horizon: float = 0.0

    def summary(self, *, sla_latency_s: Optional[float] = None
                ) -> Dict[str, float]:
        out = self.merged.summary(sla_latency_s=sla_latency_s)
        out["offloaded_fraction"] = (self.offloaded / self.routed
                                     if self.routed else 0.0)
        out["net_overhead_mean_s"] = (self.net_overhead_s / self.routed
                                      if self.routed else 0.0)
        for name in self.node_names:
            s = self.per_node[name].summary()
            out[f"node:{name}:requests"] = s["requests"]
            out[f"node:{name}:cold_starts"] = s["cold_starts"]
            out[f"node:{name}:latency_mean_s"] = s["latency_mean_s"]
            out[f"node:{name}:idle_gb_s"] = s["idle_gb_s"]
            out[f"node:{name}:offloads"] = float(
                self.offload_counts.get(name, 0))
        lat_by_class: Dict[str, List[float]] = {
            c: [] for c in class_names(self.classes)}
        cold_by_class: Dict[str, int] = {
            c: 0 for c in class_names(self.classes)}
        for r in self.merged.records:
            c = assign_class(self.classes, self.class_seed,
                             r.function, r.arrival)
            lat_by_class[c].append(r.latency)
            cold_by_class[c] += r.cold
        for c in class_names(self.classes):
            lats = sorted(lat_by_class[c])
            out[f"class:{c}:requests"] = float(len(lats))
            out[f"class:{c}:cold_starts"] = float(cold_by_class[c])
            out[f"class:{c}:latency_mean_s"] = (sum(lats) / len(lats)
                                               if lats else float("nan"))
            out[f"class:{c}:latency_p95_s"] = _pct(lats, 0.95)
        return out


def _merge_ledgers(per_node: Dict[str, QoSLedger],
                   horizon: float) -> QoSLedger:
    m = QoSLedger(horizon=horizon)
    for led in per_node.values():
        m.records.extend(led.records)
        m.idle_gb_s += led.idle_gb_s
        for tier, v in led.idle_gb_s_by_tier.items():
            m.idle_gb_s_by_tier[tier] = \
                m.idle_gb_s_by_tier.get(tier, 0.0) + v
        m.exec_gb_s += led.exec_gb_s
        m.containers_launched += led.containers_launched
        m.promotions += led.promotions
        m.demotions += led.demotions
        m.dropped += led.dropped
        m.cluster_capacity_gb += led.cluster_capacity_gb
        m._busy_gb_s += led._busy_gb_s
    m.records.sort(key=lambda r: (r.arrival, r.function, r.start, r.end))
    return m


class _SimNode:
    """One node tier driven by the discrete-event simulator."""

    def __init__(self, name: str, trace: Trace, suite, cost_model, cluster,
                 events: Optional[EventLog]):
        from repro_torch.core.simulator import SimConfig, Simulator
        cfg = SimConfig(num_workers=cluster.num_workers,
                        worker_memory_mb=cluster.worker_memory_mb,
                        worker_speed=cluster.worker_speed)
        self.name = name
        self.sim = Simulator(trace, suite, cost_model, cfg, events=events)
        self.state = self.sim.state
        self.suite = suite
        self.ledger = self.sim.ledger

    def start(self):
        self.sim.start()

    def next_time(self) -> float:
        return self.sim.next_time()

    def step(self):
        self.sim.step()

    def inject(self, t: float, function: str, arrival: float, chain=()):
        from repro_torch.core.workload import Invocation
        self.sim.inject(t, Invocation(t, function, chain=tuple(chain)),
                        arrival=arrival)

    def finish(self) -> QoSLedger:
        return self.sim.finish()


class _FleetNode:
    """One node tier driven by the concurrent fleet on a virtual clock."""

    def __init__(self, name: str, trace: Trace, suite, cost_model, cluster,
                 seed: int, events: Optional[EventLog]):
        from repro_torch.fleet.loadgen import FleetConfig, FleetRunner
        cfg = FleetConfig(num_workers=cluster.num_workers,
                          worker_memory_mb=cluster.worker_memory_mb,
                          worker_speed=cluster.worker_speed,
                          slots_per_replica=cluster.slots_per_replica,
                          max_batch=cluster.max_batch,
                          slo_latency_s=cluster.admission_slo_s,
                          seed=seed)
        self.name = name
        self.runner = FleetRunner(trace, suite, cost_model=cost_model,
                                  cfg=cfg, events=events)
        self.state = self.runner.state
        self.suite = suite
        self.ledger = self.runner.ledger

    def start(self):
        self.runner.start()

    def next_time(self) -> float:
        return self.runner.next_time()

    def step(self):
        self.runner.step()

    def inject(self, t: float, function: str, arrival: float, chain=()):
        self.runner.inject(t, function, arrival, chain=chain)

    def finish(self) -> QoSLedger:
        return self.runner.finish()


def run_topology(sc, driver: str, *, cost_model=None,
                 events: Optional[EventLog] = None) -> TopologyLedger:
    """Run a topology scenario under ``driver`` ("sim" or "fleet")."""
    topo: TopologySpec = sc.topology
    if topo is None:
        raise ValueError(f"scenario {sc.name!r} has no topology")
    if driver not in ("sim", "fleet"):
        raise ValueError(
            f"topology scenarios support driver='sim' or 'fleet', "
            f"not {driver!r}")
    from repro_torch.experiments.runner import build_trace
    trace = build_trace(sc)
    if not isinstance(trace, Trace):
        raise ValueError(
            "topology scenarios need a materialized Trace; streamed "
            f"sources are not supported (workload "
            f"{sc.workload.generator!r})")
    cm = cost_model if cost_model is not None else sc.cost_model()
    classes = dict(getattr(sc.workload, "qos_classes", {}) or {})
    class_seed = sc.seed_for("qos_class")

    # one sub-driver per node over an EMPTY trace sharing the function
    # catalog + horizon; arrivals reach nodes only through the router
    nodes: Dict[str, Any] = {}
    for i, ns in enumerate(topo.nodes):
        node_trace = Trace([], trace.functions, trace.horizon)
        suite = sc.suite()         # suites are stateful: one per node
        ev = NodeEventLog(events, ns.name) if events is not None else None
        if driver == "sim":
            node = _SimNode(ns.name, node_trace, suite, cm, ns.cluster, ev)
        else:
            node = _FleetNode(ns.name, node_trace, suite, cm, ns.cluster,
                              sc.seed_for(f"loadgen:{ns.name}"), ev)
        node.state._next_cid = i * CID_STRIDE
        nodes[ns.name] = node

    policy = make_policy(topo, seed=sc.seed_for("offload"),
                         class_weights=classes)
    octx = OffloadContext(topo, {
        name: NodeView(name, node.state, node.suite, cm)
        for name, node in nodes.items()})
    led = TopologyLedger(
        merged=QoSLedger(), per_node={}, node_names=topo.node_names,
        classes=classes, class_seed=class_seed, horizon=trace.horizon)

    order = list(topo.node_names)
    for name in order:
        nodes[name].start()

    arrivals = iter(trace)
    nxt = next(arrivals, None)
    ingress = topo.ingress_node
    while True:
        tn, best = float("inf"), None
        for name in order:                 # declared order breaks ties
            t = nodes[name].next_time()
            if t < tn:
                tn, best = t, name
        if nxt is not None and nxt.time <= tn:
            t = nxt.time
            octx.now = t
            qos = assign_class(classes, class_seed, nxt.function, t)
            policy.observe(nxt.function, qos, t)
            dst = policy.choose(nxt.function, qos, octx)
            rtt, xfer = topo.network.delay(ingress, dst, topo.payload_kb)
            if events is not None:
                events.offload(t, function=nxt.function, qos_class=qos,
                               src=ingress, dst=dst, rtt_s=rtt,
                               xfer_s=xfer)
            nodes[dst].inject(t + rtt + xfer, nxt.function, arrival=t,
                              chain=nxt.chain)
            led.routed += 1
            led.offloaded += dst != ingress
            led.net_overhead_s += rtt + xfer
            led.offload_counts[dst] = led.offload_counts.get(dst, 0) + 1
            nxt = next(arrivals, None)
        elif best is not None:
            nodes[best].step()
        else:
            break

    led.per_node = {name: nodes[name].finish() for name in order}
    led.merged = _merge_ledgers(led.per_node, trace.horizon)
    return led
