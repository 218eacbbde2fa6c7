"""Topology specs — node tiers and the network between them, as data.

A :class:`TopologySpec` is the ``Scenario.topology`` axis: an ordered set
of named node tiers (e.g. edge / regional / cloud), each with its own
:class:`~repro.experiments.spec.ClusterSpec`-shaped worker pool, plus a
symmetric :class:`NetworkSpec` of per-pair RTT and bandwidth so the cost
of shipping a request off-node depends on its payload size.  Everything
here is plain frozen-dataclass data: ``to_dict``/``from_dict`` round-trip
through JSON, and the pair-keyed network maps are ordinary ``Mapping``\\ s
so ``Scenario.with_overrides`` dotted paths descend into them — a
``Sweep`` can vary ``topology.network.rtt_s.cloud|edge`` or swap whole
``topology`` values per cell.

Network model: links are symmetric and keyed by the *canonical pair
string* ``pair_key(a, b)`` (names sorted, joined with ``|``), with
defaults for unlisted pairs.  Same-node traffic is free (RTT 0, no
transfer); the ingress node therefore serves local requests with zero
network overhead, which is exactly the cold-start-vs-network tension the
offloading policies trade on.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.experiments.spec import ClusterSpec


def pair_key(a: str, b: str) -> str:
    """Canonical undirected-link key: sorted names joined with ``|``."""
    return "|".join(sorted((a, b)))


@dataclass(frozen=True)
class NodeSpec:
    """One named node tier: a cluster shape at a place in the network."""

    name: str
    cluster: ClusterSpec = field(default_factory=ClusterSpec)

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "cluster": self.cluster.to_dict()}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "NodeSpec":
        return cls(name=d["name"],
                   cluster=ClusterSpec.from_dict(d.get("cluster", {})))


@dataclass(frozen=True)
class NetworkSpec:
    """Symmetric per-pair RTT/bandwidth with defaults for unlisted pairs.

    ``rtt_s`` and ``bandwidth_mbps`` map :func:`pair_key` strings to
    seconds / Mbit-per-second; a pair absent from a map uses the default.
    Same-node traffic costs nothing by construction.
    """

    rtt_s: Mapping[str, float] = field(default_factory=dict)
    bandwidth_mbps: Mapping[str, float] = field(default_factory=dict)
    default_rtt_s: float = 0.05
    default_bandwidth_mbps: float = 100.0

    def rtt(self, a: str, b: str) -> float:
        if a == b:
            return 0.0
        return float(self.rtt_s.get(pair_key(a, b), self.default_rtt_s))

    def bandwidth(self, a: str, b: str) -> float:
        return float(self.bandwidth_mbps.get(pair_key(a, b),
                                             self.default_bandwidth_mbps))

    def transfer_s(self, a: str, b: str, payload_kb: float) -> float:
        """Payload transfer time: size-dependent, zero on-node."""
        if a == b or payload_kb <= 0.0:
            return 0.0
        mbit = payload_kb * 8.0 / 1024.0
        bw = self.bandwidth(a, b)
        return mbit / bw if bw > 0 else 0.0

    def delay(self, a: str, b: str,
              payload_kb: float) -> Tuple[float, float]:
        """(rtt_s, transfer_s) for one request shipped ``a`` -> ``b``."""
        return self.rtt(a, b), self.transfer_s(a, b, payload_kb)

    def to_dict(self) -> Dict[str, Any]:
        return {"rtt_s": dict(self.rtt_s),
                "bandwidth_mbps": dict(self.bandwidth_mbps),
                "default_rtt_s": self.default_rtt_s,
                "default_bandwidth_mbps": self.default_bandwidth_mbps}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "NetworkSpec":
        d = dict(d)
        for k in ("rtt_s", "bandwidth_mbps"):
            if k in d:
                d[k] = dict(d[k])
        return cls(**d)


@dataclass(frozen=True)
class TopologySpec:
    """The ``Scenario.topology`` axis: node tiers + network + offloading.

    ``offload`` names a policy from
    :data:`repro.topology.policies.OFFLOAD_POLICIES`; ``ingress`` is where
    every external request lands before routing (default: the first node —
    by convention the edge).  ``payload_kb`` is the per-request payload
    shipped when a request leaves its ingress.  ``update_interval_s`` and
    ``arrival_alpha`` parameterize the probabilistic policy's periodic
    re-solve (faas-offloading-sim's ``update-interval`` / EWMA alpha).
    """

    nodes: Tuple[NodeSpec, ...] = ()
    network: NetworkSpec = field(default_factory=NetworkSpec)
    offload: str = "local_first"
    ingress: Optional[str] = None       # default: first node
    payload_kb: float = 64.0
    update_interval_s: float = 60.0     # probabilistic re-solve period
    arrival_alpha: float = 0.3          # EWMA weight for arrival estimates

    def __post_init__(self):
        if not self.nodes:
            raise ValueError("TopologySpec needs at least one node")
        names = [n.name for n in self.nodes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate node names: {names}")
        if self.ingress is not None and self.ingress not in names:
            raise ValueError(
                f"ingress {self.ingress!r} is not a node (have: {names})")

    @property
    def node_names(self) -> Tuple[str, ...]:
        return tuple(n.name for n in self.nodes)

    @property
    def ingress_node(self) -> str:
        return self.ingress if self.ingress is not None else self.nodes[0].name

    def node(self, name: str) -> NodeSpec:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def to_dict(self) -> Dict[str, Any]:
        return {"nodes": [n.to_dict() for n in self.nodes],
                "network": self.network.to_dict(),
                "offload": self.offload,
                "ingress": self.ingress,
                "payload_kb": self.payload_kb,
                "update_interval_s": self.update_interval_s,
                "arrival_alpha": self.arrival_alpha}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TopologySpec":
        d = dict(d)
        d["nodes"] = tuple(NodeSpec.from_dict(n) for n in d.get("nodes", ()))
        d["network"] = NetworkSpec.from_dict(d.get("network", {}))
        return cls(**d)
