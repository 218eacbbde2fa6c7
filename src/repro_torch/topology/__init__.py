"""repro_torch.topology — edge–cloud node tiers, network model, and QoS-class
offloading (a copy of ``repro.topology``; the faas-offloading-sim scenario
family).

Specs (:mod:`repro_torch.topology.spec`) put a ``TopologySpec`` axis on
``Scenario``: named node tiers with per-node cluster shapes and a
symmetric RTT/bandwidth network.  Policies
(:mod:`repro_torch.topology.policies`) decide where each classified request
runs; the driver (:mod:`repro_torch.topology.driver`) interleaves one cluster
kernel per node under either the sim or the fleet sub-driver with a
shared deterministic router.  See docs/topology.md.
"""
from repro_torch.topology.driver import (CID_STRIDE, NodeEventLog, TopologyLedger,
                                         run_topology)
from repro_torch.topology.policies import (OFFLOAD_POLICIES, AlwaysLocal,
                                           AlwaysRemote, GreedyOffload, LocalFirst,
                                           NodeView, OffloadContext,
                                           OffloadingPolicy, ProbabilisticOffload,
                                           make_policy)
from repro_torch.topology.qos import DEFAULT_CLASS, assign_class, class_names
from repro_torch.topology.spec import (NetworkSpec, NodeSpec, TopologySpec,
                                       pair_key)

__all__ = [
    "TopologySpec", "NodeSpec", "NetworkSpec", "pair_key",
    "assign_class", "class_names", "DEFAULT_CLASS",
    "OffloadingPolicy", "AlwaysLocal", "AlwaysRemote", "LocalFirst",
    "GreedyOffload", "ProbabilisticOffload", "OffloadContext", "NodeView",
    "make_policy", "OFFLOAD_POLICIES",
    "run_topology", "TopologyLedger", "NodeEventLog", "CID_STRIDE",
]
