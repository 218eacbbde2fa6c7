"""repro_torch.topology — the edge–cloud topology spec (a copy of
``repro.topology.spec``).

Only the spec is ported: the scenario catalog declares topology cells with
it.  The topology driver, its offloading policies and QoS classes come with
the router and fleet slice (ROADMAP A2); until then ``run`` raises
``NotImplementedError`` for a scenario with a topology.
"""
from repro_torch.topology.spec import (NetworkSpec, NodeSpec, TopologySpec,
                                       pair_key)

__all__ = ["TopologySpec", "NodeSpec", "NetworkSpec", "pair_key"]
