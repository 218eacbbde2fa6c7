"""Predictor-driven autoscaling for the fleet — fleet-flavoured views of
the shared cluster kernel.

Since the :mod:`repro_torch.core.cluster` kernel landed, everything that used to
be hand-mirrored between this module and ``core/simulator.py`` — the policy
``Context`` protocol and the RL keep-alive tombstone bookkeeping — lives in
one place:

  * :class:`FleetContext` is the shared
    :class:`~repro_torch.core.cluster.ClusterContext` constructed from a pool's
    kernel plus the frontend's queue depths, so keep-alive, prewarm, and
    placement policies run verbatim against real or modeled replicas with
    the *same state representation* they were trained/tuned on in the
    simulator.
  * :class:`Autoscaler` is the shared
    :class:`~repro_torch.core.cluster.PolicyDriver` (per-replica TTL decisions,
    prewarm ticks, pressure-eviction order, RL tombstone resolution) under
    its historical fleet name.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.cluster import ClusterContext, PolicyDriver
from repro_torch.core.costmodel import CostModel
from repro_torch.fleet.frontend import Frontend
from repro_torch.fleet.pool import EnginePool


class FleetContext(ClusterContext):
    """The read-only policy view of fleet state (kernel context + the
    frontend's per-function queue depths)."""

    def __init__(self, pool: EnginePool, frontend: Frontend,
                 cost_model: CostModel, now: Optional[float] = None,
                 suite=None):
        super().__init__(pool.state, cost_model, suite,
                         queued=frontend.queued_count, now=now)


class Autoscaler(PolicyDriver):
    """The fleet's policy driver — see
    :class:`~repro_torch.core.cluster.PolicyDriver` for the TTL / prewarm /
    eviction / RL-tombstone semantics (shared with the simulator)."""
