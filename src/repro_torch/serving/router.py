"""Serverless frontend over *real* :class:`InferenceEngine` instances (a
copy of ``repro.serving.router`` whose engines run on ``device``).

Since the ``repro_torch.fleet`` subsystem landed, the router is a thin synchronous
facade over the fleet's building blocks: replicas live in a
:class:`~repro_torch.fleet.pool.EnginePool` driven by an
:class:`~repro_torch.fleet.pool.EngineBackend`, and scale-to-zero / eviction
decisions go through a :class:`~repro_torch.fleet.autoscaler.Autoscaler`
configured with a :class:`~repro_torch.core.policies.base.PolicySuite`
(``FixedTTL`` by default — the provider-default behaviour the original
router hard-coded).  For concurrent load, trace replay, micro-batching and
predictive autoscaling use ``repro_torch.fleet.loadgen`` directly; the router
keeps the one-call-at-a-time API for examples and tests.

With an :class:`~repro_torch.core.events.EventLog` (``events=``) the router
hands it to the pool, whose cluster kernel emits the lifecycle events, and to
the engines, and emits its own spans: ``router.invoke`` (arrival to return)
holds ``router.place`` (scale-to-zero, eviction and placement; counters
``expired`` and ``evicted``), on a miss the pool's ``pool.start_replica``,
and ``router.serve`` (the backend's serve).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.costmodel import CostModel
from repro_torch.core.events import EventLog, span
from repro_torch.core.lifecycle import Breakdown, FunctionSpec
from repro_torch.core.metrics import QoSLedger, RequestRecord
from repro_torch.core.policies.base import PolicySuite, Startup
from repro_torch.core.policies.keepalive import FixedTTL
from repro_torch.fleet.autoscaler import Autoscaler, FleetContext
from repro_torch.fleet.frontend import Frontend
from repro_torch.fleet.pool import EngineBackend, EnginePool, EngineProfile
from repro_torch.serving.engine import SnapshotStore


@dataclass
class FunctionDef:
    name: str
    arch: str
    max_seq: int = 64
    batch: int = 1
    memory_gb: float = 0.5
    decode_steps: int = 4


class ServerlessRouter:
    def __init__(self, *, ttl_s: float = 30.0, use_snapshots: bool = True,
                 memory_budget_gb: float = 8.0,
                 store: Optional[SnapshotStore] = None,
                 suite: Optional[PolicySuite] = None, device="cuda",
                 events: Optional[EventLog] = None):
        self.ttl_s = ttl_s
        self.use_snapshots = use_snapshots
        self.memory_budget_gb = memory_budget_gb
        self.store = store if store is not None else (
            SnapshotStore() if use_snapshots else None)
        self.suite = suite or PolicySuite(
            name="router", keepalive=FixedTTL(ttl_s),
            startup=Startup(snapshot=use_snapshots))
        self.functions: Dict[str, FunctionDef] = {}
        self.events = events
        self.backend = EngineBackend(store=self.store, device=device, events=events)
        self.ledger = QoSLedger()
        self.pool = EnginePool({}, num_workers=1,
                               worker_memory_mb=memory_budget_gb * 1024.0,
                               backend=self.backend, ledger=self.ledger,
                               events=events)
        self.state = self.pool.state          # the shared cluster kernel
        self.autoscaler = Autoscaler(self.suite)
        self._frontend = Frontend()           # empty; satisfies FleetContext
        self._cost_model = CostModel()
        self._t0 = time.monotonic()

    # ------------------------------------------------------------------ #
    def register(self, fdef: FunctionDef):
        self.functions[fdef.name] = fdef
        self.pool.functions[fdef.name] = FunctionSpec(
            name=fdef.name, package_mb=0.0,
            memory_mb=fdef.memory_gb * 1024.0, arch=fdef.arch)
        self.backend.profiles[fdef.name] = EngineProfile(
            arch=fdef.arch, max_seq=fdef.max_seq, batch=fdef.batch,
            decode_steps=fdef.decode_steps)

    def _now(self) -> float:
        now = time.monotonic() - self._t0
        # keep the kernel clock in step so its idle/eviction accounting
        # uses wall time (the router has no event loop of its own)
        self.state.now = max(self.state.now, now)
        return now

    def _ctx(self, now: float) -> FleetContext:
        return FleetContext(self.pool, self._frontend, self._cost_model, now,
                            self.suite)

    # ------------------------------------------------------------------ #
    def _scale_to_zero(self, now: float) -> Tuple[int, int]:
        """Lazy TTL enforcement + budget-pressure eviction in policy order.
        Returns (replicas expired, replicas evicted)."""
        expired = 0
        for c in list(self.state.all_warm_idle()):
            if now >= c.expiry:
                self.autoscaler.on_expire(c, now, now - c.warm_since)
                self.state.destroy(c, now)
                expired += 1
        return expired, self._reclaim(now, 0.0)

    def _reclaim(self, now: float, need_mb: float) -> int:
        """Evict warm replicas in policy order until ``need_mb`` fits.
        Returns the replicas evicted."""
        evicted = 0
        while self.state.free_mb(0) < need_mb:
            order = self.autoscaler.evict_order(self._ctx(now))
            if not order:
                break
            self.state.destroy(order[0], now, reason="evict")
            evicted += 1
        return evicted

    # ------------------------------------------------------------------ #
    def invoke(self, name: str, tokens: Optional[np.ndarray] = None,
               extras=None) -> Tuple[np.ndarray, RequestRecord]:
        with span(self.events, "router.invoke"):
            fdef = self.functions[name]
            arrival = self._now()
            with span(self.events, "router.place") as sp:
                self.autoscaler.observe_arrival(name, arrival)
                expired, evicted = self._scale_to_zero(arrival)
                ctx = self._ctx(arrival)
                c = self.suite.placement.choose_container(name, ctx)
                if c is not None:
                    replica = self.pool.replica_for(c)
                    self.autoscaler.on_reuse(c, ctx, arrival - c.warm_since)
                else:
                    self.autoscaler.on_miss(name, arrival)
                    evicted += self._reclaim(arrival, self.pool.functions[name].memory_mb)
                sp.count(expired=expired, evicted=evicted)
            breakdown: Optional[Breakdown] = None
            cold = c is None
            if cold:
                replica, breakdown = self.pool.start_replica(
                    name, 0, arrival, from_snapshot=self.use_snapshots)
            c = replica.container
            self.state.acquire(c, arrival)
            if tokens is None:
                tokens = np.ones((fdef.batch, fdef.max_seq), np.int32)
            start = self._now()
            with span(self.events, "router.serve"):
                out, _ = self.backend.serve(replica, tokens,
                                            decode_steps=fdef.decode_steps,
                                            extras=extras)
            end = self._now()
            # the execution is recorded before the slot is released, so the
            # kernel's events keep their time order (exec_start at ``start``)
            self.state.record_execution(c, [(name, arrival)], start, end,
                                        cold=cold, bd=breakdown)
            rec = self.ledger.records[-1]
            self.state.release_slot(c, end)
            self.state.to_idle(c, end)
            self.state.set_expiry(c, end + self.autoscaler.ttl_for(
                c, self._ctx(end)))
            return out, rec

    def summary(self) -> Dict[str, float]:
        self.ledger.horizon = self._now()
        return self.ledger.summary()
