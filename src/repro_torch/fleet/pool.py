"""Engine pool: per-function replicas, concurrency slots, micro-batching
(a copy of ``repro.fleet.pool`` whose ``EngineBackend`` builds the port's
engine on an explicit device).

The pool is the fleet's view of the shared
:class:`~repro_torch.core.cluster.ClusterState` kernel: replica lifecycle,
warm-idle lookup, per-worker memory accounting, and concurrency-slot
bookkeeping all live in the kernel (the same code the simulator drives), so
every ``core/policies`` suite drives the fleet unchanged and sim-vs-fleet
calibration is structural rather than accidental.  What the pool adds on
top is the *execution* side only: which engine object backs a container and
where its startup/execution durations come from.

Execution is abstracted behind :class:`ExecutionBackend`:

  * :class:`ModeledBackend` — durations from the calibrated
    :class:`~repro_torch.core.costmodel.CostModel`; combined with the virtual
    clock this gives fast, deterministic replays directly comparable with
    ``core/simulator.py``.
  * :class:`EngineBackend` — real :class:`~repro_torch.serving.engine.InferenceEngine`
    replicas: cold starts pay a genuine weight init and warm-up (or snapshot
    restore through :class:`~repro_torch.serving.engine.SnapshotStore`) and
    execution runs the model on its device, all wall-clock measured.

Both backends take the placement worker's speed factor, so heterogeneous
clusters (per-worker memory + speed) replay identically under sim and
fleet; the real-engine backend ignores it (its durations are measured, not
modeled).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.cluster import ClusterState, scale_breakdown
from repro_torch.core.costmodel import CostModel
from repro_torch.core.events import EventLog, span
from repro_torch.core.lifecycle import (Breakdown, Container, ContainerState,
                                        FunctionSpec, WarmthTier)
from repro_torch.core.metrics import QoSLedger
from repro_torch.fleet.frontend import Request


@dataclass
class Replica:
    """One warm-capable unit of a function: a kernel Container plus the
    engine object (when the backend is real).  Slot accounting lives on the
    Container itself so the kernel owns it."""

    container: Container
    spec: FunctionSpec
    engine: Optional[object] = None      # real InferenceEngine when EngineBackend

    @property
    def id(self) -> int:
        return self.container.id

    @property
    def function(self) -> str:
        return self.container.function

    @property
    def state(self) -> ContainerState:
        return self.container.state

    @property
    def slots(self) -> int:
        return self.container.concurrency

    @property
    def inflight(self) -> int:
        return self.container.inflight


# --------------------------------------------------------------------------- #
# execution backends
# --------------------------------------------------------------------------- #


class ExecutionBackend:
    """Where a replica's startup and execution durations come from.

    The warmth-tier ladder maps onto the backend as three hooks:
    ``provision`` (spawn from a function-level tier: DEAD / IMG_CACHED /
    SNAPSHOT_READY), ``promote`` (resume a *resident* demoted replica:
    PAUSED thaw or snapshot restore), and ``demote`` (slide down a rung:
    keep the engine for PAUSED, persist + drop it for SNAPSHOT_READY).
    """

    def provision(self, replica: Replica, *, tier: WarmthTier,
                  concurrent_colds: int, deps_fraction: float,
                  from_pause_pool: bool = False,
                  speed: float = 1.0) -> Breakdown:
        raise NotImplementedError

    def promote(self, replica: Replica, tier: WarmthTier, *,
                concurrent_colds: int = 0, speed: float = 1.0) -> Breakdown:
        """Seconds to resume a resident replica from ``tier``."""
        raise NotImplementedError

    def demote(self, replica: Replica, tier: WarmthTier) -> None:
        """Apply a ladder demotion to the execution substrate (no-op for
        modeled replicas)."""

    def execute(self, replica: Replica, requests: Sequence[Request], *,
                first_run_penalty: float = 0.0,
                speed: float = 1.0) -> float:
        """Seconds to serve ``requests`` as one micro-batch on one slot."""
        raise NotImplementedError

    def release(self, replica: Replica) -> None:
        pass


class ModeledBackend(ExecutionBackend):
    """Cost-model-driven durations (deterministic; pairs with VirtualClock).

    Micro-batching follows the usual sub-linear accelerator scaling: a batch
    of k costs ``exec_time * (1 + batch_alpha * (k - 1))`` rather than k
    serial executions.  ``speed`` is the worker's heterogeneity factor
    (execution and startup scale by 1/speed).
    """

    def __init__(self, cost_model: Optional[CostModel] = None,
                 batch_alpha: float = 0.15):
        self.cost_model = cost_model or CostModel()
        self.batch_alpha = batch_alpha

    def provision(self, replica: Replica, *, tier: WarmthTier,
                  concurrent_colds: int, deps_fraction: float,
                  from_pause_pool: bool = False,
                  speed: float = 1.0) -> Breakdown:
        bd = self.cost_model.promote_breakdown(
            replica.spec, tier, concurrent_colds=concurrent_colds,
            deps_fraction=deps_fraction, from_pause_pool=from_pause_pool)
        return scale_breakdown(bd, speed)

    def promote(self, replica: Replica, tier: WarmthTier, *,
                concurrent_colds: int = 0, speed: float = 1.0) -> Breakdown:
        bd = self.cost_model.promote_breakdown(
            replica.spec, tier, concurrent_colds=concurrent_colds)
        return scale_breakdown(bd, speed)

    def execute(self, replica: Replica, requests: Sequence[Request], *,
                first_run_penalty: float = 0.0,
                speed: float = 1.0) -> float:
        base = self.cost_model.exec_time(replica.spec,
                                         first_run_penalty=first_run_penalty)
        return base * (1.0 + self.batch_alpha * (len(requests) - 1)) / speed


@dataclass
class EngineProfile:
    """How a function name maps onto a real model endpoint."""

    arch: str
    max_seq: int = 32
    batch: int = 1
    decode_steps: int = 4
    smoke: bool = True


class EngineBackend(ExecutionBackend):
    """Real engines on ``device`` ("cuda" unless the caller asks for "cpu");
    durations are measured, not modeled (``speed`` is therefore ignored — a
    real worker is as fast as it is).

    The warmth tiers map onto real mechanisms:

      WARM_IDLE / PAUSED   the engine object stays resident — params on
                           device, warmed kernels live; promote is a
                           measured no-op (cgroup thaw has no engine analogue)
      SNAPSHOT_READY       params persisted to the SnapshotStore and the
                           engine dropped on demote; promote is a genuine
                           ``cold_start(from_snapshot=True)`` — snapshot
                           load onto the device + warmed-key cache hit
      IMG_CACHED / DEAD    full measured cold start (init + warm-up)
    """

    def __init__(self, store=None, profiles: Optional[Dict[str, EngineProfile]] = None,
                 device="cuda", events: Optional[EventLog] = None):
        from repro_torch.device import resolve_device
        self.store = store
        self.profiles: Dict[str, EngineProfile] = profiles or {}
        self.device = resolve_device(device)
        self.events = events          # handed to each engine, for its spans

    def profile(self, function: str) -> EngineProfile:
        prof = self.profiles.get(function)
        if prof is None:
            raise KeyError(f"no EngineProfile registered for {function!r}")
        return prof

    def _spawn_engine(self, replica: Replica, *,
                      from_snapshot: bool) -> Breakdown:
        from repro_torch.serving.engine import InferenceEngine
        prof = self.profile(replica.function)
        engine = InferenceEngine(prof.arch, smoke=prof.smoke,
                                 max_seq=prof.max_seq, batch=prof.batch,
                                 store=self.store, device=self.device,
                                 events=self.events)
        replica.engine = engine
        return engine.cold_start(from_snapshot=from_snapshot)

    def provision(self, replica: Replica, *, tier: WarmthTier,
                  concurrent_colds: int, deps_fraction: float,
                  from_pause_pool: bool = False,
                  speed: float = 1.0) -> Breakdown:
        return self._spawn_engine(
            replica, from_snapshot=tier == WarmthTier.SNAPSHOT_READY)

    def promote(self, replica: Replica, tier: WarmthTier, *,
                concurrent_colds: int = 0, speed: float = 1.0) -> Breakdown:
        if replica.engine is not None and replica.engine.warm:
            # PAUSED: everything resident — measured resume is free
            return Breakdown({})
        return self._spawn_engine(replica, from_snapshot=True)

    def demote(self, replica: Replica, tier: WarmthTier) -> None:
        if tier == WarmthTier.PAUSED:
            return                    # engine stays resident, just frozen
        if replica.engine is not None:
            # SNAPSHOT_READY: the param snapshot + executable cache were
            # written at first cold start; drop the live engine
            replica.engine.shutdown()
            replica.engine = None

    def execute(self, replica: Replica, requests: Sequence[Request], *,
                first_run_penalty: float = 0.0,
                speed: float = 1.0) -> float:
        """Serve a micro-batch on the real engine.

        The engine is warmed at a fixed (batch, max_seq) shape, so a
        k-request micro-batch costs ceil(k / batch) engine calls (inputs
        are padded to max_seq; per-request seq_len never changes the
        warmed shape).  ``first_run_penalty`` models FaaSLight deferred
        dependency loading, which has no real-engine analogue — the real
        engine always loads fully at cold start — so it is ignored here.
        """
        prof = self.profile(replica.function)
        tokens = np.ones((prof.batch, prof.max_seq), np.int32)
        calls = max(1, -(-len(requests) // prof.batch))
        total = 0.0
        for _ in range(calls):
            _, duration = self.serve(replica, tokens,
                                     decode_steps=prof.decode_steps)
            total += duration
        return total

    def serve(self, replica: Replica, tokens: np.ndarray, *,
              decode_steps: int = 4, extras=None) -> Tuple[np.ndarray, float]:
        t0 = time.perf_counter()
        out, _ = replica.engine.serve(tokens, decode_steps=decode_steps,
                                      extras=extras)
        return out, time.perf_counter() - t0

    def release(self, replica: Replica) -> None:
        if replica.engine is not None:
            replica.engine.shutdown()
            replica.engine = None


# --------------------------------------------------------------------------- #
# the pool
# --------------------------------------------------------------------------- #


class EnginePool:
    """Replica registry over the shared cluster kernel.

    All container/memory state is delegated to
    :class:`~repro_torch.core.cluster.ClusterState`; the pool maps container ids
    to :class:`Replica` objects (engine handles) and routes startup /
    teardown through the :class:`ExecutionBackend`.
    """

    def __init__(self, functions: Dict[str, FunctionSpec], *,
                 num_workers: int = 4,
                 worker_memory_mb: Union[float, Sequence[float]] = 16_384.0,
                 worker_speed: Union[float, Sequence[float]] = 1.0,
                 backend: Optional[ExecutionBackend] = None,
                 slots_per_replica: int = 1,
                 ledger: Optional[QoSLedger] = None,
                 tier_footprint_frac: Optional[Dict] = None,
                 events: Optional[EventLog] = None):
        self.backend = backend or ModeledBackend()
        self.state = ClusterState(
            functions, num_workers=num_workers,
            worker_memory_mb=worker_memory_mb, worker_speed=worker_speed,
            ledger=ledger, default_concurrency=slots_per_replica,
            on_destroy=self._teardown, on_demote=self._demote_replica,
            tier_footprint_frac=tier_footprint_frac, events=events)
        self.replicas: Dict[int, Replica] = {}
        self.events = events

    def _teardown(self, container: Container) -> None:
        replica = self.replicas.pop(container.id, None)
        if replica is not None:
            self.backend.release(replica)

    def _demote_replica(self, container: Container,
                        tier: WarmthTier) -> None:
        replica = self.replicas.get(container.id)
        if replica is not None:
            self.backend.demote(replica, tier)

    # -- kernel views (the policy vocabulary) ----------------------------- #
    @property
    def functions(self) -> Dict[str, FunctionSpec]:
        return self.state.functions

    @property
    def num_workers(self) -> int:
        return self.state.num_workers

    @property
    def worker_used(self) -> List[float]:
        return self.state.worker_used

    @property
    def snapshots(self) -> set:
        return self.state.snapshots

    def containers(self) -> Iterable[Container]:
        return (r.container for r in self.replicas.values())

    def warm_idle(self, function: str) -> List[Container]:
        return self.state.warm_idle(function)

    def all_warm_idle(self) -> List[Container]:
        return self.state.all_warm_idle()

    def replica_for(self, container_or_id) -> Optional[Replica]:
        cid = getattr(container_or_id, "id", container_or_id)
        return self.replicas.get(cid)

    def free_slot_replica(self, function: str) -> Optional[Replica]:
        """An ACTIVE replica that can take one more concurrent execution."""
        c = self.state.free_slot(function)
        return None if c is None else self.replicas.get(c.id)

    def free_mb(self, worker: int) -> float:
        return self.state.free_mb(worker)

    def active_count(self, function: str) -> int:
        return self.state.active_count(function)

    def concurrent_colds(self, worker: int) -> int:
        return self.state.provisioning_on(worker)

    # -- lifecycle ------------------------------------------------------- #
    def start_replica(self, function: str, worker: int, now: float, *,
                      tier: Optional[WarmthTier] = None,
                      from_snapshot: bool = False,
                      deps_fraction: float = 1.0,
                      from_pause_pool: bool = False) -> Tuple[Replica, Breakdown]:
        """Spawn a new replica from a function-level warmth tier (DEAD /
        IMG_CACHED / SNAPSHOT_READY).  ``from_snapshot`` is the legacy
        boolean spelling of ``tier=SNAPSHOT_READY``."""
        if tier is None:
            tier = (WarmthTier.SNAPSHOT_READY if from_snapshot
                    else WarmthTier.DEAD)
        with span(self.events, "pool.start_replica"):
            c = self.state.admit(function, worker, now,
                                 has_snapshot=tier == WarmthTier.SNAPSHOT_READY,
                                 tier=tier)
            replica = Replica(container=c, spec=self.state.functions[function])
            self.replicas[c.id] = replica
            bd = self.backend.provision(
                replica, tier=tier,
                concurrent_colds=self.state.provisioning_on(worker) - 1,
                deps_fraction=deps_fraction, from_pause_pool=from_pause_pool,
                speed=self.state.speed(worker))
        return replica, bd

    def promote_replica(self, replica: Replica, now: float) -> Breakdown:
        """Resume a demoted resident replica via the kernel's promote path
        (bills the tier dwell, re-inflates the footprint) and the
        backend's tier→mechanism mapping."""
        c = replica.container
        worker = c.worker
        concurrent = self.state.provisioning_on(worker)
        tier = self.state.promote_begin(c, now)
        return self.backend.promote(replica, tier, concurrent_colds=concurrent,
                                    speed=self.state.speed(worker))

    def release(self, replica: Replica) -> None:
        """Destroy a replica (idle accounting + memory + engine teardown all
        via the kernel's destroy path)."""
        self.state.destroy(replica.container, self.state.now)
