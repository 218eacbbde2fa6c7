"""Trace replay against the fleet: the sim-vs-real calibration loop.

``replay(trace, suite)`` drives a :class:`~repro_torch.core.workload.Trace`
through the frontend → pool → autoscaler stack and returns the same
:class:`~repro_torch.core.metrics.QoSLedger` the discrete-event simulator
produces, so a trace replayed through ``core/simulator.py`` and through
``fleet/loadgen.py`` yields summaries with an identical field schema —
P50/P95/P99 latency, cold rate, idle GB-s, cost — and can be compared
line-for-line.

Run modes (orthogonal to everything else):

  * ``VirtualClock`` + ``ModeledBackend``  — fast deterministic replay
    (tests, benchmarks, policy search);
  * ``WallClock``    + ``EngineBackend``   — real engines, measured cold
    starts, wall-clock timing (the ground-truth side of the loop).

The runner and the simulator are two drivers over the same
:class:`~repro_torch.core.cluster.ClusterState` kernel — the simulator advances
it by event heap, this runner by clock — so container semantics
(scale-to-zero on TTL expiry, warmth-tier demotion schedules and
promotions, generic pause pools, pressure evictions in policy order,
prewarm ticks, chain cascades, per-container concurrency, heterogeneous
workers) agree by construction; on a virtual-clock replay with the
modeled backend the two ledgers are *identical*, including suites that
exercise the PAUSED and SNAPSHOT_READY tiers.  The one scoped exception:
under sustained memory pressure the queueing disciplines differ (the
simulator keeps one global FIFO; the fleet per-function queues with no
cross-function head-of-line blocking).  What only a live fleet needs
stays here: admission control with SLO deadlines, per-function queues,
and micro-batching of shape-compatible requests.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.cluster import find_worker
from repro_torch.core.costmodel import CostModel
from repro_torch.core.events import EventLog
from repro_torch.core.lifecycle import Breakdown, Container, Phase, WarmthTier
from repro_torch.core.metrics import QoSLedger
from repro_torch.core.policies.base import PolicySuite
from repro_torch.core.workload import Trace
from repro_torch.fleet.autoscaler import Autoscaler, FleetContext
from repro_torch.fleet.clock import Clock, VirtualClock
from repro_torch.fleet.frontend import AdmissionConfig, Frontend, Request
from repro_torch.fleet.pool import EnginePool, ExecutionBackend, ModeledBackend


@dataclass
class FleetConfig:
    num_workers: int = 4
    # scalar = homogeneous; sequence = per-worker (heterogeneous cluster)
    worker_memory_mb: Union[float, Sequence[float]] = 16_384.0
    worker_speed: Union[float, Sequence[float]] = 1.0
    slots_per_replica: int = 1          # >1 = concurrent executions/replica
    max_batch: int = 1                  # micro-batch size cap
    max_queue_per_function: int = 100_000
    slo_latency_s: Optional[float] = None
    sanitize_on_reuse: bool = True      # match SimConfig defaults
    sanitize_cost_s: float = 0.004
    rl_miss_window_s: float = 60.0
    vary_shapes: bool = False           # draw per-request seq_len (batch test)
    shape_choices: tuple = (16, 32, 64)
    default_seq_len: int = 32
    seed: int = 0


class FleetRunner:
    """One trace replay: frontend + pool + autoscaler under one clock."""

    def __init__(self, trace: Trace, suite: PolicySuite, *,
                 cost_model: Optional[CostModel] = None,
                 cfg: Optional[FleetConfig] = None,
                 clock: Optional[Clock] = None,
                 backend: Optional[ExecutionBackend] = None,
                 events: Optional[EventLog] = None):
        self.trace = trace
        self.suite = suite
        self.cost_model = cost_model or CostModel()
        self.cfg = cfg or FleetConfig()
        self.clock = clock or VirtualClock()
        self.backend = backend or ModeledBackend(self.cost_model)
        self.events = events
        self.frontend = Frontend(AdmissionConfig(
            max_queue_per_function=self.cfg.max_queue_per_function,
            slo_latency_s=self.cfg.slo_latency_s))
        self.ledger = QoSLedger(horizon=trace.horizon)
        self.pool = EnginePool(trace.functions,
                               num_workers=self.cfg.num_workers,
                               worker_memory_mb=self.cfg.worker_memory_mb,
                               worker_speed=self.cfg.worker_speed,
                               backend=self.backend,
                               slots_per_replica=self.cfg.slots_per_replica,
                               ledger=self.ledger,
                               tier_footprint_frac=(
                                   self.cost_model.tier_footprint_frac),
                               events=events)
        self.state = self.pool.state
        self.ledger.cluster_capacity_gb = self.state.capacity_gb
        self.autoscaler = Autoscaler(
            suite, rl_miss_window_s=self.cfg.rl_miss_window_s,
            tier_footprint_frac=self.cost_model.tier_footprint_frac)
        self.pause_pool: int = 0            # generic paused containers left
        self._events: list = []
        self._seq = itertools.count()
        self._rid = itertools.count()
        self._inflight_prewarm: set = set()
        self._joined: set = set()         # rids with an emitted queue_join

    @property
    def now(self) -> float:
        return self.state.now

    # ------------------------------------------------------------------ #
    def _push(self, t: float, kind: str, payload=None):
        heapq.heappush(self._events, (t, next(self._seq), kind, payload))

    def _ctx(self) -> FleetContext:
        return FleetContext(self.pool, self.frontend, self.cost_model,
                            self.now, self.suite)

    def _mk_request(self, function: str, arrival: float, chain=(),
                    rng: Optional[np.random.Generator] = None) -> Request:
        if self.cfg.vary_shapes and rng is not None:
            seq = int(rng.choice(self.cfg.shape_choices))
        else:
            seq = self.cfg.default_seq_len
        return Request(id=next(self._rid), function=function, arrival=arrival,
                       seq_len=seq, chain=tuple(chain))

    # ------------------------------------------------------------------ #
    def start(self) -> None:
        """Prime the heap: all trace arrivals, autoscaler tick, pause
        pool.  Split from :meth:`run` so an external orchestrator (the
        topology driver) can interleave several FleetRunner instances
        event by event."""
        rng = np.random.default_rng(self.cfg.seed)
        # streams iterate lazily too; the fleet driver still enqueues all
        # arrivals upfront (it replays by clock), so only the scalar sim
        # offers the bounded-memory path — but a StreamedTrace works here
        for inv in self.trace:
            self._push(inv.time, "arrival",
                       self._mk_request(inv.function, inv.time, inv.chain, rng))
        if self.autoscaler.tick_interval is not None:
            self._push(0.0, "tick", None)
        if self.suite.startup.pause_pool_size:
            # generic PCPM pause pool — same semantics as the simulator
            self.pause_pool = self.suite.startup.pause_pool_size
            footprint = (self.suite.startup.pause_pool_size
                         * self.suite.startup.pause_pool_mb)
            for w in range(self.cfg.num_workers):
                self.state.reserve(w, footprint / self.cfg.num_workers)

    def next_time(self) -> float:
        """Timestamp of the next pending event (inf when drained)."""
        return self._events[0][0] if self._events else float("inf")

    def step(self) -> None:
        """Pop and process exactly one event."""
        t, _, kind, payload = heapq.heappop(self._events)
        if t > self.trace.horizon and kind == "tick":
            return
        self.clock.sleep_until(t)
        self.state.now = max(self.state.now, t)
        getattr(self, f"_on_{kind}")(payload)

    def inject(self, t: float, function: str, arrival: float,
               chain=()) -> None:
        """Externally inject an arrival at ``t`` (topology routing) whose
        latency clock started at ``arrival`` — the original ingress time —
        so network delay lands in end-to-end latency."""
        self._push(t, "arrival", self._mk_request(function, arrival, chain))

    def finish(self) -> QoSLedger:
        """Close out idle accounting at the horizon."""
        self.state.close_out(self.trace.horizon)
        if self.suite.startup.pause_pool_size:
            self.ledger.add_idle(
                self.trace.horizon * self.suite.startup.pause_pool_size,
                self.suite.startup.pause_pool_mb / 1024.0, tier="paused")
        self.ledger.dropped = self.frontend.drops.total
        return self.ledger

    def run(self) -> QoSLedger:
        self.start()
        while self._events:
            self.step()
        return self.finish()

    # ------------------------------------------------------------------ #
    # handlers
    # ------------------------------------------------------------------ #
    def _on_arrival(self, req: Request):
        if self.events is not None:
            self.events.arrival(self.now, req.function)
        self.autoscaler.observe_arrival(req.function, self.now)
        if self.frontend.submit(req):
            self._try_dispatch(req.function)
            # the dispatch either consumed the request or left it parked;
            # the simulator only queues when no capacity exists, so the
            # join event fires only for requests that actually wait
            if self.events is not None and self.frontend.queued(req):
                self._joined.add(req.id)
                self.events.queue_join(self.now, req.function)

    def _on_tick(self, _):
        ctx = self._ctx()
        for fn_name in self.autoscaler.prewarm_targets(self.now, ctx):
            if (ctx.warm_idle(fn_name) or fn_name in self._inflight_prewarm
                    or ctx.active_count(fn_name)):
                continue
            # a demoted resident beats a fresh spawn: promote it to warm
            c = self.state.best_resident(fn_name)
            if c is not None and self.state.can_promote(c):
                self._inflight_prewarm.add(fn_name)
                self._promote(c, [])
                continue
            worker = find_worker(self.state, self.pool.functions[fn_name],
                                 self.suite, ctx)
            if worker is None:
                continue
            self._inflight_prewarm.add(fn_name)
            self._launch(fn_name, worker, [])
        if self.now <= self.trace.horizon:
            self._push(self.now + self.autoscaler.tick_interval, "tick", None)

    def _on_start_done(self, payload):
        cid, batch, bd = payload
        replica = self.pool.replicas.get(cid)
        if replica is None:
            return
        if not batch:
            # prewarmed replica -> warm idle; queued work may claim it now
            self._inflight_prewarm.discard(replica.function)
            self._to_idle(replica.container)
            self._drain_all()
            return
        st = self.suite.startup
        penalty = 0.0
        if st.deps_fraction < 1.0 and replica.container.uses == 0:
            full = self.cost_model.breakdown(replica.spec).seconds[Phase.DEPS_LOAD]
            penalty = (st.first_run_penalty_frac * full
                       * (1 - st.deps_fraction))
        self._begin_exec(replica, batch, cold=True, bd=bd,
                         first_run_penalty=penalty)

    def _on_exec_done(self, payload):
        cid, batch = payload
        replica = self.pool.replicas.get(cid)
        if replica is None:
            return
        drained = self.state.release_slot(replica.container, self.now)
        for req in batch:
            if req.chain:
                nxt = self._mk_request(req.chain[0], self.now, req.chain[1:])
                self._push(self.now, "arrival", nxt)
        if drained:
            self._to_idle(replica.container)
        self._drain_all()

    def _on_expire(self, payload):
        cid, stamp, tier, rest = payload
        c = self.state.transition_valid(cid, stamp)
        if c is None:
            return  # dead, busy again, or superseded by a reuse/promotion
        if tier == WarmthTier.DEAD:
            self.autoscaler.on_expire(c, self.now, self.now - c.warm_since,
                                      tier=c.tier)
            self.state.destroy(c, self.now)
        else:
            self.state.demote(c, tier, self.now)
            self._arm_edge(c, rest)
        self._drain_all()   # freed footprint may admit queued work

    def _on_pool_refill(self, _):
        if self.pause_pool < self.suite.startup.pause_pool_size:
            self.pause_pool += 1

    # ------------------------------------------------------------------ #
    # dispatch machinery
    # ------------------------------------------------------------------ #
    def _try_dispatch(self, fn_name: str) -> bool:
        if self.frontend.head(fn_name, self.now) is None:
            return False
        ctx = self._ctx()
        c = self.suite.placement.choose_container(fn_name, ctx)
        if c is not None:
            replica = self.pool.replica_for(c)
            batch = self._take_batch(fn_name)
            if not batch:
                return False
            self._reuse(replica, batch)
            return True
        # concurrency slots: join an ACTIVE replica with spare capacity
        replica = self.pool.free_slot_replica(fn_name)
        if replica is not None:
            batch = self._take_batch(fn_name)
            if not batch:
                return False
            self._begin_exec(replica, batch, cold=False, bd=None)
            return True
        # warmth ladder: resume a demoted resident replica (paused /
        # snapshot-resident) — far cheaper than a fresh cold start
        c = self.state.best_resident(fn_name)
        if c is not None and self.state.can_promote(c):
            batch = self._take_batch(fn_name)
            if not batch:
                return False
            self._promote(c, batch)
            return True
        # cold path
        self.autoscaler.on_miss(fn_name, self.now)
        worker = find_worker(self.state, self.pool.functions[fn_name],
                             self.suite, ctx)
        if worker is None:
            return False          # stays queued; retried on the next release
        batch = self._take_batch(fn_name)
        if not batch:
            return False
        self._launch(fn_name, worker, batch)
        return True

    def _take_batch(self, fn_name: str) -> List[Request]:
        batch = self.frontend.take_batch(fn_name, self.now,
                                         self.cfg.max_batch)
        if self.events is not None:
            for req in batch:
                if req.id in self._joined:
                    self._joined.discard(req.id)
                    self.events.queue_leave(self.now, req.function,
                                            self.now - req.arrival)
        return batch

    def _launch(self, fn_name: str, worker: int, batch: List[Request]):
        st = self.suite.startup
        from_pool = self.pause_pool > 0 and st.pause_pool_size > 0
        if from_pool:
            self.pause_pool -= 1
            refill = self.cost_model.breakdown(
                self.pool.functions[fn_name]).drop(
                Phase.DEPS_LOAD, Phase.CODE_INIT).total
            self._push(self.now + refill, "pool_refill", None)
        tier = self.state.spawn_tier(fn_name, img_cache=st.img_cache)
        replica, bd = self.pool.start_replica(
            fn_name, worker, self.now, tier=tier,
            deps_fraction=st.deps_fraction, from_pause_pool=from_pool)
        if self.events is not None:
            self.events.startup(self.now, replica.id, fn_name, tier, bd)
        if st.snapshot:
            self.state.snapshots.add(fn_name)
        self._push(self.now + bd.total, "start_done", (replica.id, batch, bd))

    def _promote(self, c: Container, batch: List[Request]):
        """Resume a demoted resident replica (the ladder's promote edge)."""
        replica = self.pool.replica_for(c)
        idle_s = self.now - c.warm_since
        tier = c.tier
        self.autoscaler.on_promote(c, self._ctx(), idle_s, tier)
        bd = self.pool.promote_replica(replica, self.now)
        if self.events is not None:
            self.events.startup(self.now, replica.id, c.function, tier, bd)
        self._push(self.now + bd.total, "start_done", (replica.id, batch, bd))

    def _reuse(self, replica, batch: List[Request]):
        c = replica.container
        self.autoscaler.on_reuse(c, self._ctx(), self.now - c.warm_since)
        self._begin_exec(replica, batch, cold=False, bd=None,
                         sanitize=self.cfg.sanitize_on_reuse)

    def _begin_exec(self, replica, batch: List[Request], *, cold: bool,
                    bd: Optional[Breakdown], first_run_penalty: float = 0.0,
                    sanitize: Optional[bool] = None):
        # sanitization applies only on warm reuse (sanitize is None
        # otherwise), never on cold first runs or concurrency-slot joins —
        # matching the simulator's accounting exactly
        c = replica.container
        self.state.acquire(c, self.now, sanitized=sanitize)
        exec_t = self.backend.execute(replica, batch,
                                      first_run_penalty=first_run_penalty,
                                      speed=self.state.speed(c.worker))
        if sanitize:
            exec_t += self.cfg.sanitize_cost_s
        end = self.now + exec_t
        self.state.record_execution(
            c, [(req.function, req.arrival) for req in batch],
            self.now, end, cold=cold, bd=bd)
        self._push(end, "exec_done", (replica.id, batch))

    def _to_idle(self, c: Container):
        self.state.to_idle(c, self.now)
        self._arm_edge(c, self.autoscaler.schedule_for(c, self._ctx()))

    def _arm_edge(self, c: Container, sched):
        """Arm the next demotion-schedule edge (or park forever)."""
        if not sched:
            self.state.set_expiry(c, float("inf"))
            return
        (dwell, tier), rest = sched[0], tuple(sched[1:])
        stamp = self.state.set_expiry(c, self.now + dwell)
        self._push(stamp, "expire", (c.id, stamp, tier, rest))

    def _drain_all(self):
        progressed = True
        while progressed:
            progressed = False
            for fn_name in self.frontend.pending_functions(self.now):
                if self._try_dispatch(fn_name):
                    progressed = True


def replay(trace: Trace, suite: PolicySuite, *,
           cost_model: Optional[CostModel] = None,
           cfg: Optional[FleetConfig] = None,
           clock: Optional[Clock] = None,
           backend: Optional[ExecutionBackend] = None,
           events: Optional[EventLog] = None) -> QoSLedger:
    """Replay ``trace`` under ``suite``; returns the QoS ledger (same schema
    as ``core.simulator.simulate`` on the same trace)."""
    return FleetRunner(trace, suite, cost_model=cost_model, cfg=cfg,
                       clock=clock, backend=backend, events=events).run()
