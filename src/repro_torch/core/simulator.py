"""Discrete-event FaaS-cluster simulator — an event-heap driver over the
shared :mod:`repro.core.cluster` kernel.

Simulates a multi-worker serverless cluster executing a workload
:class:`~repro.core.workload.Trace` under a
:class:`~repro.core.policies.base.PolicySuite`, with per-phase cold-start
costs from the calibrated :class:`~repro.core.costmodel.CostModel`.
Produces a :class:`~repro.core.metrics.QoSLedger` (RQ1 parameters).

Semantics (matching the surveyed platforms):
  * up to ``FunctionSpec.container_concurrency`` in-flight requests per
    container (1 = Lambda-style; >1 = Knative-style slot sharing);
  * scale-to-zero after the policy's keep-alive TTL;
  * memory pressure evicts warm-idle containers in policy order;
  * prewarm policies tick periodically and may start containers proactively;
  * chains trigger the successor invocation at stage completion (the
    cascading-cold-start setting);
  * workers may be heterogeneous (per-worker memory capacity and speed);
  * every cold start's phase breakdown is recorded (Fig. 10 anatomy).

All container bookkeeping — the FSM, warm-idle indexes, memory counters,
QoS accounting — lives in :class:`~repro.core.cluster.ClusterState`; this
module only owns the event heap, the request queue, and the pause-pool /
prewarm orchestration.  The fleet (``repro.fleet.loadgen``) drives the same
kernel by clock, which is what keeps sim-vs-fleet calibration exact.

The simulator is deterministic given (trace, suite, cost model), and the
trace may be EITHER a materialized :class:`~repro.core.workload.Trace` or
a bounded-memory :class:`~repro.core.workload.StreamedTrace`: arrivals are
merged into the event heap incrementally (exactly one trace arrival is
in-heap at any moment, pulled from the stream cursor as its predecessor
pops), so peak memory is O(live cluster state + armed timers), never
O(trace).  Heap keys are ``(time, rank, seq)`` with trace arrivals at rank
0 — the same tie-break order the materialized pre-load produced — so a
stream and its materialized twin replay bit-identically (gated in
``tests/test_workload.py``).
"""
from __future__ import annotations

import heapq
import itertools
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterator, List, Optional, Sequence, Union

from repro_torch.core.cluster import (ClusterContext, ClusterState, PolicyDriver,
                                      find_worker, scale_breakdown)
from repro_torch.core.costmodel import CostModel
from repro_torch.core.events import EventLog
from repro_torch.core.lifecycle import (Breakdown, Container, FunctionSpec, Phase,
                                        WarmthTier)
from repro_torch.core.metrics import QoSLedger
from repro_torch.core.policies.base import PolicySuite
from repro_torch.core.workload import Invocation, InvocationStream, Trace

# the policy-facing view is the shared Context protocol; the name SimContext
# survives for the policy/predictor docstrings and type hints that grew up
# against the pre-kernel simulator
SimContext = ClusterContext


@dataclass
class SimConfig:
    num_workers: int = 4
    # scalar = homogeneous; sequence = per-worker (heterogeneous cluster)
    worker_memory_mb: Union[float, Sequence[float]] = 16_384.0
    worker_speed: Union[float, Sequence[float]] = 1.0
    sanitize_on_reuse: bool = True
    sanitize_cost_s: float = 0.004
    rl_miss_window_s: float = 60.0
    max_queue: int = 100_000
    # trace-scale memory levers: cap the ledger's per-request record list
    # (aggregates + deterministic reservoir percentiles past the cap — see
    # QoSLedger.record_cap) and drop the per-cold-start Breakdown log.
    # Defaults preserve exact historical behavior.
    ledger_record_cap: Optional[int] = None
    keep_phase_log: bool = True


@dataclass
class _Pending:
    inv: Invocation
    arrival: float


class Simulator:
    def __init__(self, trace: Union[Trace, InvocationStream],
                 suite: PolicySuite,
                 cost_model: Optional[CostModel] = None,
                 cfg: Optional[SimConfig] = None,
                 events: Optional[EventLog] = None):
        self.trace = trace
        self.suite = suite
        self.cost_model = cost_model or CostModel()
        self.cfg = cfg or SimConfig()
        self.events = events
        self.state = ClusterState(
            trace.functions,
            num_workers=self.cfg.num_workers,
            worker_memory_mb=self.cfg.worker_memory_mb,
            worker_speed=self.cfg.worker_speed,
            ledger=QoSLedger(horizon=trace.horizon,
                             record_cap=self.cfg.ledger_record_cap),
            tier_footprint_frac=self.cost_model.tier_footprint_frac,
            events=events)
        self.state.ledger.cluster_capacity_gb = self.state.capacity_gb
        self.ledger = self.state.ledger
        self.policy = PolicyDriver(
            suite, rl_miss_window_s=self.cfg.rl_miss_window_s,
            tier_footprint_frac=self.cost_model.tier_footprint_frac)
        self.queue: Deque[_Pending] = deque()
        self._queued_count: Dict[str, int] = defaultdict(int)
        self.pause_pool: int = 0            # available paused containers
        self._events: list = []
        self._seq = itertools.count()
        self._inflight_prewarm: set = set()   # functions being prewarmed
        self.phase_log: List[Breakdown] = []
        self.events_processed = 0         # heap events popped (true
                                          # simulator work; see bench_simcore)
        # incremental arrival cursor: exactly one rank-0 trace arrival is
        # in-heap at a time; the next is pulled when it pops.  seq for
        # rank-0 entries is the stream index, reproducing the tie-break
        # order the old pre-load (seq 0..n-1) produced.
        self._arrival_iter: Optional[Iterator[Invocation]] = None
        self._arr_idx = 0
        self._last_arrival_t = float("-inf")
        # one reusable policy-facing context: it reads cluster state
        # dynamically, so per-dispatch reallocation was pure churn
        self._ctx_obj = ClusterContext(
            self.state, self.cost_model, self.suite,
            queued=self._queued_count.__getitem__)

    # ---- kernel views (back-compat with pre-kernel attribute names) ---- #
    @property
    def now(self) -> float:
        return self.state.now

    @now.setter
    def now(self, t: float) -> None:
        self.state.now = t

    @property
    def containers(self) -> Dict[int, Container]:
        return self.state.containers

    @property
    def worker_used(self) -> List[float]:
        return self.state.worker_used

    @property
    def snapshots(self) -> set:
        return self.state.snapshots

    def _ctx(self) -> ClusterContext:
        return self._ctx_obj

    # ------------------------------------------------------------------ #
    # event plumbing
    # ------------------------------------------------------------------ #
    def _push(self, t: float, kind: str, payload=None):
        # rank 1: dynamic events (ticks, exec_done, expire, chain arrivals,
        # start_done, pool_refill) — always after same-time trace arrivals,
        # exactly the order the old upfront pre-load produced
        heapq.heappush(self._events, (t, 1, next(self._seq), kind, payload))

    def _push_next_arrival(self) -> None:
        """Advance the trace cursor: push the next arrival at rank 0 with
        the stream index as tie-break (the pre-load's seq 0..n-1 order)."""
        assert self._arrival_iter is not None
        for inv in self._arrival_iter:
            if inv.time < self._last_arrival_t:
                raise ValueError(
                    f"trace stream is not time-ordered: invocation at "
                    f"t={inv.time} after t={self._last_arrival_t}")
            self._last_arrival_t = inv.time
            heapq.heappush(self._events,
                           (inv.time, 0, self._arr_idx, "arrival",
                            _Pending(inv, inv.time)))
            self._arr_idx += 1
            return

    def start(self) -> None:
        """Prime the event heap: arrival cursor, prewarm tick, pause pool.
        Split from :meth:`run` so an external orchestrator (the topology
        driver) can interleave several Simulator instances event by
        event."""
        self._arrival_iter = iter(self.trace)
        self._push_next_arrival()
        if self.suite.prewarm is not None:
            self._push(0.0, "tick", None)
        if self.suite.startup.pause_pool_size:
            self.pause_pool = self.suite.startup.pause_pool_size
            footprint = (self.suite.startup.pause_pool_size
                         * self.suite.startup.pause_pool_mb)
            # pool footprint spread across workers
            for w in range(self.cfg.num_workers):
                self.state.reserve(w, footprint / self.cfg.num_workers)

    def next_time(self) -> float:
        """Timestamp of the next pending event (inf when drained)."""
        return self._events[0][0] if self._events else float("inf")

    def step(self) -> None:
        """Pop and process exactly one event."""
        t, rank, _, kind, payload = heapq.heappop(self._events)
        if rank == 0:
            self._push_next_arrival()   # refill the trace cursor
        self.events_processed += 1
        if t > self.trace.horizon and kind == "tick":
            return
        self.state.now = max(self.state.now, t)
        getattr(self, f"_on_{kind}")(payload)

    def inject(self, t: float, inv: Invocation,
               arrival: Optional[float] = None) -> None:
        """Externally inject an arrival at ``t`` (topology routing): the
        request reaches this node at ``t`` but its latency clock started
        at ``arrival`` (the original ingress time), so network delay
        lands in end-to-end latency."""
        self._push(t, "arrival", _Pending(inv, t if arrival is None
                                          else arrival))

    def finish(self) -> QoSLedger:
        """Close out idle accounting at the horizon."""
        self.state.close_out(self.trace.horizon)
        # (legacy generic) pause pool idle cost over whole horizon
        if self.suite.startup.pause_pool_size:
            self.ledger.add_idle(
                self.trace.horizon * self.suite.startup.pause_pool_size,
                self.suite.startup.pause_pool_mb / 1024.0, tier="paused")
        return self.ledger

    def run(self) -> QoSLedger:
        self.start()
        while self._events:
            self.step()
        return self.finish()

    # ------------------------------------------------------------------ #
    # handlers
    # ------------------------------------------------------------------ #
    def _on_arrival(self, pend: _Pending):
        if self.events is not None:
            self.events.arrival(self.now, pend.inv.function)
        self.policy.observe_arrival(pend.inv.function, self.now)
        self._dispatch(pend)

    def _dispatch(self, pend: _Pending):
        ctx = self._ctx()
        fn_name = pend.inv.function
        fn = self.trace.functions[fn_name]
        c = self.suite.placement.choose_container(fn_name, ctx)
        if c is not None:
            self._reuse(c, pend)
            return
        # concurrency slots: join an ACTIVE container with spare capacity
        c = self.state.free_slot(fn_name)
        if c is not None:
            self._begin_exec(c, pend, cold=False)
            return
        # warmth ladder: resume a demoted resident container (paused /
        # snapshot-resident) — far cheaper than a fresh cold start
        c = self.state.best_resident(fn_name)
        if c is not None and self.state.can_promote(c):
            self._promote(c, pend)
            return
        self.policy.on_miss(fn_name, self.now)
        worker = find_worker(self.state, fn, self.suite, ctx)
        if worker is None:
            if len(self.queue) < self.cfg.max_queue:
                self.queue.append(pend)
                self._queued_count[fn_name] += 1
                if self.events is not None:
                    self.events.queue_join(self.now, fn_name)
            else:
                self.ledger.dropped += 1
            return
        self._cold_start(worker, fn, pend)

    def _reuse(self, c: Container, pend: _Pending):
        self.policy.on_reuse(c, self._ctx(), self.now - c.warm_since)
        self._begin_exec(c, pend, cold=False,
                         sanitize=self.cfg.sanitize_on_reuse)

    def _begin_exec(self, c: Container, pend: _Pending, *, cold: bool,
                    bd: Optional[Breakdown] = None,
                    first_run_penalty: float = 0.0,
                    sanitize: Optional[bool] = None):
        # sanitization (state clearing, §6.6) applies only when a request
        # takes over an idle container (sanitize is None otherwise) — not
        # on cold first runs, and not on concurrency-slot joins, which
        # overlap an execution already in flight rather than following one
        self.state.acquire(c, self.now, sanitized=sanitize)
        fn = self.trace.functions[pend.inv.function]
        exec_t = (self.cost_model.exec_time(
            fn, first_run_penalty=first_run_penalty)
            / self.state.speed(c.worker))
        if sanitize:
            exec_t += self.cfg.sanitize_cost_s
        end = self.now + exec_t
        self.state.record_execution(
            c, [(pend.inv.function, pend.arrival)], self.now, end,
            cold=cold, bd=bd)
        self._push(end, "exec_done", (c.id, pend.inv))

    def _cold_start(self, worker: int, fn: FunctionSpec,
                    pend: Optional[_Pending]):
        st = self.suite.startup
        from_pool = self.pause_pool > 0 and st.pause_pool_size > 0
        if from_pool:
            self.pause_pool -= 1
            self._push(self.now + self.cost_model.breakdown(fn).drop(
                Phase.DEPS_LOAD, Phase.CODE_INIT).total, "pool_refill", None)
        tier = self.state.spawn_tier(fn.name, img_cache=st.img_cache)
        bd = self.cost_model.promote_breakdown(
            fn, tier, concurrent_colds=self.state.provisioning_on(worker),
            deps_fraction=st.deps_fraction, from_pause_pool=from_pool)
        bd = scale_breakdown(bd, self.state.speed(worker))
        if self.cfg.keep_phase_log:
            self.phase_log.append(bd)
        c = self.state.admit(fn.name, worker, self.now,
                             has_snapshot=tier == WarmthTier.SNAPSHOT_READY,
                             tier=tier)
        if self.events is not None:
            self.events.startup(self.now, c.id, fn.name, tier, bd)
        if st.snapshot:
            self.state.snapshots.add(fn.name)
        self._push(self.now + bd.total, "start_done", (c.id, pend, bd))

    def _promote(self, c: Container, pend: Optional[_Pending]):
        """Resume a demoted resident container (the ladder's promote edge:
        pay only the phases its tier has not already completed)."""
        fn = self.trace.functions[c.function]
        tier = c.tier
        idle_s = self.now - c.warm_since
        bd = self.cost_model.promote_breakdown(
            fn, tier, concurrent_colds=self.state.provisioning_on(c.worker))
        bd = scale_breakdown(bd, self.state.speed(c.worker))
        if self.cfg.keep_phase_log:
            self.phase_log.append(bd)
        self.policy.on_promote(c, self._ctx(), idle_s, tier)
        self.state.promote_begin(c, self.now)
        if self.events is not None:
            self.events.startup(self.now, c.id, c.function, tier, bd)
        self._push(self.now + bd.total, "start_done", (c.id, pend, bd))

    def _on_start_done(self, payload):
        cid, pend, bd = payload
        c = self.state.containers.get(cid)
        if c is None:
            return
        if pend is None:
            # prewarmed container -> warm idle
            self._inflight_prewarm.discard(c.function)
            self._to_idle(c)
            # a queued request for this function may take it immediately
            self._drain_queue()
            return
        st = self.suite.startup
        penalty = 0.0
        if st.deps_fraction < 1.0 and c.uses == 0:
            fn = self.trace.functions[c.function]
            full = self.cost_model.breakdown(fn).seconds[Phase.DEPS_LOAD]
            penalty = st.first_run_penalty_frac * full * (1 - st.deps_fraction)
        self._begin_exec(c, pend, cold=True, bd=bd,
                         first_run_penalty=penalty)

    def _on_exec_done(self, payload):
        cid, inv = payload
        c = self.state.containers.get(cid)
        if c is None:
            return
        # fire chain successor
        if inv is not None and inv.chain:
            nxt = Invocation(self.now, inv.chain[0], chain=inv.chain[1:])
            self._push(self.now, "arrival", _Pending(nxt, self.now))
        if self.state.release_slot(c, self.now):
            self._to_idle(c)
        self._drain_queue()

    def _to_idle(self, c: Container):
        self.state.to_idle(c, self.now)
        self._arm_edge(c, self.policy.schedule_for(c, self._ctx()))

    def _arm_edge(self, c: Container, sched):
        """Arm the next demotion-schedule edge (or park forever)."""
        if not sched:
            self.state.set_expiry(c, float("inf"))
            return
        (dwell, tier), rest = sched[0], tuple(sched[1:])
        stamp = self.state.set_expiry(c, self.now + dwell)
        self._push(stamp, "expire", (c.id, stamp, tier, rest))

    def _on_expire(self, payload):
        cid, stamp, tier, rest = payload
        c = self.state.transition_valid(cid, stamp)
        if c is None:
            return  # dead, busy again, or superseded by a reuse/promotion
        if tier == WarmthTier.DEAD:
            self.policy.on_expire(c, self.now, self.now - c.warm_since,
                                  tier=c.tier)
            self.state.destroy(c, self.now)
        else:
            self.state.demote(c, tier, self.now)
            self._arm_edge(c, rest)
        self._drain_queue()   # freed footprint may admit queued work

    def _on_pool_refill(self, _):
        if self.pause_pool < self.suite.startup.pause_pool_size:
            self.pause_pool += 1

    def _on_tick(self, _):
        ctx = self._ctx()
        for fn_name in self.policy.prewarm_targets(self.now, ctx):
            if ctx.warm_idle(fn_name) or fn_name in self._inflight_prewarm:
                continue
            if ctx.active_count(fn_name):
                continue
            # a demoted resident beats a fresh spawn: promote it to warm
            c = self.state.best_resident(fn_name)
            if c is not None and self.state.can_promote(c):
                self._inflight_prewarm.add(fn_name)
                self._promote(c, None)
                continue
            fn = self.trace.functions[fn_name]
            worker = find_worker(self.state, fn, self.suite, ctx)
            if worker is None:
                continue
            self._inflight_prewarm.add(fn_name)
            self._cold_start(worker, fn, None)
        if self.now <= self.trace.horizon:
            self._push(self.now + self.suite.prewarm.tick_interval,
                       "tick", None)

    def _queue_leave(self, pend: _Pending):
        if self.events is not None:
            self.events.queue_leave(self.now, pend.inv.function,
                                    self.now - pend.arrival)

    def _drain_queue(self):
        progressed = True
        while self.queue and progressed:
            progressed = False
            pend = self.queue.popleft()
            fn_name = pend.inv.function
            self._queued_count[fn_name] -= 1
            ctx = self._ctx()
            fn = self.trace.functions[fn_name]
            c = self.suite.placement.choose_container(fn_name, ctx)
            if c is not None:
                self._queue_leave(pend)
                self._reuse(c, pend)
                progressed = True
                continue
            c = self.state.free_slot(fn_name)
            if c is not None:
                self._queue_leave(pend)
                self._begin_exec(c, pend, cold=False)
                progressed = True
                continue
            c = self.state.best_resident(fn_name)
            if c is not None and self.state.can_promote(c):
                self._queue_leave(pend)
                self._promote(c, pend)
                progressed = True
                continue
            # same policy-order eviction as the arrival path: a queued
            # request may reclaim warm-idle memory held by other functions
            # (otherwise it stalls until an unrelated TTL expiry)
            worker = find_worker(self.state, fn, self.suite, ctx)
            if worker is not None:
                self._queue_leave(pend)
                self._cold_start(worker, fn, pend)
                progressed = True
            else:
                self.queue.appendleft(pend)
                self._queued_count[fn_name] += 1


def simulate(trace: Union[Trace, InvocationStream], suite: PolicySuite, *,
             cost_model: Optional[CostModel] = None,
             cfg: Optional[SimConfig] = None,
             events: Optional[EventLog] = None) -> QoSLedger:
    return Simulator(trace, suite, cost_model, cfg, events=events).run()
