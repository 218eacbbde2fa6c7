"""Shared cluster-runtime kernel: the ONE place container state lives.

Before this module existed the cluster semantics the paper's taxonomy is
evaluated against — the container FSM, keep-warm window τ, memory-pressure
eviction, idle/exec GB-s accounting — were maintained twice: once inside
``core/simulator.py`` and once across ``fleet/pool.py`` +
``fleet/autoscaler.py``.  Every policy or semantics change had to be made in
both places, and sim-vs-fleet calibration held only by accident.  Off-policy
RL keep-alive and SPES-style trade-off tuning additionally require the
*state representation* a policy learns on to be identical to the one it is
deployed on; a shared kernel makes that structural.

This module owns:

  * :class:`ClusterState` — the indexed container registry.  Per-tier,
    per-function idle maps (the warmth ladder: WARM_IDLE, PAUSED,
    SNAPSHOT_READY), per-function spare-concurrency maps, per-function
    active counts, per-worker provisioning counts, a free-capacity segment
    tree over workers, and running per-worker / warm-idle memory totals
    make every hot-path query (``warm_idle``, ``best_resident``,
    ``free_slot``, ``active_count``, ``free_mb``, ``first_fit_worker``,
    ``pressure``) O(1) / O(log W) / O(k) in the *relevant* containers
    instead of O(all containers) linear scans.  All FSM transitions
    (PROVISIONING → WARM_IDLE ⇄ ACTIVE → DEAD plus the graded ladder
    WARM_IDLE → PAUSED → SNAPSHOT_READY → DEAD via ``demote`` /
    ``promote_begin``) go through one private ``_transition`` so the
    indexes can never drift from the authoritative ``Container.state`` —
    drivers never assign ``container.state`` or a warmth tier themselves.
  * :class:`ClusterContext` — the single read-only policy view (``Context``
    protocol) that :mod:`repro.core.policies` consume; the simulator's
    ``SimContext`` and the fleet's ``FleetContext`` are thin aliases.
  * :class:`PolicyDriver` — shared policy-feedback plumbing (prewarm
    observation, RL keep-alive tombstone resolution) used verbatim by the
    simulator and subclassed by the fleet's ``Autoscaler``.
  * One shared :class:`~repro.core.metrics.QoSLedger` accounting path:
    idle GB-s on reuse/evict/close-out, exec GB-s split across concurrency
    slots and micro-batch members, container-launch counts.

Heterogeneity and concurrency both live here so every driver gets them for
free: workers may carry per-worker memory capacities and speed factors
(``worker_memory_mb`` / ``worker_speed`` accept scalars or sequences), and a
container admits up to ``Container.concurrency`` simultaneous executions
(Knative-style ``FunctionSpec.container_concurrency``).

The simulator advances a :class:`ClusterState` by event heap, the fleet by
clock; given the same trace, policy suite, and cost model the two produce
identical ledgers (pinned by ``tests/test_cluster.py`` and the
``bench_fleet.py`` calibration gate).
"""
from __future__ import annotations

from collections import defaultdict
from typing import (Callable, Dict, List, Optional, Sequence, Tuple, Union)

from repro_torch.core.costmodel import TIER_FOOTPRINT_FRAC, CostModel
from repro_torch.core.events import EventLog
from repro_torch.core.lifecycle import (RESIDENT_IDLE_STATES, STATE_TO_TIER,
                                        TIER_TO_STATE, Breakdown, Container,
                                        ContainerState, FunctionSpec, WarmthTier)
from repro_torch.core.metrics import QoSLedger, RequestRecord

Scalar = Union[float, int]


class _FreeCapacityIndex:
    """Max segment tree over per-worker free MB.

    Answers the two placement queries in O(log W) instead of an O(W) scan:
    ``first_at_least(mb)`` — the leftmost worker with that much room
    (first-fit, the base ``Placement`` semantics) — and ``max_free()`` —
    the lowest-index worker with the most room (CAS best-fit).  The kernel
    refreshes a leaf on every memory mutation, so placement stays O(log W)
    even at thousands of workers.
    """

    __slots__ = ("n", "size", "tree")

    def __init__(self, free: Sequence[float]):
        self.n = len(free)
        size = 1
        while size < max(self.n, 1):
            size *= 2
        self.size = size
        self.tree = [float("-inf")] * (2 * size)
        for i, v in enumerate(free):
            self.tree[size + i] = v
        for i in range(size - 1, 0, -1):
            self.tree[i] = max(self.tree[2 * i], self.tree[2 * i + 1])

    def update(self, worker: int, free: float) -> None:
        i = self.size + worker
        self.tree[i] = free
        i //= 2
        while i:
            self.tree[i] = max(self.tree[2 * i], self.tree[2 * i + 1])
            i //= 2

    def first_at_least(self, need: float) -> Optional[int]:
        """Leftmost worker with ``free >= need`` (first-fit), else None."""
        if self.tree[1] < need:
            return None
        i = 1
        while i < self.size:
            i *= 2
            if self.tree[i] < need:
                i += 1
        return i - self.size

    def max_free(self) -> Tuple[int, float]:
        """(worker, free) with the most room; ties to the lowest index."""
        i = 1
        while i < self.size:
            i *= 2
            if self.tree[i] < self.tree[i + 1]:
                i += 1
        return i - self.size, self.tree[i]


def _per_worker(value, num_workers: int, what: str) -> List[float]:
    """Broadcast a scalar or validate a per-worker sequence."""
    if isinstance(value, (int, float)):
        return [float(value)] * num_workers
    out = [float(v) for v in value]
    if len(out) != num_workers:
        raise ValueError(f"{what} has {len(out)} entries for "
                         f"{num_workers} workers")
    return out


def scale_breakdown(bd: Breakdown, speed: float) -> Breakdown:
    """Apply a worker speed factor to a startup breakdown (1.0 = identity,
    returned unchanged so default-config replays stay bit-identical)."""
    if speed == 1.0:
        return bd
    inv = 1.0 / speed
    return Breakdown({p: s * inv for p, s in bd.seconds.items()})


class ClusterState:
    """Indexed container registry + the single FSM transition function.

    Drivers (simulator event loop, fleet runner, serving router) call the
    lifecycle operations — :meth:`admit`, :meth:`acquire`,
    :meth:`release_slot`, :meth:`to_idle`, :meth:`set_expiry`,
    :meth:`destroy` — and read the indexed queries; they never mutate
    ``Container`` state or memory accounting directly.
    """

    def __init__(self, functions: Dict[str, FunctionSpec], *,
                 num_workers: int = 4,
                 worker_memory_mb: Union[Scalar, Sequence[Scalar]] = 16_384.0,
                 worker_speed: Union[Scalar, Sequence[Scalar]] = 1.0,
                 ledger: Optional[QoSLedger] = None,
                 default_concurrency: int = 1,
                 on_destroy: Optional[Callable[[Container], None]] = None,
                 on_demote: Optional[
                     Callable[[Container, WarmthTier], None]] = None,
                 tier_footprint_frac: Optional[
                     Dict[WarmthTier, float]] = None,
                 events: Optional[EventLog] = None):
        self.functions = functions
        self.num_workers = num_workers
        self.worker_memory = _per_worker(worker_memory_mb, num_workers,
                                         "worker_memory_mb")
        self.worker_speed = _per_worker(worker_speed, num_workers,
                                        "worker_speed")
        self.ledger = ledger if ledger is not None else QoSLedger()
        self.default_concurrency = default_concurrency
        self.on_destroy = on_destroy
        self.on_demote = on_demote
        self.tier_footprint_frac = (dict(TIER_FOOTPRINT_FRAC)
                                    if tier_footprint_frac is None
                                    else dict(tier_footprint_frac))
        self.events = events
        self.now = 0.0

        self.containers: Dict[int, Container] = {}
        self.snapshots: set = set()          # functions with a snapshot baked
        self.img_cached: set = set()         # functions whose image is pulled
        self.worker_used: List[float] = [0.0] * num_workers
        self._reserved: List[float] = [0.0] * num_workers
        self._next_cid = 0
        # ---- indexes (all maintained exclusively by _transition & co) ---- #
        # per-tier, per-function maps: _tier_by_fn[state][fn][cid] — one map
        # per resident idle tier so "warmest available" is an O(tiers) probe
        self._tier_by_fn: Dict[ContainerState,
                               Dict[str, Dict[int, Container]]] = {
            s: defaultdict(dict) for s in RESIDENT_IDLE_STATES}
        self._tier_all: Dict[ContainerState, Dict[int, Container]] = {
            s: {} for s in RESIDENT_IDLE_STATES}
        self._spare_by_fn: Dict[str, Dict[int, Container]] = defaultdict(dict)
        self._active_count: Dict[str, int] = defaultdict(int)
        self._prov_by_worker: Dict[int, int] = defaultdict(int)
        self._warm_idle_mb = 0.0
        self._used_mb = 0.0
        self._expiry_stamp: Dict[int, float] = {}
        self._free_index = _FreeCapacityIndex(self.worker_memory)

    # ------------------------------------------------------------------ #
    # derived capacity
    # ------------------------------------------------------------------ #
    @property
    def total_memory_mb(self) -> float:
        return sum(self.worker_memory)

    @property
    def capacity_gb(self) -> float:
        return self.total_memory_mb / 1024.0

    def speed(self, worker: int) -> float:
        return self.worker_speed[worker]

    def memory_of(self, worker: int) -> float:
        return self.worker_memory[worker]

    def free_mb(self, worker: int) -> float:
        return self.worker_memory[worker] - self.worker_used[worker]

    def used_mb(self, worker: Optional[int] = None) -> float:
        """Running memory-in-use total (O(1); no scan)."""
        return self._used_mb if worker is None else self.worker_used[worker]

    def pressure(self, worker: Optional[int] = None) -> float:
        """Fraction of (worker or cluster) memory in use — O(1)."""
        cap = (self.total_memory_mb if worker is None
               else self.worker_memory[worker])
        return self.used_mb(worker) / cap if cap else 0.0

    def warm_idle_mb(self) -> float:
        """Total MB held by warm-idle containers (running counter)."""
        return self._warm_idle_mb

    def reserve(self, worker: int, mb: float) -> None:
        """Static reservation (e.g. a pause pool's footprint) — counted in
        per-worker usage but not tied to any container."""
        self._add_used(worker, mb)
        self._reserved[worker] += mb

    def _add_used(self, worker: int, delta_mb: float) -> None:
        """The one place per-worker memory accounting changes — keeps the
        running totals and the free-capacity index in lockstep."""
        self.worker_used[worker] += delta_mb
        self._used_mb += delta_mb
        self._free_index.update(
            worker, self.worker_memory[worker] - self.worker_used[worker])

    # ------------------------------------------------------------------ #
    # indexed queries
    # ------------------------------------------------------------------ #
    def first_fit_worker(self, need_mb: float) -> Optional[int]:
        """Leftmost worker with ``need_mb`` free — O(log W), no scan."""
        return self._free_index.first_at_least(need_mb)

    def max_free_worker(self) -> Tuple[int, float]:
        """(worker, free MB) with the most room — O(log W), no scan."""
        return self._free_index.max_free()

    def warm_idle(self, function: str) -> List[Container]:
        """Warm-idle containers for ``function`` in registry (cid) order."""
        d = self._tier_by_fn[ContainerState.WARM_IDLE].get(function)
        if not d:
            return []
        return [d[k] for k in sorted(d)]

    def all_warm_idle(self) -> List[Container]:
        """Every warm-idle container in registry (cid) order."""
        d = self._tier_all[ContainerState.WARM_IDLE]
        return [d[k] for k in sorted(d)]

    def resident_idle(self, function: str,
                      state: ContainerState) -> List[Container]:
        """Idle containers for ``function`` in one tier, cid order."""
        d = self._tier_by_fn[state].get(function)
        if not d:
            return []
        return [d[k] for k in sorted(d)]

    def all_resident_idle(self) -> List[Container]:
        """Every idle-resident container (warm, paused, snapshot-resident)
        in registry (cid) order — the pressure-eviction candidate set."""
        out: Dict[int, Container] = {}
        for s in RESIDENT_IDLE_STATES:
            out.update(self._tier_all[s])
        return [out[k] for k in sorted(out)]

    def best_resident(self, function: str) -> Optional[Container]:
        """The warmest *demoted* resident container for ``function``
        (PAUSED before SNAPSHOT_READY; oldest cid wins) — the promote
        candidate when no warm-idle container exists.  O(1) per tier."""
        for state in (ContainerState.PAUSED, ContainerState.SNAPSHOT_READY):
            d = self._tier_by_fn[state].get(function)
            if d:
                return d[min(d)]
        return None

    def free_slot(self, function: str) -> Optional[Container]:
        """An ACTIVE container for ``function`` with a spare concurrency
        slot; least-loaded wins, ties to the oldest container."""
        d = self._spare_by_fn.get(function)
        if not d:
            return None
        best = None
        for k in sorted(d):
            c = d[k]
            if best is None or c.inflight < best.inflight:
                best = c
        return best

    def active_count(self, function: str) -> int:
        """ACTIVE + PROVISIONING containers for ``function`` — O(1)."""
        return self._active_count.get(function, 0)

    def provisioning_on(self, worker: int) -> int:
        """Concurrent cold starts in flight on ``worker`` — O(1)."""
        return self._prov_by_worker.get(worker, 0)

    # ------------------------------------------------------------------ #
    # the FSM transition function (the only place container.state changes)
    # ------------------------------------------------------------------ #
    def _transition(self, c: Container, new: ContainerState) -> None:
        old = c.state
        if old == new:
            return
        if old == ContainerState.PROVISIONING:
            self._prov_by_worker[c.worker] -= 1
        elif old in RESIDENT_IDLE_STATES:
            self._tier_by_fn[old][c.function].pop(c.id, None)
            self._tier_all[old].pop(c.id, None)
            if old == ContainerState.WARM_IDLE:
                self._warm_idle_mb -= c.memory_mb
        elif old == ContainerState.ACTIVE:
            self._spare_by_fn[c.function].pop(c.id, None)
        if old in (ContainerState.PROVISIONING, ContainerState.ACTIVE) and \
                new not in (ContainerState.PROVISIONING, ContainerState.ACTIVE):
            self._active_count[c.function] -= 1
        if new in (ContainerState.PROVISIONING, ContainerState.ACTIVE) and \
                old not in (ContainerState.PROVISIONING, ContainerState.ACTIVE):
            self._active_count[c.function] += 1

        c.state = new

        if new == ContainerState.PROVISIONING:
            self._prov_by_worker[c.worker] += 1
        elif new in RESIDENT_IDLE_STATES:
            self._tier_by_fn[new][c.function][c.id] = c
            self._tier_all[new][c.id] = c
            if new == ContainerState.WARM_IDLE:
                self._warm_idle_mb += c.memory_mb
        elif new == ContainerState.ACTIVE:
            self._update_spare(c)

    def _update_spare(self, c: Container) -> None:
        d = self._spare_by_fn[c.function]
        if c.state == ContainerState.ACTIVE and c.inflight < c.concurrency:
            d[c.id] = c
        else:
            d.pop(c.id, None)

    # ------------------------------------------------------------------ #
    # lifecycle operations
    # ------------------------------------------------------------------ #
    def concurrency_for(self, fn: FunctionSpec) -> int:
        return max(self.default_concurrency, fn.container_concurrency)

    def spawn_tier(self, function: str, *,
                   img_cache: bool = False) -> WarmthTier:
        """The warmth tier a *new* container for ``function`` starts from:
        SNAPSHOT_READY once a snapshot has been baked or written (by the
        legacy ``Startup.snapshot`` path or a ladder demotion),
        IMG_CACHED when image caching is on and the image was pulled before,
        else DEAD.  Both drivers classify spawns through this one function."""
        if function in self.snapshots:
            return WarmthTier.SNAPSHOT_READY
        if img_cache and function in self.img_cached:
            return WarmthTier.IMG_CACHED
        return WarmthTier.DEAD

    def admit(self, function: str, worker: int, now: float, *,
              has_snapshot: bool = False,
              tier: Optional[WarmthTier] = None) -> Container:
        """Place a new PROVISIONING container on ``worker`` (cold start).

        ``tier`` is the warmth tier the spawn starts from (event-log
        attribution only; defaults from ``has_snapshot``)."""
        fn = self.functions[function]
        cid = self._next_cid
        self._next_cid += 1
        c = Container(id=cid, function=function,
                      state=ContainerState.PROVISIONING, worker=worker,
                      memory_mb=fn.memory_mb, created_at=now,
                      has_snapshot=has_snapshot,
                      concurrency=self.concurrency_for(fn),
                      resident_mb=fn.memory_mb)
        self.containers[cid] = c
        self._add_used(worker, fn.memory_mb)
        self.img_cached.add(function)
        self._prov_by_worker[worker] += 1
        self._active_count[function] += 1
        self.ledger.containers_launched += 1
        if self.events is not None:
            if tier is None:
                tier = (WarmthTier.SNAPSHOT_READY if has_snapshot
                        else WarmthTier.DEAD)
            self.events.spawn(now, cid, function, worker, tier)
        return c

    def acquire(self, c: Container, now: float, *,
                sanitized: Optional[bool] = None) -> float:
        """Begin one execution on ``c`` — warm reuse (WARM_IDLE → ACTIVE,
        closing out the idle interval), a concurrency-slot join on an
        already-ACTIVE container, or provisioning completion.  Returns the
        idle seconds burned (0.0 unless this was a warm reuse)."""
        idle_s = 0.0
        prior = c.state
        if c.state == ContainerState.WARM_IDLE:
            idle_s = now - c.warm_since
            self.ledger.add_idle(idle_s, c.resident_mb / 1024.0)
        self._transition(c, ContainerState.ACTIVE)
        c.inflight += 1
        c.uses += 1
        c.last_used = now
        if sanitized is not None:
            c.sanitized = sanitized
        self._update_spare(c)
        if self.events is not None:
            self.events.slot_bind(now, c.id, c.function, prior.value)
        return idle_s

    def release_slot(self, c: Container, now: float) -> bool:
        """End one execution; True iff the container drained (inflight=0)
        and should transition to WARM_IDLE via :meth:`to_idle`."""
        c.inflight -= 1
        self._update_spare(c)
        if self.events is not None:
            self.events.exec_end(now, c.id, c.function)
        return c.inflight == 0

    def to_idle(self, c: Container, now: float) -> None:
        """ACTIVE/PROVISIONING → WARM_IDLE (the keep-warm window opens)."""
        self._transition(c, ContainerState.WARM_IDLE)
        c.warm_since = now
        c.last_used = now
        if self.events is not None:
            self.events.idle(now, c.id, c.function, c.resident_mb)

    # ------------------------------------------------------------------ #
    # the warmth-tier ladder: demote / promote (the ONLY tier mutations)
    # ------------------------------------------------------------------ #
    def _bill_idle(self, c: Container, now: float) -> None:
        """Close out the current idle-tier dwell at its tier footprint."""
        tier = c.tier
        if tier is not None:
            self.ledger.add_idle(now - c.warm_since, c.resident_mb / 1024.0,
                                 tier=c.state.value)

    def demote(self, c: Container, tier: WarmthTier, now: float) -> None:
        """Move an idle-resident container one or more rungs *down* the
        ladder (WARM_IDLE → PAUSED → SNAPSHOT_READY).  Bills the dwell in
        the old tier, shrinks the billed footprint to the new tier's, and
        — for SNAPSHOT_READY — records the written snapshot so future
        spawns of the function restore instead of rebuilding.  Demotion to
        DEAD is :meth:`destroy`."""
        cur = c.tier
        assert cur is not None, f"demote of non-idle container {c.id}"
        assert tier < cur, f"demote must move down the ladder ({cur}->{tier})"
        self._bill_idle(c, now)
        if tier == WarmthTier.DEAD:
            if self.events is not None:
                self.events.expire(now, c.id, c.function, cur, "expire")
            self._destroy_billed(c)
            return
        assert tier in TIER_TO_STATE, \
            (f"{tier!r} is a spawn-only tier — containers can only be "
             f"demoted to {list(TIER_TO_STATE)} or DEAD")
        new_state = TIER_TO_STATE[tier]
        self._transition(c, new_state)
        new_mb = c.memory_mb * self.tier_footprint_frac.get(tier, 1.0)
        self._add_used(c.worker, new_mb - c.resident_mb)
        c.resident_mb = new_mb
        c.warm_since = now
        if tier == WarmthTier.SNAPSHOT_READY:
            self.snapshots.add(c.function)
        self.ledger.demotions += 1
        if self.events is not None:
            self.events.demote(now, c.id, c.function, cur, tier, new_mb)
        if self.on_demote is not None:
            self.on_demote(c, tier)

    def can_promote(self, c: Container) -> bool:
        """Re-inflating to the full footprint must fit on the worker."""
        return self.free_mb(c.worker) >= c.memory_mb - c.resident_mb - 1e-9

    def promote_begin(self, c: Container, now: float) -> WarmthTier:
        """Start resuming a demoted resident container (PAUSED /
        SNAPSHOT_READY → PROVISIONING): bills the dwell, re-inflates the
        footprint, and returns the tier promoted from (the driver prices
        the resume via ``CostModel.promote_breakdown``)."""
        tier = c.tier
        assert tier is not None and tier < WarmthTier.WARM_IDLE, \
            f"promote_begin from non-demoted state {c.state}"
        self._bill_idle(c, now)
        self._transition(c, ContainerState.PROVISIONING)
        self._add_used(c.worker, c.memory_mb - c.resident_mb)
        c.resident_mb = c.memory_mb
        self.ledger.promotions += 1
        if self.events is not None:
            self.events.promote(now, c.id, c.function, tier)
        return tier

    # ------------------------------------------------------------------ #
    def set_expiry(self, c: Container, expiry: float) -> float:
        """Arm the next tier-transition deadline; returns the stamp drivers
        pass back to :meth:`transition_valid` (reuse supersedes stamps)."""
        c.expiry = expiry
        self._expiry_stamp[c.id] = expiry
        return expiry

    def transition_valid(self, cid: int, stamp: float) -> Optional[Container]:
        """The container iff it still sits idle-resident under this exact
        stamp (None when the armed transition was superseded by a reuse, a
        promotion, an eviction, or a later re-arm)."""
        c = self.containers.get(cid)
        if c is None or c.state not in RESIDENT_IDLE_STATES:
            return None
        if self._expiry_stamp.get(cid) != stamp:
            return None
        return c

    def expiry_valid(self, cid: int, stamp: float) -> Optional[Container]:
        """Back-compat alias: valid only for a still-*warm* container."""
        c = self.transition_valid(cid, stamp)
        if c is None or c.state != ContainerState.WARM_IDLE:
            return None
        return c

    def _destroy_billed(self, c: Container) -> None:
        self._transition(c, ContainerState.DEAD)
        self._add_used(c.worker, -c.resident_mb)
        c.resident_mb = 0.0
        self.containers.pop(c.id, None)
        self._expiry_stamp.pop(c.id, None)
        if self.on_destroy is not None:
            self.on_destroy(c)

    def destroy(self, c: Container, now: float, *,
                reason: str = "expire") -> None:
        """Scale-to-zero / eviction: close idle accounting, free memory,
        drop from every index, fire the driver's teardown hook.  ``reason``
        is event-log attribution only ("expire" = TTL / ladder death,
        "evict" = memory pressure)."""
        self._bill_idle(c, now)
        if self.events is not None:
            self.events.expire(now, c.id, c.function, c.tier, reason)
        self._destroy_billed(c)

    # ------------------------------------------------------------------ #
    # the shared QoS accounting path
    # ------------------------------------------------------------------ #
    def record_execution(self, c: Container,
                         items: Sequence[Tuple[str, float]],
                         start: float, end: float, *, cold: bool,
                         bd: Optional[Breakdown] = None) -> None:
        """Record one (possibly micro-batched) execution on one slot of
        ``c``.  The container footprint is statically partitioned across
        its concurrency slots and a micro-batch further splits its slot's
        share, so summed exec GB-s never exceeds container-seconds even
        with overlapping slot executions."""
        mem_gb = c.memory_mb / 1024.0 / c.concurrency / len(items)
        for fn_name, arrival in items:
            rec = RequestRecord(fn_name, arrival, start, end, cold=cold,
                                startup=bd if cold else None)
            self.ledger.record(rec, memory_gb=mem_gb)
        if self.events is not None:
            self.events.exec_start(start, c.id, c.function, end, cold,
                                   [a for _, a in items])

    def close_out(self, horizon: float) -> None:
        """End-of-run idle accounting for containers still idle-resident
        (any warmth tier) at the horizon — each billed at its tier
        footprint."""
        for c in self.containers.values():
            if c.state in RESIDENT_IDLE_STATES:
                end = max(horizon, c.warm_since)
                self.ledger.add_idle(end - c.warm_since,
                                     c.resident_mb / 1024.0,
                                     tier=c.state.value)

    # ------------------------------------------------------------------ #
    # invariant audit (regression harness for the running counters)
    # ------------------------------------------------------------------ #
    def recount(self) -> Dict[str, object]:
        """Brute-force recomputation of every running counter/index from
        the authoritative ``containers`` dict — tests compare this against
        the incrementally-maintained values after long traces."""
        worker_used = [0.0] * self.num_workers
        warm_idle_mb = 0.0
        active: Dict[str, int] = defaultdict(int)
        prov: Dict[int, int] = defaultdict(int)
        tier_ids: Dict[ContainerState, set] = {
            s: set() for s in RESIDENT_IDLE_STATES}
        spare_ids = set()
        for c in self.containers.values():
            worker_used[c.worker] += c.resident_mb
            if c.state == ContainerState.WARM_IDLE:
                warm_idle_mb += c.memory_mb
            if c.state in RESIDENT_IDLE_STATES:
                tier_ids[c.state].add(c.id)
            if c.state in (ContainerState.ACTIVE,
                           ContainerState.PROVISIONING):
                active[c.function] += 1
            if c.state == ContainerState.PROVISIONING:
                prov[c.worker] += 1
            if (c.state == ContainerState.ACTIVE
                    and c.inflight < c.concurrency):
                spare_ids.add(c.id)
        return {
            "worker_used": worker_used,
            "used_mb": sum(worker_used),
            "warm_idle_mb": warm_idle_mb,
            "active_count": dict(active),
            "provisioning": dict(prov),
            "warm_ids": tier_ids[ContainerState.WARM_IDLE],
            "tier_ids": tier_ids,
            "spare_ids": spare_ids,
        }

    def check_counters(self, *, tol: float = 1e-6) -> None:
        """Assert every running counter matches a brute-force recount
        (static :meth:`reserve` footprints, which have no backing
        container, are tracked separately and added back here)."""
        truth = self.recount()
        recounted_total = truth["used_mb"] + sum(self._reserved)
        assert abs(self._used_mb - recounted_total) < tol, \
            (self._used_mb, recounted_total)
        assert abs(self._warm_idle_mb - truth["warm_idle_mb"]) < tol, \
            (self._warm_idle_mb, truth["warm_idle_mb"])
        for w in range(self.num_workers):
            assert abs(self.worker_used[w]
                       - truth["worker_used"][w] - self._reserved[w]) < tol
        for fn, n in truth["active_count"].items():
            assert self._active_count.get(fn, 0) == n, fn
        for fn, n in self._active_count.items():
            assert truth["active_count"].get(fn, 0) == n, fn
        for w, n in truth["provisioning"].items():
            assert self._prov_by_worker.get(w, 0) == n, w
        for w, n in self._prov_by_worker.items():
            assert truth["provisioning"].get(w, 0) == n, w
        for s in RESIDENT_IDLE_STATES:
            assert set(self._tier_all[s]) == truth["tier_ids"][s], s
            assert {cid for d in self._tier_by_fn[s].values() for cid in d} \
                == truth["tier_ids"][s], s
        assert {cid for d in self._spare_by_fn.values() for cid in d} \
            == truth["spare_ids"]
        for w in range(self.num_workers):
            free = self.worker_memory[w] - self.worker_used[w]
            assert abs(self._free_index.tree[self._free_index.size + w]
                       - free) < tol, w


# --------------------------------------------------------------------------- #
# shared worker selection under memory pressure
# --------------------------------------------------------------------------- #


def find_worker(state: ClusterState, fn: FunctionSpec, suite,
                ctx: "ClusterContext") -> Optional[int]:
    """Pick a worker with room for ``fn``; under pressure, evict
    idle-resident containers (any warmth tier — a paused or
    snapshot-resident container frees its footprint too) in policy order
    (computed once, as a batch eviction plan) until the placement policy
    finds room.  Returns None when even a fully drained cluster cannot
    host the function right now."""
    w = suite.placement.choose_worker(fn, ctx)
    if w is not None:
        return w
    for victim in suite.keepalive.evict_order(state.all_resident_idle(), ctx):
        state.destroy(victim, state.now, reason="evict")
        w = suite.placement.choose_worker(fn, ctx)
        if w is not None:
            return w
    return None


# --------------------------------------------------------------------------- #
# the one Context protocol
# --------------------------------------------------------------------------- #


class ClusterContext:
    """The read-only policy view of cluster state — the single ``Context``
    protocol :mod:`repro.core.policies` and :mod:`repro.core.predictors`
    see, whether the kernel underneath is advanced by the simulator's event
    heap or the fleet's clock."""

    __slots__ = ("_state", "_cost_model", "_suite", "_queued", "_now")

    def __init__(self, state: ClusterState, cost_model: CostModel,
                 suite=None,
                 queued: Optional[Callable[[str], int]] = None,
                 now: Optional[float] = None):
        self._state = state
        self._cost_model = cost_model
        self._suite = suite
        self._queued = queued
        self._now = now

    # ---- identity ------------------------------------------------------ #
    @property
    def now(self) -> float:
        return self._state.now if self._now is None else self._now

    @property
    def functions(self) -> Dict[str, FunctionSpec]:
        return self._state.functions

    @property
    def cost_model(self) -> CostModel:
        return self._cost_model

    @property
    def num_workers(self) -> int:
        return self._state.num_workers

    # ---- indexed container queries ------------------------------------- #
    def warm_idle(self, function: str) -> List[Container]:
        return self._state.warm_idle(function)

    def all_warm_idle(self) -> List[Container]:
        return self._state.all_warm_idle()

    def all_resident_idle(self) -> List[Container]:
        return self._state.all_resident_idle()

    def resident_idle(self, function: str,
                      state: ContainerState) -> List[Container]:
        return self._state.resident_idle(function, state)

    def best_resident(self, function: str) -> Optional[Container]:
        return self._state.best_resident(function)

    def free_slot(self, function: str) -> Optional[Container]:
        return self._state.free_slot(function)

    def free_mb(self, worker: int) -> float:
        return self._state.free_mb(worker)

    def first_fit_worker(self, need_mb: float) -> Optional[int]:
        return self._state.first_fit_worker(need_mb)

    def max_free_worker(self) -> Tuple[int, float]:
        return self._state.max_free_worker()

    def worker_speed(self, worker: int) -> float:
        return self._state.speed(worker)

    def active_count(self, function: str) -> int:
        return self._state.active_count(function)

    def queued_count(self, function: str) -> int:
        return self._queued(function) if self._queued is not None else 0

    # ---- pressure / utilization (running counters, no scans) ----------- #
    def used_mb(self, worker: Optional[int] = None) -> float:
        return self._state.used_mb(worker)

    def pressure(self, worker: Optional[int] = None) -> float:
        return self._state.pressure(worker)

    def warm_idle_mb(self) -> float:
        return self._state.warm_idle_mb()

    # ---- cost estimates ------------------------------------------------ #
    def cold_start_estimate(self, function: str) -> float:
        """Seconds a fresh spawn of ``function`` would pay right now,
        given what the cluster has cached (snapshot / image)."""
        fn = self._state.functions[function]
        img = (self._suite is not None
               and getattr(self._suite.startup, "img_cache", False))
        tier = self._state.spawn_tier(function, img_cache=img)
        return self._cost_model.promote_breakdown(fn, tier).total

    def promote_estimate(self, function: str, tier: WarmthTier) -> float:
        """Seconds to bring a resident container up from ``tier``."""
        fn = self._state.functions[function]
        return self._cost_model.promote_breakdown(fn, tier).total


# --------------------------------------------------------------------------- #
# shared policy-feedback plumbing (prewarm observation + RL tombstones)
# --------------------------------------------------------------------------- #


class PolicyDriver:
    """Adapts a :class:`~repro.core.policies.base.PolicySuite` to a running
    cluster: prewarm observation, per-container TTL decisions, pressure
    eviction order, and the RL keep-alive feedback loop.  One
    implementation serves the simulator and (as the fleet's ``Autoscaler``
    subclass) the live fleet, so the reward plumbing an RL policy trains on
    in simulation is the same code it runs on in serving.

    RL tombstone semantics: when an RL-chosen TTL expires, a tombstone is
    parked; the *next* event for that function resolves only the newest
    tombstone (the most recent, best-informed TTL decision) — a miss iff it
    arrives within ``rl_miss_window_s`` of the expiry — and clears the rest
    as stale rather than double-counting them as misses.  With the warmth
    ladder, tombstones carry the tier the container died in, and the idle
    seconds fed back to the agent are weighted by that tier's footprint
    fraction — dying out of PAUSED was 8× cheaper than dying out of
    WARM_IDLE, and the agent's reward sees that.
    """

    def __init__(self, suite, *, rl_miss_window_s: float = 60.0,
                 tier_footprint_frac: Optional[
                     Dict[WarmthTier, float]] = None):
        self.suite = suite
        self.rl_miss_window_s = rl_miss_window_s
        # must match the fracs the kernel bills with (the driver passes its
        # cost model's), or RL rewards diverge from the ledger
        self.tier_footprint_frac = (dict(TIER_FOOTPRINT_FRAC)
                                    if tier_footprint_frac is None
                                    else dict(tier_footprint_frac))
        # function -> [(t_expired, container_id, weighted_idle_s)] pending
        self._rl_tombstones: Dict[str, List[Tuple[float, int, float]]] = \
            defaultdict(list)
        # "is the keep-alive an RLKeepAlive?" is asked on every arrival /
        # reuse / expire; cache the answer per keep-alive object (identity
        # refresh handles suites swapped mid-run) so the hot path pays no
        # per-event module import + isinstance
        self._ka_cache: object = object()
        self._ka_is_rl = False

    def _rl_keepalive(self):
        """The suite's keep-alive iff it is an RLKeepAlive, else None."""
        ka = self.suite.keepalive
        if ka is not self._ka_cache:
            from repro_torch.core.policies.prewarm import RLKeepAlive
            self._ka_cache = ka
            self._ka_is_rl = isinstance(ka, RLKeepAlive)
        return ka if self._ka_is_rl else None

    # ------------------------------------------------------------------ #
    @property
    def tick_interval(self) -> Optional[float]:
        pw = self.suite.prewarm
        return pw.tick_interval if pw is not None else None

    def observe_arrival(self, function: str, now: float) -> None:
        if self.suite.prewarm is not None:
            self.suite.prewarm.observe(function, now)
        lt = getattr(self.suite, "lifetime", None)
        if lt is not None:
            lt.observe(function, now)
        rl = self._rl_keepalive()
        if rl is not None:
            rl.note_arrival(function, now)

    # ------------------------------------------------------------------ #
    def ttl_for(self, container: Container, ctx: ClusterContext) -> float:
        return self.suite.keepalive.ttl(container, ctx)

    def schedule_for(self, container: Container, ctx: ClusterContext) \
            -> List[Tuple[float, WarmthTier]]:
        """The demotion schedule for a freshly idle container: per-edge
        (dwell seconds, next tier) down the ladder.  A suite without a
        ``Lifetime`` policy degenerates to its keep-alive's TTL as the
        single warm→DEAD edge — KeepAlive is the binary special case of
        the ladder.  Edges are normalised to strictly descend."""
        lt = getattr(self.suite, "lifetime", None)
        if lt is None:
            ttl = self.ttl_for(container, ctx)
            if ttl == float("inf"):
                return []
            return [(ttl, WarmthTier.DEAD)]
        edges = lt.schedule(container, ctx)
        out: List[Tuple[float, WarmthTier]] = []
        cur = WarmthTier.WARM_IDLE
        for dwell, tier in edges:
            if dwell == float("inf"):
                break
            tier = WarmthTier(tier)
            if tier >= cur:                 # schedules only move down
                continue
            if tier != WarmthTier.DEAD and tier not in TIER_TO_STATE:
                # IMG_CACHED is a spawn tier, not a resident rung — a
                # container cannot be demoted *to* it; treat as death
                tier = WarmthTier.DEAD
            # the demote work itself (e.g. the snapshot write) extends the
            # dwell in the pre-demotion tier: the container reaches the
            # cheaper footprint only once the edge's work is done
            dwell = max(dwell, 0.0) + \
                ctx.cost_model.demote_cost_s(cur, tier)
            out.append((dwell, tier))
            cur = tier
            if tier == WarmthTier.DEAD:
                break
        return out

    def _tier_frac(self, tier: WarmthTier) -> float:
        return self.tier_footprint_frac.get(tier, 1.0)

    def on_reuse(self, container: Container, ctx: ClusterContext,
                 idle_s: float) -> None:
        self.suite.keepalive.on_reuse(container, ctx)
        rl = self._rl_keepalive()
        if rl is not None:
            rl.resolve(container.id, idle_s=idle_s, missed=False)
        self._resolve_rl_tombstone(container.function, ctx.now, missed=False)

    def on_miss(self, function: str, now: float) -> None:
        """A request found no warm container — a cold start is being paid."""
        self._resolve_rl_tombstone(function, now, missed=True)

    def on_promote(self, container: Container, ctx: ClusterContext,
                   idle_s: float, tier: WarmthTier) -> None:
        """A demoted resident container is being resumed for a request —
        the retention decision *worked* (cheap resume instead of a full
        cold start): resolve the container's pending RL decision as a hit,
        with the idle cost weighted by the tier it waited in."""
        rl = self._rl_keepalive()
        if rl is not None:
            rl.resolve(container.id,
                       idle_s=idle_s * self._tier_frac(tier), missed=False)
        self._resolve_rl_tombstone(container.function, ctx.now, missed=False)

    def on_expire(self, container: Container, now: float, idle_s: float,
                  tier: WarmthTier = WarmthTier.WARM_IDLE) -> None:
        if self._rl_keepalive() is not None:
            self._rl_tombstones[container.function].append(
                (now, container.id, idle_s * self._tier_frac(tier)))

    def _resolve_rl_tombstone(self, function: str, now: float, *,
                              missed: bool) -> None:
        ka = self._rl_keepalive()
        if ka is None:
            return
        stones = self._rl_tombstones.get(function)
        if not stones:
            return
        # only the newest expiry is credited with this outcome; older
        # tombstones are stale (superseded decisions) and dropped
        t_expired, cid, idle_s = stones.pop()
        within = (now - t_expired) <= self.rl_miss_window_s
        ka.resolve(cid, idle_s=idle_s, missed=missed and within)
        stones.clear()

    # ------------------------------------------------------------------ #
    def prewarm_targets(self, now: float, ctx: ClusterContext) -> List[str]:
        pw = self.suite.prewarm
        if pw is None:
            return []
        return pw.decisions(now, ctx)

    def evict_order(self, ctx: ClusterContext) -> List[Container]:
        return self.suite.keepalive.evict_order(ctx.all_warm_idle(), ctx)
