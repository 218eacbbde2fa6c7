"""Structured per-invocation event log — the observability substrate.

The :class:`~repro.core.metrics.QoSLedger` answers *how much* (aggregate
latency percentiles, GB-s, cold rate); it cannot answer *where one
request's latency went* — queue vs promote vs compile vs execute — or
*which warmth tier* served it.  This module adds that layer: a typed,
JSONL-serializable event stream covering the full container/request
lifecycle, emitted from ONE set of hooks on the shared
:class:`~repro.core.cluster.ClusterState` kernel plus a thin set of
driver-side events (arrival, queue join/leave, startup pricing).

Because both drivers — the event-heap simulator and the clock-driven
fleet — run over the same kernel, they emit the same events at the same
virtual timestamps; :func:`diff_events` asserts sim-vs-fleet identity at
*event* granularity, a far sharper calibration gate than ledger totals.
The real-engine driver emits the same stream with an extra ``wall``
field (wall-clock stamp), which normalization strips, so measured runs
stay schema-compatible with modeled ones — that is what lets
``analyze/calibrate.py`` close the loop from engine measurements back
into ``CostModel.from_calibration``.

Schema (version 2) — every event carries ``t`` (virtual seconds) and
``kind``; per-kind payload fields are listed in :data:`EVENT_SCHEMA`.
Warmth tiers serialize as lowercase names ("dead", "img_cached",
"snapshot_ready", "paused", "warm_idle"); startup phase breakdowns as
``{phase_name: seconds}`` dicts.  Version 2 adds the topology layer
(``repro.topology``): an ``offload`` event kind (the routing decision —
destination node, QoS class, and the network price paid) and an optional
``node`` annotation allowed on ANY kind, stamping which node's cluster
kernel emitted it.  Unlike ``wall``, ``node`` is part of run identity —
normalize() keeps it, so the sim-vs-fleet gate also checks that both
drivers routed every request to the same node.  The version-1 reader
path still works: files without topology fields are valid version-2
streams, and the reader accepts either header version.

Event vocabulary:

  arrival      a request entered the system (driver)
  queue_join   no capacity — the request parked in a queue (driver)
  queue_leave  a queued request got capacity; carries its queue wait (driver)
  spawn        new container admitted, with the tier it spawns FROM (kernel)
  startup      the priced phase breakdown of a spawn/promote (driver —
               emitted right after the cost is known, so the modeled and
               measured paths stamp identically)
  promote      a demoted resident container begins resuming; carries the
               tier promoted FROM (kernel)
  demote       a ladder move down, with old/new tier + new footprint (kernel)
  slot_bind    one execution bound to a container; ``bind`` is the prior
               container state — "warm_idle" = reuse, "active" = concurrency
               slot join, "provisioning" = start/promote completion (kernel)
  exec_start   an execution (possibly micro-batched) began (kernel)
  exec_end     one execution slot released (kernel)
  idle         container turned warm-idle; the keep-warm window opens (kernel)
  expire       container destroyed, from which tier and why ("expire" = TTL
               / ladder death, "evict" = memory pressure) (kernel)
  offload      a topology router sent the request to a node; carries the
               QoS class and the network RTT/transfer cost paid (topology)
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import (Any, Callable, Counter, Dict, Iterable, List, Mapping,
                    Optional, Sequence)

from repro_torch.core.lifecycle import Breakdown, WarmthTier

SCHEMA_NAME = "repro.events"
SCHEMA_VERSION = 2
# older streams this reader still accepts (v1 = v2 minus topology fields)
SUPPORTED_VERSIONS = (1, 2)

TIER_NAMES = tuple(t.name.lower() for t in WarmthTier)

# kind -> {field: type} beyond the universal ``t`` / ``kind``; ``wall``
# (wall-clock stamp, engine runs only) is allowed on any event
EVENT_SCHEMA: Dict[str, Dict[str, type]] = {
    "arrival": {"function": str},
    "queue_join": {"function": str},
    "queue_leave": {"function": str, "wait_s": float},
    "spawn": {"cid": int, "function": str, "worker": int, "tier": str},
    "startup": {"cid": int, "function": str, "tier": str,
                "phases": dict, "total": float},
    "promote": {"cid": int, "function": str, "tier": str},
    "demote": {"cid": int, "function": str, "from_tier": str,
               "to_tier": str, "resident_mb": float},
    "slot_bind": {"cid": int, "function": str, "bind": str},
    "exec_start": {"cid": int, "function": str, "end": float,
                   "cold": bool, "arrivals": list},
    "exec_end": {"cid": int, "function": str},
    "idle": {"cid": int, "function": str, "resident_mb": float},
    "expire": {"cid": int, "function": str, "tier": str, "reason": str},
    "offload": {"function": str, "qos_class": str, "src": str, "dst": str,
                "rtt_s": float, "xfer_s": float},
}

# fields that legitimately differ between modeled and measured runs of the
# same scenario — stripped by normalize() before identity comparison
WALL_FIELDS = ("wall",)

# optional annotations allowed on ANY kind; unlike WALL_FIELDS these are
# part of run identity (normalize() keeps them): topology runs stamp each
# kernel event with the node that emitted it, so sim-vs-fleet identity
# also asserts both drivers routed every request identically
ANNOTATION_FIELDS = ("node",)


def tier_name(tier: Optional[WarmthTier]) -> str:
    return "none" if tier is None else tier.name.lower()


def phases_dict(bd: Optional[Breakdown]) -> Dict[str, float]:
    if bd is None:
        return {}
    return {p.value: s for p, s in bd.seconds.items()}


class EventLog:
    """An append-only event stream plus its run metadata.

    Drivers guard every emission with ``if events is not None`` so the
    default (no log) path stays allocation-free; when a ``wall_clock``
    callable is set (real-engine runs) every event also carries a
    wall-clock stamp.
    """

    __slots__ = ("events", "meta", "wall_clock")

    def __init__(self, meta: Optional[Mapping[str, Any]] = None,
                 wall_clock: Optional[Callable[[], float]] = None):
        self.events: List[Dict[str, Any]] = []
        self.meta: Dict[str, Any] = dict(meta or {})
        self.wall_clock = wall_clock

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    # ------------------------------------------------------------------ #
    def emit(self, kind: str, t: float, **fields) -> None:
        ev = {"t": t, "kind": kind}
        ev.update(fields)
        if self.wall_clock is not None:
            ev["wall"] = self.wall_clock()
        self.events.append(ev)

    # ---- typed emitters (one per schema kind) ------------------------- #
    def arrival(self, t: float, function: str) -> None:
        self.emit("arrival", t, function=function)

    def queue_join(self, t: float, function: str) -> None:
        self.emit("queue_join", t, function=function)

    def queue_leave(self, t: float, function: str, wait_s: float) -> None:
        self.emit("queue_leave", t, function=function, wait_s=wait_s)

    def spawn(self, t: float, cid: int, function: str, worker: int,
              tier: WarmthTier) -> None:
        self.emit("spawn", t, cid=cid, function=function, worker=worker,
                  tier=tier_name(tier))

    def startup(self, t: float, cid: int, function: str,
                tier: WarmthTier, bd: Optional[Breakdown]) -> None:
        ph = phases_dict(bd)
        self.emit("startup", t, cid=cid, function=function,
                  tier=tier_name(tier), phases=ph, total=sum(ph.values()))

    def promote(self, t: float, cid: int, function: str,
                tier: WarmthTier) -> None:
        self.emit("promote", t, cid=cid, function=function,
                  tier=tier_name(tier))

    def demote(self, t: float, cid: int, function: str,
               from_tier: WarmthTier, to_tier: WarmthTier,
               resident_mb: float) -> None:
        self.emit("demote", t, cid=cid, function=function,
                  from_tier=tier_name(from_tier), to_tier=tier_name(to_tier),
                  resident_mb=resident_mb)

    def slot_bind(self, t: float, cid: int, function: str,
                  bind: str) -> None:
        self.emit("slot_bind", t, cid=cid, function=function, bind=bind)

    def exec_start(self, t: float, cid: int, function: str, end: float,
                   cold: bool, arrivals: Sequence[float]) -> None:
        self.emit("exec_start", t, cid=cid, function=function, end=end,
                  cold=cold, arrivals=list(arrivals))

    def exec_end(self, t: float, cid: int, function: str) -> None:
        self.emit("exec_end", t, cid=cid, function=function)

    def idle(self, t: float, cid: int, function: str,
             resident_mb: float) -> None:
        self.emit("idle", t, cid=cid, function=function,
                  resident_mb=resident_mb)

    def expire(self, t: float, cid: int, function: str,
               tier: Optional[WarmthTier], reason: str) -> None:
        self.emit("expire", t, cid=cid, function=function,
                  tier=tier_name(tier), reason=reason)

    def offload(self, t: float, function: str, qos_class: str, src: str,
                dst: str, rtt_s: float, xfer_s: float) -> None:
        self.emit("offload", t, function=function, qos_class=qos_class,
                  src=src, dst=dst, rtt_s=rtt_s, xfer_s=xfer_s)

    # ------------------------------------------------------------------ #
    def counts(self) -> Dict[str, int]:
        c: Counter[str] = Counter()
        for ev in self.events:
            c[ev["kind"]] += 1
        return dict(c)

    # ---- JSONL serialization ------------------------------------------ #
    def write_jsonl(self, path: str) -> None:
        """Header line (schema + run metadata) followed by one event per
        line."""
        with open(path, "w") as f:
            f.write(json.dumps({"schema": SCHEMA_NAME,
                                "version": SCHEMA_VERSION,
                                "meta": self.meta}) + "\n")
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")

    @classmethod
    def read_jsonl(cls, path: str) -> "EventLog":
        log = cls()
        with open(path) as f:
            first = f.readline()
            if not first.strip():
                return log
            head = json.loads(first)
            if head.get("schema") != SCHEMA_NAME:
                raise ValueError(
                    f"{path}: not a {SCHEMA_NAME} file "
                    f"(header schema={head.get('schema')!r})")
            if head.get("version") not in SUPPORTED_VERSIONS:
                raise ValueError(
                    f"{path}: schema version {head.get('version')!r}, "
                    f"this reader supports {SUPPORTED_VERSIONS}")
            log.meta = dict(head.get("meta", {}))
            for line in f:
                line = line.strip()
                if line:
                    log.events.append(json.loads(line))
        return log


# --------------------------------------------------------------------------- #
# validation
# --------------------------------------------------------------------------- #
def validate_events(events: Iterable[Mapping[str, Any]]) -> List[str]:
    """Schema-check an event stream; returns a list of problems (empty =
    valid).  Checks kinds, per-kind required fields and types, tier-name
    vocabulary, and non-decreasing virtual timestamps."""
    problems: List[str] = []
    last_t = float("-inf")
    for i, ev in enumerate(events):
        where = f"event {i}"
        kind = ev.get("kind")
        if kind not in EVENT_SCHEMA:
            problems.append(f"{where}: unknown kind {kind!r}")
            continue
        t = ev.get("t")
        if not isinstance(t, (int, float)):
            problems.append(f"{where} ({kind}): missing/non-numeric t")
        else:
            if t < last_t:
                problems.append(
                    f"{where} ({kind}): t={t} decreases (prev {last_t})")
            last_t = t
        spec = EVENT_SCHEMA[kind]
        for fname, ftype in spec.items():
            if fname not in ev:
                problems.append(f"{where} ({kind}): missing field {fname!r}")
            elif ftype is float:
                if not isinstance(ev[fname], (int, float)):
                    problems.append(
                        f"{where} ({kind}): {fname} is not numeric")
            elif not isinstance(ev[fname], ftype):
                problems.append(
                    f"{where} ({kind}): {fname} is not {ftype.__name__}")
        for tf in ("tier", "from_tier", "to_tier"):
            if tf in spec and ev.get(tf) not in TIER_NAMES + ("none",):
                problems.append(
                    f"{where} ({kind}): bad tier name {ev.get(tf)!r}")
        if "node" in ev and not isinstance(ev["node"], str):
            problems.append(f"{where} ({kind}): node is not a string")
        extra = (set(ev) - set(spec) - {"t", "kind"} - set(WALL_FIELDS)
                 - set(ANNOTATION_FIELDS))
        if extra:
            problems.append(
                f"{where} ({kind}): unexpected fields {sorted(extra)}")
    return problems


# --------------------------------------------------------------------------- #
# normalization + identity diff (the event-granularity calibration gate)
# --------------------------------------------------------------------------- #
def _canon_key(ev: Mapping[str, Any]):
    rest = {k: v for k, v in ev.items()
            if k not in ("t", "kind", "function", "cid")}
    return (ev.get("t", 0.0), ev.get("kind", ""), ev.get("function", ""),
            ev.get("cid", -1), json.dumps(rest, sort_keys=True, default=str))


def normalize(events: Iterable[Mapping[str, Any]]) -> List[Dict[str, Any]]:
    """Canonical form for identity comparison: strip wall-clock fields and
    impose a deterministic order on events sharing one virtual timestamp
    (concurrent events at an instant have no meaningful relative order —
    the two drivers may legally interleave them differently)."""
    out = [{k: v for k, v in ev.items() if k not in WALL_FIELDS}
           for ev in events]
    out.sort(key=_canon_key)
    return out


@dataclass(frozen=True)
class EventDiff:
    """Result of an event-sequence identity comparison."""

    n_a: int
    n_b: int
    first_divergence: Optional[int]           # index into normalized streams
    a_at: Optional[Dict[str, Any]] = None     # the diverging events (or the
    b_at: Optional[Dict[str, Any]] = None     # extra tail element)

    @property
    def identical(self) -> bool:
        return self.first_divergence is None and self.n_a == self.n_b

    def __str__(self) -> str:
        if self.identical:
            return f"events identical ({self.n_a} events)"
        if self.first_divergence is None:
            return f"event counts differ: {self.n_a} vs {self.n_b}"
        return ("events diverge at normalized index "
                f"{self.first_divergence} ({self.n_a} vs {self.n_b} "
                f"events):\n  a: {self.a_at}\n  b: {self.b_at}")


def diff_events(a, b) -> EventDiff:
    """Compare two event streams (EventLogs or event lists) modulo
    wall-clock fields and same-timestamp ordering."""
    na = normalize(a)
    nb = normalize(b)
    for i, (ea, eb) in enumerate(zip(na, nb)):
        if ea != eb:
            return EventDiff(len(na), len(nb), i, ea, eb)
    if len(na) != len(nb):
        i = min(len(na), len(nb))
        longer = na if len(na) > len(nb) else nb
        extra = longer[i]
        return EventDiff(len(na), len(nb), i,
                         extra if len(na) > len(nb) else None,
                         extra if len(nb) > len(na) else None)
    return EventDiff(len(na), len(nb), None)
