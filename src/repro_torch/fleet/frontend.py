"""Fleet gateway: per-function request queues, admission control, SLO
deadlines, and a drop ledger.

The frontend is the API-gateway analogue in front of the engine pool.  It
owns every request between arrival and dispatch:

  * **admission control** — a per-function queue bound (and an optional
    total bound) sheds load at the door instead of letting queues grow
    without limit during a flash crowd;
  * **SLO deadlines** — a request admitted with a deadline is dropped (not
    served late) once the deadline passes while still queued, matching the
    paper's SLA-violation framing of RQ1;
  * **micro-batch selection** — ``take_batch`` pulls the queue head plus any
    later requests that are *shape-compatible* with it (same padded sequence
    length), so the pool can serve them as one batched execution.  Requests
    with other shapes keep their queue position.

Every shed request is tallied by reason in :class:`DropLedger` so the QoS
ledger's single ``dropped`` counter can be decomposed.

The frontend is the one fleet layer with no simulator twin: it owns
*requests* (pre-dispatch), never containers — all container state lives in
the shared :mod:`repro_torch.core.cluster` kernel.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple


@dataclass
class Request:
    """One in-flight invocation (the fleet twin of ``workload.Invocation``)."""

    id: int
    function: str
    arrival: float
    seq_len: int = 32                 # padded prompt length (batching key)
    chain: Tuple[str, ...] = ()       # successor functions (cascade setting)
    deadline: Optional[float] = None  # absolute drop-dead time, None = no SLO

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


@dataclass
class AdmissionConfig:
    max_queue_per_function: int = 100_000
    max_queue_total: int = 1_000_000
    slo_latency_s: Optional[float] = None   # default deadline = arrival + slo


@dataclass
class DropLedger:
    """Sheds by reason — decomposes ``QoSLedger.dropped``."""

    by_reason: Dict[str, int] = field(default_factory=dict)

    def drop(self, reason: str, n: int = 1) -> None:
        self.by_reason[reason] = self.by_reason.get(reason, 0) + n

    @property
    def total(self) -> int:
        return sum(self.by_reason.values())


class Frontend:
    def __init__(self, cfg: Optional[AdmissionConfig] = None):
        self.cfg = cfg or AdmissionConfig()
        self.queues: Dict[str, Deque[Request]] = {}
        self.drops = DropLedger()
        self._total = 0

    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> bool:
        """Admit or shed.  Returns True iff the request was queued."""
        if req.deadline is None and self.cfg.slo_latency_s is not None:
            req.deadline = req.arrival + self.cfg.slo_latency_s
        q = self.queues.setdefault(req.function, deque())
        if (len(q) >= self.cfg.max_queue_per_function
                or self._total >= self.cfg.max_queue_total):
            self.drops.drop("queue_full")
            return False
        q.append(req)
        self._total += 1
        return True

    # ------------------------------------------------------------------ #
    def _shed_expired(self, q: Deque[Request], now: float) -> int:
        shed = 0
        while q and q[0].expired(now):
            q.popleft()
            self._total -= 1
            self.drops.drop("deadline")
            shed += 1
        return shed

    def head(self, function: str, now: float) -> Optional[Request]:
        """Next live request for ``function`` (expired heads are shed)."""
        q = self.queues.get(function)
        if not q:
            return None
        self._shed_expired(q, now)
        return q[0] if q else None

    def take_batch(self, function: str, now: float, max_n: int) -> List[Request]:
        """Pop the head plus up to ``max_n - 1`` later shape-compatible
        requests (same ``seq_len``).  Incompatible requests keep their
        position; expired ones encountered during the scan are shed."""
        q = self.queues.get(function)
        if not q:
            return []
        self._shed_expired(q, now)
        if not q:
            return []
        head = q.popleft()
        self._total -= 1
        batch = [head]
        if max_n > 1:
            keep: List[Request] = []
            while q and len(batch) < max_n:
                r = q.popleft()
                if r.expired(now):
                    self._total -= 1
                    self.drops.drop("deadline")
                elif r.seq_len == head.seq_len:
                    self._total -= 1
                    batch.append(r)
                else:
                    keep.append(r)
            for r in reversed(keep):
                q.appendleft(r)
        return batch

    # ------------------------------------------------------------------ #
    def queued(self, req: Request) -> bool:
        """True iff ``req`` is still waiting in its function's queue
        (event-log attribution only; O(queue depth), so callers guard it
        behind the events-enabled path)."""
        return any(r.id == req.id for r in self.queues.get(req.function, ()))

    def queued_count(self, function: str) -> int:
        return len(self.queues.get(function, ()))

    @property
    def total_queued(self) -> int:
        return self._total

    def pending_functions(self, now: float) -> List[str]:
        """Functions with a live queued request, earliest head first."""
        out = []
        for fn, q in self.queues.items():
            self._shed_expired(q, now)
            if q:
                out.append((q[0].arrival, fn))
        return [fn for _, fn in sorted(out)]
