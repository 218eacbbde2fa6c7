"""The traced stretch of a ``--trace 1`` run: the device's activities from
torch.profiler, and the benchmark's own spans from the host's clock.

The profiler records device activity alone (host activity would record
every eager op and slow the host-paced decode steps to twice their time);
it starts at the end of set-up, stops at the end of a bounded stretch of
the window (the mix's ``trace``), and is read after the window from its
raw results: building FunctionEvents takes minutes at 10^5 activities, the
raw results do not.  The spans are
the stretch (``window``), each invoke (``request``) and, inside it, the
router's replica start (``cold_start``) and the bundle's ``prefill`` and
``decode``, timed by ``time.perf_counter_ns``.  Two marker kernels
(``torch.cuda._sleep``), launched on an idle device at the stretch's start
and end, put the host's clock on the trace's: each launch's host time
against the marker's device start.  Times are nanoseconds from the trace's
start.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

MARKER = "spin_kernel"           # the kernel of torch.cuda._sleep

Span = Tuple[str, int, int]


@dataclass
class Trace:
    window: Tuple[int, int]
    device: List[Tuple[str, int, int]]            # (name, start, end)
    spans: List[Span] = field(default_factory=list)
    skew_ns: int = 0                              # the two markers' offsets apart

    # ------------------------------------------------------------------ #
    @property
    def window_ns(self) -> int:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device's activities, clipped to the window."""
        w0, w1 = self.window
        out: List[List[int]] = []
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_ns(self) -> int:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_ns(self, *parts: str) -> int:
        """Summed device time of the activities whose name holds one of
        ``parts``."""
        return sum(b - a for name, a, b in self.device if any(p in name for p in parts))

    def spans_named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s[0] == name]

    def by_name(self) -> List[Tuple[str, float]]:
        """Device seconds by activity name, largest first."""
        total: Dict[str, int] = defaultdict(int)
        for name, a, b in self.device:
            total[name] += b - a
        return sorted(((n, t / 1e9) for n, t in total.items()), key=lambda kv: -kv[1])

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Idle device seconds in the window, each gap named by the innermost
        benchmark span the host was in when it began (``between_requests``
        outside every request), largest first."""
        w0, w1 = self.window
        gaps, at = [], w0
        for a, b in self.busy_intervals():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if w1 > at:
            gaps.append((at, w1))
        inner = sorted(self.spans, key=lambda s: s[1])
        starts = [s[1] for s in inner]
        total: Dict[str, int] = defaultdict(int)
        for a, b in gaps:
            label = "between_requests"
            for s in reversed(inner[:bisect.bisect_right(starts, a)]):
                if s[2] >= a:
                    label = s[0] if s[0] == "request" else f"request.{s[0]}"
                    break
            total[label] += b - a
        return sorted(((n, t / 1e9) for n, t in total.items()), key=lambda kv: -kv[1])


def read(prof, host_spans: List[Span], markers: List[int]) -> Trace:
    """The ``Trace`` of a stopped ``torch.profiler.profile`` whose stretch
    began and ended with a marker launched at host times ``markers``
    (``perf_counter_ns``); ``host_spans`` are on the host's clock."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    device, marks = [], []
    for e in results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start, end = e.start_ns() - t0, e.end_ns() - t0
        if MARKER in e.name():
            marks.append((start, end))
        else:
            device.append((e.name(), start, end))
    if len(marks) != 2:
        raise RuntimeError(f"the trace holds {len(marks)} marker kernels, not 2")
    marks.sort()
    device = [e for e in device if e[2] > marks[0][1]]
    offsets = [m[0] - h for m, h in zip(marks, markers)]
    offset = min(offsets)
    spans = [(n, a + offset, b + offset) for n, a, b in host_spans]
    return Trace(window=(marks[0][1], marks[1][0]), device=device, spans=spans,
                 skew_ns=max(offsets) - offset)
