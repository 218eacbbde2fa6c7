"""Helpers that several metric readers share.  A reader returns ``None``
where its run holds nothing to read (no trace, no cold start, no kernel of
its names): the harness then leaves the metric out of the line."""
from __future__ import annotations

import statistics
from typing import List, Optional

from benchlib import work


def cold_startups(run) -> List:
    """The startup ``Breakdown`` of every cold invoke sent after the traced
    stretch (the profiler slows the launches it records)."""
    return [s.record.startup for s in run.untraced
            if s.record is not None and s.record.cold and s.record.startup is not None]


def mean_phase_ms(run, phase: str) -> Optional[float]:
    startups = cold_startups(run)
    if not startups:
        return None
    return 1e3 * statistics.mean(bd.seconds.get(phase, 0.0) for bd in startups)


def idle_percent(run) -> Optional[float]:
    tr = run.trace
    if tr is None or not tr.device or tr.window_ns <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_ns() / tr.window_ns)


def timed_ms(run, name: str) -> Optional[float]:
    """Mean milliseconds of the replica bundle's ``name`` calls after the traced
    stretch, each between CUDA events recorded around it: from the
    call to the end of the last device work it launched."""
    times = run.timed.get(name)
    return 1e3 * statistics.mean(times) if times else None


def roofline_percent(run, span: str, parts, work_fn) -> Optional[float]:
    """The least time of the traced calls (one a layer in each ``span``,
    ``work_fn(dims, batch, prompt_len)`` each) over the device time of the
    activities named by ``parts``, in percent."""
    tr = run.trace
    if tr is None:
        return None
    ns = tr.kernel_ns(*parts)
    calls = len(tr.spans_named(span)) * run.dims.layers
    if ns <= 0 or calls == 0:
        return None
    t = run.cell.traffic
    flops, nbytes = work_fn(run.dims, t["batch"], t["prompt_len"])
    return 100.0 * calls * work.bound_s(flops, nbytes) / (ns / 1e9)
