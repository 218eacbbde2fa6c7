"""One entry point for every taxonomy cell: ``run(scenario, driver=...)``.

The port of ``repro.experiments.runner``.  It runs the ``sim`` and
``batch`` drivers; ``fleet``, ``engine`` and scenarios with a topology
raise ``NotImplementedError`` until the router and fleet slice
(ROADMAP A2).  ``batch`` runs on ``device`` ("cuda" unless the caller asks
for "cpu"); ``sim`` is the host's event heap and takes no device.

Drivers of the reference:
  sim     discrete-event simulator (``core/simulator.py``) — cost-model
          time, fully deterministic;
  fleet   concurrent fleet on a virtual clock (``fleet/loadgen.py``) —
          frontend queues, autoscaler, micro-batching, modeled backend;
  engine  the fleet loop on a scaled wall clock with REAL JAX engines
          (``serving`` backend): cold starts pay genuine XLA compiles.

All three return the same :class:`~repro.core.metrics.QoSLedger` schema,
and :func:`compare` turns two ledgers into a field-for-field diff — the
sim-vs-fleet ledger-identity gate as a library call.

Every driver also accepts an ``events=`` :class:`~repro.core.events.EventLog`
and emits the same typed per-invocation event stream; passing the captured
logs to ``compare(..., events_a=, events_b=)`` tightens the identity gate
from ledger totals to *event-sequence* identity (modulo wall-clock fields).
"""
from __future__ import annotations

import json
import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import (Callable, Dict, Iterator, List, Optional, Tuple, Union)

from repro_torch.core.events import EventDiff, EventLog, diff_events
from repro_torch.core.metrics import QoSLedger
from repro_torch.experiments import registry
from repro_torch.experiments.spec import Scenario
from repro_torch.experiments.sweep import Sweep

DRIVERS = ("sim", "fleet", "engine", "batch")


def not_ported(what: str) -> str:
    """Why a driver of the reference is refused: it is not ported yet."""
    return (f"the PyTorch port has no {what} yet (ROADMAP A2: the router, "
            "fleet, engine and topology drivers); run it with the JAX "
            "package, or with driver='sim' or 'batch'")

# traces are deterministic in (workload spec, derived seed), so scenario
# grids that share a workload reuse one build instead of regenerating it
# per policy point (the drivers never mutate a Trace).  True LRU: a hit
# refreshes recency, so a hot trace survives a sweep whose other axes
# churn the cache.
_TRACE_CACHE: "OrderedDict[str, object]" = OrderedDict()
_TRACE_CACHE_MAX = 32


def build_trace(scenario: Scenario):
    from repro_torch.core.workload import STREAMING_GENERATORS
    if scenario.workload.generator in STREAMING_GENERATORS:
        # streamed sources are lazy handles (cheap to rebuild, re-iterable,
        # deterministic per pass) — caching one would pin nothing useful
        # and the LRU must never hold a multi-day iterator's state
        return scenario.trace()
    key = json.dumps({"w": scenario.workload.to_dict(),
                      "seed": scenario.seed}, sort_keys=True)
    if key in _TRACE_CACHE:
        _TRACE_CACHE.move_to_end(key)
    else:
        while len(_TRACE_CACHE) >= _TRACE_CACHE_MAX:
            _TRACE_CACHE.popitem(last=False)
        _TRACE_CACHE[key] = scenario.trace()
    return _TRACE_CACHE[key]


def run(scenario: Union[str, Scenario], driver: str = "sim", *,
        cost_model=None, events: Optional[EventLog] = None,
        device="cuda"):
    """Run one scenario under one driver; returns its QoS ledger.

    sim/fleet/engine return a :class:`~repro.core.metrics.QoSLedger`;
    ``driver="batch"`` returns a :class:`~repro.core.batchsim.BatchLedger`
    (same ``summary()`` schema, percentiles NaN — see docs/batchsim.md).

    ``events`` (optional) captures the typed per-invocation event stream
    — the same schema from every driver, so streams are diffable."""
    sc = registry.resolve(scenario)
    if driver not in DRIVERS:
        raise ValueError(f"unknown driver {driver!r}; one of {DRIVERS}")
    cm = cost_model if cost_model is not None else sc.cost_model()
    if sc.topology is not None:
        # edge–cloud topology axis: one cluster kernel per node tier, the
        # shared router on top (repro.topology.driver); returns a
        # TopologyLedger (merged summary() schema + per-node/per-class
        # breakdown keys)
        if driver not in ("sim", "fleet"):
            raise ValueError(
                f"scenario {sc.name!r} has a topology; driver {driver!r} "
                "is not supported (topology runs need per-node kernels — "
                "use driver='sim' or 'fleet')")
        raise NotImplementedError(not_ported("topology driver"))
    if driver == "batch":
        if events is not None:
            raise ValueError("driver='batch' keeps aggregates, not "
                             "per-invocation events; use driver='sim'")
        from repro_torch.core.batchsim import simulate_batch
        return simulate_batch([sc], cost_model=cost_model,
                              trace_fn=build_trace, device=device)[0]
    if driver != "sim":
        raise NotImplementedError(not_ported(f"{driver} driver"))
    trace = build_trace(sc)
    if events is not None:
        events.meta.setdefault("scenario", sc.name)
        events.meta.setdefault("driver", driver)
    from repro_torch.core.simulator import simulate
    return simulate(trace, sc.suite(), cost_model=cm,
                    cfg=sc.sim_config(), events=events)


def summarize(scenario: Union[str, Scenario], ledger) -> Dict[str, float]:
    """Ledger summary with the scenario's SLA threshold applied."""
    sc = registry.resolve(scenario)
    return ledger.summary(sla_latency_s=sc.slo_latency_s)


def run_summary(scenario: Union[str, Scenario], driver: str = "sim", *,
                cost_model=None, device="cuda") -> Dict[str, float]:
    sc = registry.resolve(scenario)
    return summarize(sc, run(sc, driver, cost_model=cost_model,
                             device=device))


# callback invoked after each finished sweep cell: (index_1based, total,
# scenario, summary) — the CLI's --progress prints one line per call
ProgressFn = Callable[[int, int, Scenario, Dict[str, float]], None]


def run_sweep(sweep: Union[str, Sweep], driver: Optional[str] = None, *,
              cost_model=None, progress: Optional[ProgressFn] = None,
              max_cells: Optional[int] = None, device="cuda") \
        -> Iterator[Tuple[Scenario, Dict[str, float]]]:
    """Yield ``(scenario, summary)`` for every cell of a sweep grid.

    ``driver="batch"`` advances the whole grid in one launch of the hand
    kernel on ``device`` (``repro_torch.core.batchsim``; the plain torch
    loop when ``device="cpu"``) and yields the reconstructed per-cell
    summaries in grid order.  ``max_cells`` refuses oversized grids with
    a clear error instead of silently grinding through them; ``progress``
    is called after each cell (batch: after the batched run completes).
    """
    sw = registry.resolve_sweep(sweep)
    drv = driver or sw.driver
    n = len(sw)
    if max_cells is not None and n > max_cells:
        raise ValueError(
            f"sweep {sw.name!r} has {n} cells, over the max_cells={max_cells}"
            f" guard — narrow the grid or raise the limit (CLI: --max-cells)")
    cells = sw.scenarios()
    if drv == "batch":
        from repro_torch.core.batchsim import simulate_batch
        ledgers = simulate_batch(cells, cost_model=cost_model,
                                 trace_fn=build_trace, device=device)
        for i, (sc, led) in enumerate(zip(cells, ledgers)):
            s = summarize(sc, led)
            if progress is not None:
                progress(i + 1, n, sc, s)
            yield sc, s
        return
    for i, sc in enumerate(cells):
        s = run_summary(sc, drv, cost_model=cost_model, device=device)
        if progress is not None:
            progress(i + 1, n, sc, s)
        yield sc, s


# --------------------------------------------------------------------------- #
# the ledger diff: sim-vs-fleet identity as a library call
# --------------------------------------------------------------------------- #
_MISSING = "<missing>"        # a field absent from one summary is never
                              # "same" — schema divergence counts as drift


@dataclass(frozen=True)
class FieldDiff:
    a: float
    b: float

    @property
    def same(self) -> bool:
        if _MISSING in (self.a, self.b):
            return False
        if isinstance(self.a, float) and isinstance(self.b, float) \
                and math.isnan(self.a) and math.isnan(self.b):
            return True
        return self.a == self.b

    @property
    def delta(self) -> float:
        try:
            return self.b - self.a
        except TypeError:
            return float("nan")


@dataclass(frozen=True)
class LedgerDiff:
    fields: Dict[str, FieldDiff]
    events: Optional[EventDiff] = None    # set when event logs were compared

    @property
    def identical(self) -> bool:
        if self.events is not None and not self.events.identical:
            return False
        return all(f.same for f in self.fields.values())

    def drift(self) -> List[str]:
        """Names of fields that differ (plus "events" on stream drift)."""
        out = [k for k, f in self.fields.items() if not f.same]
        if self.events is not None and not self.events.identical:
            out.append("events")
        return out

    def __str__(self) -> str:
        ev = "" if self.events is None else f"; {self.events}"
        if self.identical:
            return f"identical ({len(self.fields)} fields){ev}"
        rows = [f"  {k}: {f.a!r} != {f.b!r} (delta {f.delta:+.6g})"
                for k, f in self.fields.items() if not f.same]
        return "ledger drift in {} of {} fields:\n{}{}".format(
            len(rows), len(self.fields), "\n".join(rows), ev)


def compare(a: Union[QoSLedger, Dict[str, float]],
            b: Union[QoSLedger, Dict[str, float]], *,
            events_a=None, events_b=None) -> LedgerDiff:
    """Field-for-field diff of two ledgers (or summary dicts).

    ``compare(run(sc, "sim"), run(sc, "fleet")).identical`` is the
    sim-vs-fleet calibration gate; NaN == NaN (empty percentile fields),
    but a key present on only one side is always drift (schema check).

    Passing the two runs' captured :class:`~repro.core.events.EventLog`\\ s
    (or raw event lists) via ``events_a``/``events_b`` extends the gate to
    event-sequence identity: the result is ``identical`` only if the
    normalized streams match event for event (wall-clock fields and
    same-timestamp interleavings excluded).
    """
    sa = a.summary() if hasattr(a, "summary") else dict(a)
    sb = b.summary() if hasattr(b, "summary") else dict(b)
    keys = sorted(set(sa) | set(sb))
    ev = None
    if events_a is not None and events_b is not None:
        ev = diff_events(events_a, events_b)
    return LedgerDiff({k: FieldDiff(sa.get(k, _MISSING), sb.get(k, _MISSING))
                       for k in keys}, events=ev)
