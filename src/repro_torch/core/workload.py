"""Workload traces: deterministic seeded generators + streaming ingestion.

Families cover the regimes the surveyed papers evaluate on: steady Poisson,
bursty on/off, diurnal (sinusoidal rate), flash crowd (sudden spike — the
concurrency factor of RQ2), cold-heavy Zipf application mixes (the Azure
FaaS trace shape: a few hot functions + a long tail of rare ones), and
function *chains* (Xanadu/fusion material).

Two trace representations share one contract (:class:`InvocationStream`):

* :class:`Trace` — the materialized list (every classic generator).
* :class:`StreamedTrace` — a re-iterable, bounded-memory source for
  production-trace scale: the Azure Functions 2019 per-minute CSV format
  (:func:`azure_csv`), per-function IAT text files in the
  ``faas-offloading-sim`` idiom (:func:`iat_files`), and the offline
  :func:`azure_full` synthetic calibrated to the published Azure
  distributions (Zipf popularity, per-minute count shapes, diurnal
  envelope), which can emit 50k functions over multi-day horizons lazily.

The simulator consumes either without materializing (docs/traces.md).
"""
from __future__ import annotations

import csv
import dataclasses
import gzip
import heapq
import math
import os
import warnings
import zlib
from dataclasses import dataclass
from typing import (Callable, Dict, Iterable, Iterator, List, Mapping,
                    Optional, Sequence, Tuple, Union)

import numpy as np

from repro_torch.core.lifecycle import FunctionSpec


@dataclass(frozen=True)
class Invocation:
    time: float
    function: str
    chain: Tuple[str, ...] = ()       # successor calls (sequential chain)


@dataclass
class Trace:
    invocations: List[Invocation]
    functions: Dict[str, FunctionSpec]
    horizon: float

    def __post_init__(self):
        # sort only when actually out of order: one O(n) monotonicity pass
        # replaces the unconditional O(n log n) sort (generators that emit
        # time-ordered already — poisson, bursty, diurnal, flash_crowd,
        # chains — skip the sort entirely at trace scale)
        inv = self.invocations
        if any(inv[i].time > inv[i + 1].time for i in range(len(inv) - 1)):
            inv.sort(key=lambda i: i.time)
        self._times_by_fn: Optional[Dict[str, np.ndarray]] = None

    def __iter__(self) -> Iterator[Invocation]:
        return iter(self.invocations)

    @property
    def rate(self) -> float:
        return len(self.invocations) / self.horizon if self.horizon else 0.0

    # ------------------------------------------------------------------ #
    # cached per-function time index: one pass over the trace builds every
    # function's sorted arrival-time array, so per-function queries
    # (predictor studies, tier-ladder tuning, benchmarks) stop rescanning
    # the whole invocation list per call
    # ------------------------------------------------------------------ #
    def times_for(self, function: str, *, start: Optional[float] = None,
                  end: Optional[float] = None) -> np.ndarray:
        """Sorted arrival times of ``function`` (cached, built lazily).

        ``start``/``end`` return only the half-open window ``[start, end)``
        — an O(log n) slice of the cached array, so windowed predictor
        lookups never touch the whole trace."""
        if self._times_by_fn is None:
            by_fn: Dict[str, List[float]] = {}
            for inv in self.invocations:       # already time-sorted
                by_fn.setdefault(inv.function, []).append(inv.time)
            self._times_by_fn = {fn: np.asarray(ts, dtype=np.float64)
                                 for fn, ts in by_fn.items()}
        times = self._times_by_fn.get(function, np.array([]))
        return _window(times, start, end)

    def interarrival(self, function: str) -> np.ndarray:
        """Gaps between successive invocations of ``function``."""
        times = self.times_for(function)
        return np.diff(times) if len(times) > 1 else np.array([])

    def counts_by_function(self) -> Dict[str, int]:
        """Invocation counts per function (from the cached index)."""
        self.times_for("")            # force the index
        return {fn: len(ts) for fn, ts in self._times_by_fn.items()}


def _window(times: np.ndarray, start: Optional[float],
            end: Optional[float]) -> np.ndarray:
    if start is None and end is None:
        return times
    lo = 0 if start is None else int(np.searchsorted(times, start, "left"))
    hi = len(times) if end is None else int(np.searchsorted(times, end,
                                                            "left"))
    return times[lo:hi]


def _mk_functions(n: int, *, package_mb=64.0, memory_mb=1024.0,
                  exec_time_s=0.08, runtime="python-jit",
                  **spec_kw) -> Dict[str, FunctionSpec]:
    """Extra ``spec_kw`` pass straight to FunctionSpec (e.g.
    ``container_concurrency`` for Knative-style slot-sharing scenarios)."""
    return {
        f"fn{i}": FunctionSpec(
            name=f"fn{i}", package_mb=package_mb, memory_mb=memory_mb,
            exec_time_s=exec_time_s, runtime=runtime, **spec_kw)
        for i in range(n)
    }


def poisson(rate: float, horizon: float, *, num_functions: int = 1,
            seed: int = 0, zipf_a: float = 1.2, **fn_kw) -> Trace:
    """Poisson arrivals; functions chosen from a Zipf popularity law."""
    rng = np.random.default_rng(seed)
    fns = _mk_functions(num_functions, **fn_kw)
    names = list(fns)
    t, inv = 0.0, []
    ranks = np.arange(1, num_functions + 1, dtype=np.float64) ** -zipf_a
    probs = ranks / ranks.sum()
    while True:
        t += rng.exponential(1.0 / rate)
        if t >= horizon:
            break
        inv.append(Invocation(t, names[rng.choice(num_functions, p=probs)]))
    return Trace(inv, fns, horizon)


def _thinned(rng, horizon: float, rate_fn, r_max: float):
    """Inhomogeneous Poisson via thinning (never steps over rate changes)."""
    t, out = 0.0, []
    while True:
        t += rng.exponential(1.0 / r_max)
        if t >= horizon:
            return out
        if rng.random() < rate_fn(t) / r_max:
            out.append(t)


def bursty(base_rate: float, burst_rate: float, horizon: float, *,
           period: float = 60.0, duty: float = 0.2, num_functions: int = 1,
           seed: int = 0, **fn_kw) -> Trace:
    """On/off bursts: rate alternates base <-> burst with given duty cycle."""
    rng = np.random.default_rng(seed)
    fns = _mk_functions(num_functions, **fn_kw)
    names = list(fns)
    rate = lambda t: burst_rate if (t % period) < duty * period else base_rate
    inv = [Invocation(t, names[rng.integers(num_functions)])
           for t in _thinned(rng, horizon, rate, burst_rate)]
    return Trace(inv, fns, horizon)


def diurnal(peak_rate: float, horizon: float, *, period: float = 600.0,
            floor: float = 0.05, num_functions: int = 1, seed: int = 0,
            **fn_kw) -> Trace:
    """Sinusoidal rate (thinned Poisson)."""
    rng = np.random.default_rng(seed)
    fns = _mk_functions(num_functions, **fn_kw)
    names = list(fns)
    t, inv = 0.0, []
    while t < horizon:
        t += rng.exponential(1.0 / peak_rate)
        if t >= horizon:
            break
        phase = 0.5 * (1 - math.cos(2 * math.pi * t / period))
        if rng.random() < floor + (1 - floor) * phase:
            inv.append(Invocation(t, names[rng.integers(num_functions)]))
    return Trace(inv, fns, horizon)


def flash_crowd(base_rate: float, spike_rate: float, horizon: float, *,
                spike_at: float = 0.5, spike_len: float = 10.0,
                num_functions: int = 1, seed: int = 0, **fn_kw) -> Trace:
    """Steady traffic with one sudden spike (concurrency / RQ2 factor)."""
    rng = np.random.default_rng(seed)
    fns = _mk_functions(num_functions, **fn_kw)
    names = list(fns)
    t0 = spike_at * horizon
    rate = lambda t: spike_rate if t0 <= t < t0 + spike_len else base_rate
    inv = [Invocation(t, names[rng.integers(num_functions)])
           for t in _thinned(rng, horizon, rate, spike_rate)]
    return Trace(inv, fns, horizon)


def rare(inter_arrival: float, horizon: float, *, jitter: float = 0.3,
         num_functions: int = 1, seed: int = 0, **fn_kw) -> Trace:
    """Sparse, roughly periodic invocations — the keep-alive-defeating case
    (every gap exceeds the provider's fixed τ)."""
    rng = np.random.default_rng(seed)
    fns = _mk_functions(num_functions, **fn_kw)
    inv = []
    for name in fns:
        t = rng.uniform(0, inter_arrival)
        while t < horizon:
            inv.append(Invocation(t, name))
            t += inter_arrival * (1 + jitter * (rng.random() - 0.5) * 2)
    return Trace(inv, fns, horizon)


def chains(rate: float, horizon: float, *, chain_len: int = 3, seed: int = 0,
           **fn_kw) -> Trace:
    """Sequential function chains (stage0 -> stage1 -> ...): the cascading
    cold-start setting of Xanadu / function-fusion."""
    rng = np.random.default_rng(seed)
    fns = _mk_functions(chain_len, **fn_kw)
    names = list(fns)
    for i, n in enumerate(names[:-1]):
        fns[n] = dataclasses.replace(fns[n], chain=(names[i + 1],))
    t, inv = 0.0, []
    while True:
        t += rng.exponential(1.0 / rate)
        if t >= horizon:
            break
        inv.append(Invocation(t, names[0], chain=tuple(names[1:])))
    return Trace(inv, fns, horizon)


def azure_like(horizon: float, *, num_functions: int = 40, seed: int = 0,
               **fn_kw) -> Trace:
    """Azure-functions-trace-shaped mix: log-uniform per-function rates over
    ~4 decades, so a few functions are hot and most are cold-start-prone."""
    rng = np.random.default_rng(seed)
    fns = _mk_functions(num_functions, **fn_kw)
    inv = []
    for i, name in enumerate(fns):
        lam = 10 ** rng.uniform(-3.2, 0.7)     # per-second rate
        t = rng.exponential(1.0 / lam)
        while t < horizon:
            inv.append(Invocation(t, name))
            t += rng.exponential(1.0 / lam)
    return Trace(inv, fns, horizon)


def cron_spikes(horizon: float, *, num_functions: int = 8,
                base_gap_s: float = 240.0, spike_gap_s: float = 75.0,
                spike_period_s: float = 7200.0, jitter: float = 0.04,
                seed: int = 0, **fn_kw) -> Trace:
    """Timer-triggered functions with a phase-locked early re-fire.

    Each function invokes roughly every ``base_gap_s`` (± ``jitter``), but
    once per ``spike_period_s`` cycle — when an arrival lands in the first
    ``base_gap_s``-wide slot of the cycle — it re-fires after the much
    shorter ``spike_gap_s`` (an hourly-cron double-fire / retry).  The
    re-fire is *deterministic in wall-clock phase* but a small fraction of
    the gap mass, so per-function marginal gap quantiles (histogram-family
    predictors) sit far above it while a sequence model that sees
    time-of-day features can anticipate it — the workload regime where
    ML-based CSF prediction has headroom over application-knowledge
    baselines."""
    rng = np.random.default_rng(seed)
    fns = _mk_functions(num_functions, **fn_kw)
    inv = []
    for name in fns:
        t = rng.uniform(0, base_gap_s)
        last_spike_cycle = -1
        while t < horizon:
            inv.append(Invocation(t, name))
            cycle = int(t // spike_period_s)
            if cycle != last_spike_cycle and (t % spike_period_s) < base_gap_s:
                gap, last_spike_cycle = spike_gap_s, cycle
            else:
                gap = base_gap_s
            t += gap * (1 + jitter * (rng.random() - 0.5) * 2)
    return Trace(inv, fns, horizon)


# --------------------------------------------------------------------------- #
# the streaming trace layer: bounded-memory invocation sources
# --------------------------------------------------------------------------- #


class InvocationStream:
    """The contract every workload source satisfies (docs/traces.md).

    * ``functions``  — ``Dict[str, FunctionSpec]`` (all functions that may
      appear in the stream);
    * ``horizon``    — seconds; no invocation time reaches it;
    * ``__iter__``   — yields :class:`Invocation` in non-decreasing time
      order; each call returns a FRESH pass (re-iterable), and a pass
      holds O(live window) memory, never O(trace).

    :class:`Trace` satisfies it by iterating its materialized list;
    :class:`StreamedTrace` satisfies it lazily.  Drivers consume the
    protocol, so ``simulate(azure_csv(path), suite)`` never builds the
    invocation list.
    """

    functions: Dict[str, FunctionSpec]
    horizon: float

    def __iter__(self) -> Iterator[Invocation]:   # pragma: no cover
        raise NotImplementedError


class StreamedTrace(InvocationStream):
    """A re-iterable, bounded-memory invocation source.

    ``factory()`` must return a fresh time-ordered iterator on every call
    (determinism across passes is the factory's contract — all in-repo
    factories reseed their RNG per pass).  Accessing ``.invocations``
    raises instead of silently materializing; use :func:`materialize`
    when a list is genuinely wanted (tests, the batch driver).
    """

    def __init__(self, factory: Callable[[], Iterator[Invocation]],
                 functions: Dict[str, FunctionSpec], horizon: float, *,
                 name: str = "stream",
                 approx_invocations: Optional[int] = None):
        self.factory = factory
        self.functions = functions
        self.horizon = horizon
        self.name = name
        self.approx_invocations = approx_invocations

    def __iter__(self) -> Iterator[Invocation]:
        return self.factory()

    @property
    def invocations(self):
        raise TypeError(
            f"StreamedTrace {self.name!r} does not materialize "
            ".invocations — iterate it (bounded memory), or call "
            "workload.materialize(stream) if a full list is really needed")

    @property
    def rate(self) -> float:
        n = self.approx_invocations
        if n is None:
            n = sum(1 for _ in self)
            self.approx_invocations = n
        return n / self.horizon if self.horizon else 0.0

    # windowed per-function queries: one bounded pass, O(matches) memory —
    # never the full-trace index a materialized Trace caches
    def times_for(self, function: str, *, start: Optional[float] = None,
                  end: Optional[float] = None) -> np.ndarray:
        out = []
        for inv in self:
            if end is not None and inv.time >= end:
                break
            if inv.function == function and \
                    (start is None or inv.time >= start):
                out.append(inv.time)
        return np.asarray(out, dtype=np.float64)

    def interarrival(self, function: str) -> np.ndarray:
        times = self.times_for(function)
        return np.diff(times) if len(times) > 1 else np.array([])

    def counts_by_function(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for inv in self:
            counts[inv.function] = counts.get(inv.function, 0) + 1
        return counts


def as_stream(trace: Trace) -> StreamedTrace:
    """A :class:`StreamedTrace` view over a materialized trace — the
    "streamed twin" used by the ledger-identity tests: same invocations,
    consumed through the streaming driver path."""
    return StreamedTrace(lambda: iter(trace.invocations), trace.functions,
                         trace.horizon, name="as_stream",
                         approx_invocations=len(trace.invocations))


def materialize(source: Union[Trace, StreamedTrace], *,
                max_invocations: int = 2_000_000) -> Trace:
    """Flatten any invocation source into a materialized :class:`Trace`.

    Guarded: a multi-day 50k-function stream materializes to GBs, so
    anything past ``max_invocations`` raises instead of silently eating
    the host's memory (raise the cap explicitly when you mean it)."""
    if isinstance(source, Trace):
        return source
    inv: List[Invocation] = []
    for i in source:
        inv.append(i)
        if len(inv) > max_invocations:
            raise MemoryError(
                f"materialize({getattr(source, 'name', 'stream')!r}) "
                f"passed {max_invocations} invocations — this source is "
                "meant to be streamed; raise max_invocations to override")
    return Trace(inv, dict(source.functions), source.horizon)


def _stream_seed(seed: int, component: str) -> int:
    """Stable sub-seed (mirrors ``experiments.spec.derive_seed`` without
    importing it — workload stays import-light)."""
    return zlib.crc32(f"{seed}:{component}".encode()) & 0x7FFFFFFF


def azure_full(horizon: float, *, num_functions: int = 1000, seed: int = 0,
               rate_per_s: float = 50.0, zipf_a: float = 1.1,
               diurnal_amp: float = 0.6, diurnal_period: float = 86_400.0,
               minute_s: float = 60.0, **fn_kw) -> StreamedTrace:
    """Offline synthetic of the full Azure Functions 2019 regime, emitted
    lazily minute by minute (bounded memory at 50k functions x multi-day
    horizons).

    Calibrated to the published trace *shapes* rather than its absolute
    volume (the real platform aggregates thousands of invocations/s;
    ``rate_per_s`` is the explicit scale knob):

    * **Zipf popularity** — per-function shares ``rank^-zipf_a`` over a
      seed-shuffled rank assignment: a handful of hot functions carry most
      traffic, the long tail is invoked rarely (the cold-start-prone mass).
    * **Per-minute count shape** — the dataset records per-minute counts;
      arrivals are Poisson within each minute at the function's envelope-
      modulated rate, uniformly placed inside the minute.
    * **Diurnal envelope** — ``1 + amp*cos(2*pi*t/period)`` (mean 1), the
      day/night swing of Fig. 4 of the Serverless-in-the-Wild study.

    Every ``__iter__`` pass reseeds, so two passes over one stream — or two
    streams built from the same (params, seed) — are bit-identical.
    """
    fns = _mk_functions(num_functions, **fn_kw)
    names = list(fns)
    spec_rng = np.random.default_rng(_stream_seed(seed, "popularity"))
    shares = np.arange(1, num_functions + 1, dtype=np.float64) ** -zipf_a
    shares /= shares.sum()
    spec_rng.shuffle(shares)              # rank -> function id assignment
    rates_min = shares * rate_per_s * minute_s     # mean counts per minute
    n_minutes = int(math.ceil(horizon / minute_s))
    arrivals_seed = _stream_seed(seed, "arrivals")

    def factory() -> Iterator[Invocation]:
        rng = np.random.default_rng(arrivals_seed)
        for m in range(n_minutes):
            t0 = m * minute_s
            span = min(minute_s, horizon - t0)
            mid = t0 + 0.5 * span
            env = max(0.0, 1.0 + diurnal_amp
                      * math.cos(2.0 * math.pi * mid / diurnal_period))
            counts = rng.poisson(rates_min * env * (span / minute_s))
            nz = np.nonzero(counts)[0]
            if not len(nz):
                continue
            fn_idx = np.repeat(nz, counts[nz])
            ts = t0 + rng.uniform(0.0, span, fn_idx.size)
            order = np.lexsort((fn_idx, ts))
            for k in order:
                yield Invocation(float(ts[k]), names[fn_idx[k]])

    return StreamedTrace(
        factory, fns, horizon, name=f"azure_full({num_functions}fns)",
        approx_invocations=int(rate_per_s * horizon))


def _open_maybe_gz(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt", newline="")
    return open(path, "r", newline="")


def azure_csv(path: str, *, horizon: Optional[float] = None,
              minute_s: float = 60.0, max_functions: Optional[int] = None,
              seed: int = 0, jitter: bool = False,
              **fn_kw) -> StreamedTrace:
    """Stream the Azure Functions 2019 per-minute invocation-count CSV.

    Format (``invocations_per_function_md.anon.d*.csv``, optionally
    gzipped): ``HashOwner,HashApp,HashFunction,Trigger,1,2,...,1440`` —
    one row per function, one integer column per minute of the day.

    The reader holds only the compact per-minute count matrix
    (``functions x minutes`` of uint32 — roughly the file's own size, never
    the expanded invocation list) and emits each minute's arrivals lazily:
    a count of ``c`` becomes ``c`` arrivals evenly spaced inside the minute
    (``jitter=True`` draws uniform offsets from ``seed`` instead — both
    deterministic and re-iterable).  ``max_functions`` truncates to the
    first N rows for smoke-scale runs; ``horizon`` caps the replay window
    (default: every minute column present).
    """
    names: List[str] = []
    rows: List[np.ndarray] = []
    with _open_maybe_gz(path) as f:
        reader = csv.reader(f)
        header = next(reader)
        minute_cols = [i for i, h in enumerate(header) if h.strip().isdigit()]
        if not minute_cols:
            raise ValueError(
                f"{path}: no per-minute count columns found — expected the "
                "Azure 2019 header HashOwner,HashApp,HashFunction,Trigger,"
                "1,2,...,1440")
        seen: Dict[str, int] = {}
        for row in reader:
            if not row or len(row) <= minute_cols[-1]:
                continue
            base = (row[2][:12] or f"fn{len(names)}") if len(row) > 2 \
                else f"fn{len(names)}"
            n = seen.get(base, 0)
            seen[base] = n + 1
            names.append(base if n == 0 else f"{base}~{n}")
            rows.append(np.array([int(row[i] or 0) for i in minute_cols],
                                 dtype=np.uint32))
            if max_functions is not None and len(names) >= max_functions:
                break
    if not rows:
        raise ValueError(f"{path}: no function rows")
    counts = np.vstack(rows)                      # (functions, minutes)
    n_minutes = counts.shape[1]
    if horizon is None:
        horizon = n_minutes * minute_s
    spec_kw = {"package_mb": 64.0, "memory_mb": 1024.0, **fn_kw}
    fns = {name: FunctionSpec(name=name, **spec_kw) for name in names}
    jitter_seed = _stream_seed(seed, "csv_jitter")
    total = int(counts.sum())

    def factory() -> Iterator[Invocation]:
        rng = np.random.default_rng(jitter_seed) if jitter else None
        last_minute = min(n_minutes, int(math.ceil(horizon / minute_s)))
        for m in range(last_minute):
            col = counts[:, m]
            nz = np.nonzero(col)[0]
            if not len(nz):
                continue
            t0 = m * minute_s
            fn_idx = np.repeat(nz, col[nz])
            if rng is not None:
                offs = rng.uniform(0.0, minute_s, fn_idx.size)
            else:
                # c arrivals at (k + 0.5)/c through the minute — the
                # deterministic spread of the per-minute count semantics
                reps = col[nz]
                offs = np.concatenate(
                    [(np.arange(c) + 0.5) * (minute_s / c) for c in reps])
            ts = t0 + offs
            order = np.lexsort((fn_idx, ts))
            for k in order:
                t = float(ts[k])
                if t >= horizon:
                    continue
                yield Invocation(t, names[fn_idx[k]])

    return StreamedTrace(factory, fns, horizon,
                         name=f"azure_csv({len(names)}fns)",
                         approx_invocations=total)


AZURE_CSV_ENV = "REPRO_AZURE_CSV"


def azure_stress(horizon: float, *, num_functions: int = 1000, seed: int = 0,
                 rate_per_s: float = 50.0, csv_path: Optional[str] = None,
                 jitter: bool = False, **fn_kw) -> StreamedTrace:
    """The ``stress/*`` source: the *real* Azure 2019 CSV when one is
    available, the synthetic :func:`azure_full` twin otherwise.

    A downloaded per-minute-count CSV is routed in via ``csv_path`` or the
    ``REPRO_AZURE_CSV`` environment variable (the experiments CLI's
    ``--azure-csv`` flag sets it); with neither — or a path that does not
    exist — the cell gracefully falls back to the calibrated synthetic so
    stress tiers stay runnable on machines without the dataset."""
    path = csv_path or os.environ.get(AZURE_CSV_ENV)
    if path:
        if os.path.exists(path):
            return azure_csv(path, horizon=horizon,
                             max_functions=num_functions, seed=seed,
                             jitter=jitter, **fn_kw)
        warnings.warn(f"{AZURE_CSV_ENV}={path!r} does not exist; "
                      "falling back to the synthetic azure_full twin")
    return azure_full(horizon, num_functions=num_functions, seed=seed,
                      rate_per_s=rate_per_s, **fn_kw)


def iat_files(paths: Mapping[str, str], *, horizon: float, seed: int = 0,
              **fn_kw) -> StreamedTrace:
    """Stream per-function inter-arrival-time files, merged time-ordered.

    The ``faas-offloading-sim`` trace idiom: each function names a text
    file of IATs, one float per line; cumulative sums are that function's
    arrival times.  Files are read lazily line by line and merged with a
    k-way heap merge, so memory stays O(functions), not O(arrivals).
    ``seed`` is accepted (and ignored) so the spec plumbing can pass it
    uniformly."""
    spec_kw = {"package_mb": 64.0, "memory_mb": 1024.0, **fn_kw}
    fns = {name: FunctionSpec(name=name, **spec_kw) for name in paths}

    def one(fname: str, path: str) -> Iterator[Tuple[float, str]]:
        t = 0.0
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                t += float(line)
                if t >= horizon:
                    return
                yield (t, fname)

    def factory() -> Iterator[Invocation]:
        streams = [one(n, p) for n, p in paths.items()]
        for t, fname in heapq.merge(*streams):
            yield Invocation(t, fname)

    return StreamedTrace(factory, fns, horizon,
                         name=f"iat_files({len(paths)}fns)")


# streamed sources: lazily iterated, never trace-cached by the runner
STREAMING_GENERATORS = {
    "azure_full": azure_full,
    "azure_csv": azure_csv,
    "azure_stress": azure_stress,
    "iat_files": iat_files,
}

ALL_GENERATORS = {
    "poisson": poisson,
    "bursty": bursty,
    "diurnal": diurnal,
    "flash_crowd": flash_crowd,
    "rare": rare,
    "chains": chains,
    "azure_like": azure_like,
    "cron_spikes": cron_spikes,
    **STREAMING_GENERATORS,
}


def interarrival_series(trace: Union[Trace, StreamedTrace],
                        function: str) -> np.ndarray:
    """Deprecated shim — use ``trace.interarrival(function)`` (one
    implementation, on both trace representations)."""
    warnings.warn("interarrival_series(trace, fn) is deprecated; call "
                  "trace.interarrival(fn)", DeprecationWarning, stacklevel=2)
    return trace.interarrival(function)
