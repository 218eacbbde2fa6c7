"""Vectorized batch simulator: whole Sweep grids in one kernel launch.

The scalar simulator (``core/simulator.py``) replays one scenario at a
time through a Python event heap at ~10^4-10^5 heap-events/s.  This module
mirrors ``ClusterState`` into arrays — per-cell x per-function container
counts, warmth tier, demotion deadline, queue depth, plus per-cell worker
free-capacity vectors — and advances EVERY cell of a sweep in lockstep
with a fixed-timestep driver.  On a CUDA device that is one launch of the
hand kernel ``repro_torch.kernels.cluster_step.cluster_sim_hopper`` (one
block per cell for the whole T loop); on the CPU it is the kernel's plain
version, a Python loop over time of the batched torch step
``repro_torch.kernels.ref.cluster_step_ref``.  This module is the port of
``repro.core.batchsim``: the tables, ledgers and spot check are copies, and
only the drivers differ.

The price of the speed is a *modeling* change, not just an implementation
one — containers of one function form a cohort sharing one tier and one
demotion deadline, time is discretised to ``dt``, placement is greedy
first-fit without pressure eviction, and adaptive policies are frozen to
static per-function schedules extracted once from the full trace.  The
documented tolerance contract lives in docs/batchsim.md; policies whose
decisions genuinely depend on runtime state (prewarm pools, cache-style
keep-alives, generic pause pools, chained invocations) raise
:class:`BatchUnsupportedPolicy` instead of silently mis-modeling.

Entry points:

* :func:`simulate_batch` — list of Scenarios -> list of
  :class:`BatchLedger` (one kernel launch for the whole list);
* ``run_sweep(sweep, driver="batch")`` in ``experiments/runner.py`` — the
  sweep-level wiring;
* :func:`spot_check` — batch vs scalar-simulator agreement on sampled
  cells (the acceptance gate; also used by tests and bench_batchsim).
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cluster import PolicyDriver, _per_worker
from repro_torch.core.lifecycle import Container, ContainerState, FunctionSpec, \
    WarmthTier
from repro_torch.core.metrics import PRICE_PER_GB_S, PRICE_PER_REQUEST
from repro_torch.core.policies.keepalive import FixedTTL
from repro_torch.core.policies.lifetime import (FixedLadder, KeepAliveLadder,
                                                PredictiveLadder, RLLadder)

DEFAULT_DT = 0.5          # fixed timestep (seconds); see docs/batchsim.md
MIN_EDGES = 4             # schedule slots (a full ladder walk is 3 edges)
T_MULTIPLE = 128          # step count padding (the reference's DEFAULT_CHUNK)


class BatchUnsupportedPolicy(ValueError):
    """The scenario needs runtime-state-dependent decisions the static
    batch model cannot represent; run it under ``driver="sim"``."""


# --------------------------------------------------------------------------- #
# ledger
# --------------------------------------------------------------------------- #
@dataclass
class BatchLedger:
    """Per-cell QoS aggregates reconstructed into the QoSLedger summary
    schema.  Percentile fields are NaN (the batch driver keeps sums, not
    per-request records); ``latency_mean_s`` and every count/GB-s field
    are populated."""

    requests: float
    cold_starts: float
    warm_hits: float
    containers_launched: float
    promotions: float
    demotions: float
    latency_sum_s: float
    queue_wait_sum_s: float
    exec_gb_s: float
    idle_gb_s_by_tier: Dict[str, float]
    backlog: float                     # queued but never served by horizon
    horizon: float
    dt: float
    capacity_gb: float = 0.0           # total cluster memory, GB

    @property
    def idle_gb_s(self) -> float:
        return sum(self.idle_gb_s_by_tier.values())

    def summary(self, *, sla_latency_s: Optional[float] = None) \
            -> Dict[str, float]:
        nan = float("nan")
        n = self.requests
        h = self.horizon
        out = {
            "requests": n,
            "throughput_rps": n / h if h else nan,
            "latency_p50_s": nan,
            "latency_p95_s": nan,
            "latency_p99_s": nan,
            "latency_mean_s": self.latency_sum_s / n if n else nan,
            "warm_p50_s": nan,
            "cold_p50_s": nan,
            "queue_wait_p50_s": nan,
            "queue_wait_p95_s": nan,
            "cold_starts": self.cold_starts,
            "cold_start_frequency": self.cold_starts / n if n else nan,
            "containers_launched": self.containers_launched,
            "scalability_launch_rate": (self.containers_launched / h
                                        if h else nan),
            "exec_gb_s": self.exec_gb_s,
            "idle_gb_s": self.idle_gb_s,
            "wasted_fraction": (self.idle_gb_s /
                                max(self.exec_gb_s + self.idle_gb_s, 1e-12)),
            "cost_usd": (self.exec_gb_s + self.idle_gb_s) * PRICE_PER_GB_S
            + n * PRICE_PER_REQUEST,
            "dropped": 0.0,
            "promotions": self.promotions,
            "demotions": self.demotions,
            "idle_gb_s_warm": self.idle_gb_s_by_tier.get("warm_idle", 0.0),
            "idle_gb_s_paused": self.idle_gb_s_by_tier.get("paused", 0.0),
            "idle_gb_s_snapshot": self.idle_gb_s_by_tier.get(
                "snapshot_ready", 0.0),
        }
        if sla_latency_s is not None and n:
            out["sla_violation_rate"] = nan
        if self.capacity_gb and h:
            # the scalar ledger weighs (end - arrival) per request; the
            # batch keeps GB-s sums, so busy time here is execution only
            out["utilization"] = self.exec_gb_s / (self.capacity_gb * h)
        return out


# --------------------------------------------------------------------------- #
# static-schedule extraction (policy -> per-function ladder edges)
# --------------------------------------------------------------------------- #
class _ScheduleCtx:
    """The minimal ClusterContext slice ``Lifetime.schedule`` and
    ``PolicyDriver.schedule_for`` actually consult when deciding a
    demotion schedule: the clock and promote-cost estimates."""

    def __init__(self, cost_model, functions: Dict[str, FunctionSpec],
                 now: float):
        self.cost_model = cost_model
        self._functions = functions
        self.now = now

    def promote_estimate(self, function: str, tier: WarmthTier) -> float:
        return self.cost_model.promote_breakdown(
            self._functions[function], tier).total


def check_supported(scenario, suite, trace, worker_speed) -> None:
    """Raise :class:`BatchUnsupportedPolicy` naming every feature of the
    cell the static batch model cannot represent."""
    reasons = []
    from repro_torch.core.workload import InvocationStream
    if isinstance(trace, InvocationStream):
        reasons.append(
            "streamed traces (the batch driver builds dense per-step "
            "tables from the full invocation list; call "
            "workload.materialize(stream) first, or run with driver='sim', "
            "which consumes streams with bounded memory)")
    if suite.prewarm is not None:
        reasons.append(f"prewarm policy ({suite.prewarm.name})")
    if suite.startup.pause_pool_size:
        reasons.append("generic pause pool")
    lt = suite.lifetime
    if lt is not None and not isinstance(
            lt, (KeepAliveLadder, FixedLadder, PredictiveLadder, RLLadder)):
        reasons.append(f"lifetime policy ({lt.name})")
    if lt is None and not isinstance(suite.keepalive, FixedTTL):
        reasons.append(
            f"adaptive keep-alive ({suite.keepalive.name}) without a "
            "static TTL")
    if isinstance(lt, KeepAliveLadder) and not isinstance(lt.keepalive,
                                                          FixedTTL):
        reasons.append(
            f"adaptive keep-alive ladder ({lt.keepalive.name})")
    if isinstance(lt, RLLadder) and lt.learned_warm_s is None:
        reasons.append(
            "online RL ladder (agent-chosen TTLs are runtime state; "
            "export a trained schedule with scripts/train_predictors.py "
            "and attach it via RLLadder.attach_schedule — or use the "
            "'tiered_rl_learned' suite)")
    if any(fn.chain for fn in trace.functions.values()):
        reasons.append("chained invocations")
    if any(s != 1.0 for s in worker_speed):
        reasons.append("heterogeneous worker speeds")
    if reasons:
        raise BatchUnsupportedPolicy(
            f"scenario {scenario.name!r}: the batch driver cannot model "
            + "; ".join(reasons) + " — run this cell with driver='sim'")


def _container_for(name: str, fn: FunctionSpec) -> Container:
    return Container(id=0, function=name, state=ContainerState.WARM_IDLE,
                     worker=0, memory_mb=fn.memory_mb, created_at=0.0)


def static_schedules(suite, cost_model, trace) \
        -> Dict[str, List[Tuple[float, WarmthTier]]]:
    """Freeze the suite's lifetime policy into one demotion schedule per
    function, normalised exactly as the scalar drivers normalise it
    (``PolicyDriver.schedule_for``: descend-only, demote work added to
    the dwell).

    Adaptive policies need a static stand-in.  ``PredictiveLadder`` is
    *replayed* against the trace — arrivals feed the predictor in time
    order and the schedule is sampled at every arrival, exactly the
    decision points the scalar run sees; the freeze keeps, per function,
    the modal tier-sequence with element-wise median dwells (not the
    fully-converged end-of-trace schedule, which systematically
    over-estimates dwells on bursty traffic).  ``RLLadder`` is only
    supported in its exported-schedule form (``attach_schedule``), where
    ``schedule()`` is already a static per-function map the default path
    replays verbatim; ``check_supported`` rejects the online form.
    """
    from collections import Counter

    lt = suite.lifetime
    drv = PolicyDriver(copy.copy(suite),
                       tier_footprint_frac=cost_model.tier_footprint_frac)
    out: Dict[str, List[Tuple[float, WarmthTier]]] = {}
    samples: Dict[str, list] = {}
    if isinstance(lt, PredictiveLadder):
        events = sorted((float(t), name) for name in trace.functions
                        for t in trace.times_for(name))
        samples = {name: [] for name in trace.functions}
        for t, name in events:
            lt.observe(name, t)
            ctx = _ScheduleCtx(cost_model, trace.functions, t)
            samples[name].append(drv.schedule_for(
                _container_for(name, trace.functions[name]), ctx))
    for name, fn in trace.functions.items():
        scheds = samples.get(name)
        if not scheds:
            times = trace.times_for(name)
            now = float(times[-1]) if len(times) else 0.0
            ctx = _ScheduleCtx(cost_model, trace.functions, now)
            out[name] = drv.schedule_for(_container_for(name, fn), ctx)
            continue
        shapes = [tuple(tier for _, tier in s) for s in scheds]
        modal = Counter(shapes).most_common(1)[0][0]
        group = [[dw for dw, _ in s]
                 for s, sh in zip(scheds, shapes) if sh == modal]
        dwells = np.median(np.asarray(group), axis=0)
        out[name] = [(float(dw), tier) for dw, tier in zip(dwells, modal)]
    return out


# --------------------------------------------------------------------------- #
# table building (Scenario list -> padded [C, ...] arrays)
# --------------------------------------------------------------------------- #
@dataclass
class BatchTables:
    """The padded array-state for one batched run (numpy, float32)."""

    nw: np.ndarray        # [C, F, W] initial container counts (zeros)
    fs: np.ndarray        # [C, F, FS_N] cohort scalars
    free: np.ndarray      # [C, W] free MB per worker
    arrivals: np.ndarray  # [C, T, F] arrival counts per step
    conc: np.ndarray      # [C, T, F] peak same-exec-window concurrency
    fparam: np.ndarray    # [C, F, FP_N]
    promote: np.ndarray   # [C, F, 5] promote-to-serving seconds per tier
    dwell: np.ndarray     # [C, F, K] schedule dwells (BIG_TIME-padded)
    ntier: np.ndarray     # [C, F, K] schedule target tiers (DEAD-padded)
    frac: np.ndarray      # [C, 5] footprint fraction per tier
    scal: np.ndarray      # [C, SC_N]
    horizons: List[float]
    invocations: List[int]
    dt: float


def build_tables(scenarios: Sequence, *, dt: float = DEFAULT_DT,
                 cost_model=None,
                 trace_fn: Optional[Callable] = None,
                 device="cuda") -> BatchTables:
    """Mirror every scenario into the batch array-state (validating batch
    support per cell).  ``trace_fn`` overrides trace construction (the
    runner passes its cached ``build_trace``); ``device`` is where a
    suite's learned predictor runs while its schedule is frozen
    (``tiered_transformer``)."""
    from repro_torch.kernels import ref as R

    if trace_fn is None:
        trace_fn = lambda sc: sc.trace()      # noqa: E731
    cells = []
    for sc in scenarios:
        suite = sc.suite(device)
        cm = cost_model if cost_model is not None else sc.cost_model()
        trace = trace_fn(sc)
        speed = _per_worker(sc.cluster.worker_speed,
                            sc.cluster.num_workers, "worker_speed")
        check_supported(sc, suite, trace, speed)
        cells.append((sc, suite, cm, trace,
                      static_schedules(suite, cm, trace)))

    C = len(cells)
    F = max(len(t.functions) for _, _, _, t, _ in cells)
    W = max(sc.cluster.num_workers for sc, _, _, _, _ in cells)
    K = max([MIN_EDGES] + [len(s) for _, _, _, _, scheds in cells
                           for s in scheds.values()])
    T = max(int(math.ceil(t.horizon / dt)) for _, _, _, t, _ in cells)
    # pad T as the reference pads it for its Pallas kernel's 128-step
    # chunks, so the tables stay equal (the CUDA kernel needs no chunking);
    # trailing steps are past every horizon and no-ops (dt_eff == 0)
    T = int(math.ceil(T / T_MULTIPLE)) * T_MULTIPLE

    f32 = np.float32
    nw = np.zeros((C, F, W), f32)
    fs = np.zeros((C, F, R.FS_N), f32)
    fs[:, :, R.FS_TIER] = R.T_WARM
    fs[:, :, R.FS_DEADLINE] = R.BIG_TIME
    free = np.zeros((C, W), f32)
    arrivals = np.zeros((C, T, F), f32)
    conc = np.zeros((C, T, F), f32)
    fparam = np.zeros((C, F, R.FP_N), f32)
    fparam[:, :, R.FP_MEM_MB] = 1024.0        # padded rows never spawn but
    fparam[:, :, R.FP_EXEC_S] = 1.0           # must not divide by zero
    fparam[:, :, R.FP_SVC] = 1.0
    promote = np.zeros((C, F, 5), f32)
    dwell = np.full((C, F, K), R.BIG_TIME, f32)
    ntier = np.zeros((C, F, K), f32)          # DEAD
    frac = np.zeros((C, 5), f32)
    scal = np.zeros((C, R.SC_N), f32)
    horizons, n_inv = [], []

    for ci, (sc, suite, cm, trace, scheds) in enumerate(cells):
        cfg = sc.sim_config()
        mem = _per_worker(sc.cluster.worker_memory_mb,
                          sc.cluster.num_workers, "worker_memory_mb")
        free[ci, :len(mem)] = mem
        for t in range(5):
            frac[ci, t] = cm.tier_footprint_frac.get(WarmthTier(t), 1.0)
        scal[ci, R.SC_DT] = dt
        scal[ci, R.SC_HORIZON] = trace.horizon
        scal[ci, R.SC_IMG_CACHE] = float(suite.startup.img_cache)
        scal[ci, R.SC_SNAPSHOT] = float(suite.startup.snapshot)
        scal[ci, R.SC_SANITIZE_S] = (cfg.sanitize_cost_s
                                     if cfg.sanitize_on_reuse else 0.0)
        horizons.append(trace.horizon)
        n_inv.append(len(trace.invocations))

        for fi, (name, fn) in enumerate(trace.functions.items()):
            exec_s = cm.exec_time(fn)
            slots = max(fn.container_concurrency, 1)
            fparam[ci, fi, R.FP_MEM_MB] = fn.memory_mb
            fparam[ci, fi, R.FP_EXEC_S] = exec_s
            fparam[ci, fi, R.FP_EXEC_GB] = fn.memory_mb / 1024.0 / slots
            fparam[ci, fi, R.FP_SVC] = max(math.floor(dt / exec_s),
                                           1.0) * slots
            fparam[ci, fi, R.FP_MEM_GB] = fn.memory_mb / 1024.0
            for t in range(5):
                promote[ci, fi, t] = cm.promote_breakdown(
                    fn, WarmthTier(t),
                    deps_fraction=suite.startup.deps_fraction).total
            for ei, (dw, tier) in enumerate(scheds[name]):
                dwell[ci, fi, ei] = dw
                ntier[ci, fi, ei] = float(int(tier))
            times = trace.times_for(name)
            if len(times):
                ts = np.sort(np.asarray(times, dtype=np.float64))
                idx = np.minimum((ts / dt).astype(np.int64), T - 1)
                arrivals[ci, :, fi] += np.bincount(
                    idx, minlength=T).astype(f32)
                # peak concurrency per step: a container serves one
                # request at a time, so arrivals within one busy window
                # (exec + sanitize) each need their own container — the
                # event-exact signal the fixed-dt grid cannot see
                win = exec_s + float(scal[ci, R.SC_SANITIZE_S])
                ov = (np.arange(len(ts))
                      - np.searchsorted(ts, ts - win, side="right") + 1)
                np.maximum.at(conc[ci, :, fi], idx,
                              np.ceil(ov / slots).astype(f32))
                # cold-start cascades: while the first container of a
                # fresh cohort is still initialising (the cold promote
                # latency, much longer than exec), every further arrival
                # spawns its own container in the scalar sim.  Cold
                # points are static — arrivals whose gap since the
                # previous one exceeds the schedule's time-to-death —
                # so widen the overlap window to the cold latency there
                death_s = 0.0
                for dw, tg in scheds[name]:
                    if death_s >= R.BIG_TIME / 2:
                        break
                    death_s += dw
                    if int(tg) == int(R.T_DEAD):
                        break
                win0 = float(promote[ci, fi, 0]) + win
                gaps = np.diff(ts, prepend=-np.inf)
                for i0 in np.flatnonzero(gaps > death_s + exec_s):
                    m = np.searchsorted(ts, ts[i0] + win0, side="left")
                    ov0 = np.arange(1, m - i0 + 1, dtype=np.float64)
                    np.maximum.at(conc[ci, :, fi], idx[i0:m],
                                  np.ceil(ov0 / slots).astype(f32))

    return BatchTables(nw=nw, fs=fs, free=free, arrivals=arrivals,
                       conc=conc,
                       fparam=fparam, promote=promote, dwell=dwell,
                       ntier=ntier, frac=frac, scal=scal,
                       horizons=horizons, invocations=n_inv, dt=dt)


# --------------------------------------------------------------------------- #
# the driver
# --------------------------------------------------------------------------- #
KERNELS = (None, "cuda")


def run_tables(tables: BatchTables, *, kernel: Optional[str] = None,
               device="cuda"):
    """Advance the whole grid; returns ``(nw_final, fs_final, agg)``
    as numpy.

    ``kernel=None``: the hand kernel on a CUDA device (one launch), its
    plain version (a Python loop over T of the batched torch step) on the
    CPU.  ``kernel="cuda"`` insists on the hand kernel and raises on the
    CPU.
    """
    from repro_torch.device import resolve_device
    from repro_torch.kernels.cluster_step import cluster_sim_hopper

    if kernel not in KERNELS:
        raise ValueError(f"unknown batch kernel {kernel!r}; "
                         f"one of {KERNELS}")
    dev = resolve_device(device)
    if kernel == "cuda" and dev.type != "cuda":
        raise ValueError(f"kernel='cuda' needs a CUDA device, not {dev}")
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (tables.nw, tables.fs, tables.free, tables.arrivals,
                      tables.conc, tables.fparam, tables.promote,
                      tables.dwell, tables.ntier, tables.frac, tables.scal)]
    nw, fs, _, agg = cluster_sim_hopper(*args)
    return nw.cpu().numpy(), fs.cpu().numpy(), agg.cpu().numpy()


def drain_idle(tables: BatchTables, nw: np.ndarray, fs: np.ndarray) \
        -> Tuple[np.ndarray, np.ndarray]:
    """Post-horizon idle billing: the scalar simulator keeps draining its
    event heap after the last arrival, so every surviving container bills
    idle (and fires demotions) all the way down its schedule until DEAD.
    Walk each resident cohort's remaining edges analytically; returns
    ``(idle[C, 3] (warm/paused/snap GB-s), demotions[C])``."""
    from repro_torch.kernels import ref as R

    C, F, K = tables.dwell.shape
    idle = np.zeros((C, 3))
    demo = np.zeros(C)
    bucket = {int(R.T_WARM): 0, int(R.T_PAUSED): 1, int(R.T_SNAP): 2}
    for ci in range(C):
        h = tables.horizons[ci]
        frac = tables.frac[ci]
        for fi in range(F):
            n = float(nw[ci, fi].sum())
            deadline = float(fs[ci, fi, R.FS_DEADLINE])
            if n <= 0 or deadline >= R.BIG_TIME / 2:
                continue
            tier = int(fs[ci, fi, R.FS_TIER])
            e = int(fs[ci, fi, R.FS_EDGE])
            gb = float(tables.fparam[ci, fi, R.FP_MEM_GB])
            b = bucket.get(tier)
            if b is not None:
                idle[ci, b] += n * gb * frac[tier] * max(deadline - h, 0.0)
            while e < K:
                tgt = int(tables.ntier[ci, fi, min(e, K - 1)])
                if tgt == int(R.T_DEAD):
                    break               # death: frees, not a demotion
                demo[ci] += n
                dw = float(tables.dwell[ci, fi, min(e + 1, K - 1)])
                if dw >= R.BIG_TIME / 2:
                    break               # parks forever; no further billing
                b = bucket.get(tgt)
                if b is not None:
                    idle[ci, b] += n * gb * frac[tgt] * dw
                e += 1
    return idle, demo


def ledgers_from_agg(tables: BatchTables, nw: np.ndarray, fs: np.ndarray,
                     agg: np.ndarray) -> List[BatchLedger]:
    from repro_torch.kernels import ref as R

    dr_idle, dr_demo = drain_idle(tables, nw, fs)
    out = []
    for ci in range(agg.shape[0]):
        a = agg[ci].astype(float)
        out.append(BatchLedger(
            requests=a[R.AG_REQUESTS],
            cold_starts=a[R.AG_COLD],
            warm_hits=a[R.AG_WARM],
            containers_launched=a[R.AG_LAUNCHED],
            promotions=a[R.AG_PROMOTIONS],
            demotions=a[R.AG_DEMOTIONS] + dr_demo[ci],
            latency_sum_s=a[R.AG_LAT_SUM],
            queue_wait_sum_s=a[R.AG_QWAIT_SUM],
            exec_gb_s=a[R.AG_EXEC_GB_S],
            idle_gb_s_by_tier={
                "warm_idle": a[R.AG_IDLE_WARM] + dr_idle[ci, 0],
                "paused": a[R.AG_IDLE_PAUSED] + dr_idle[ci, 1],
                "snapshot_ready": a[R.AG_IDLE_SNAP] + dr_idle[ci, 2],
            },
            backlog=float(fs[ci, :, R.FS_QUEUED].sum()),
            horizon=tables.horizons[ci],
            dt=tables.dt,
            capacity_gb=float(tables.free[ci].sum()) / 1024.0))
    return out


def simulate_batch(scenarios: Sequence, *, dt: float = DEFAULT_DT,
                   kernel: Optional[str] = None, cost_model=None,
                   trace_fn: Optional[Callable] = None,
                   device="cuda") -> List[BatchLedger]:
    """Run every scenario in one batched launch on ``device`` (CUDA unless
    the caller asks for the CPU); one :class:`BatchLedger` per cell, in
    input order."""
    from repro_torch.device import resolve_device

    resolve_device(device)
    for sc in scenarios:
        if getattr(sc, "topology", None) is not None:
            raise ValueError(
                f"scenario {getattr(sc, 'name', sc)!r} has a topology; "
                "the batch driver models one flat cluster per cell — "
                "run topology scenarios under driver='sim' or 'fleet'")
    tables = build_tables(scenarios, dt=dt, cost_model=cost_model, device=device,
                          trace_fn=trace_fn)
    nw, fs, agg = run_tables(tables, kernel=kernel, device=device)
    return ledgers_from_agg(tables, nw, fs, agg)


# --------------------------------------------------------------------------- #
# the tolerance spot-check (acceptance gate; see docs/batchsim.md)
# --------------------------------------------------------------------------- #
# |batch - scalar| tolerances on sampled cells: cold-rate is absolute
# (both drivers count promote-resumes as cold), idle GB-s is relative
# with an absolute floor for near-zero cells.
TOL_COLD_RATE = 0.05
TOL_IDLE_REL = 0.25
TOL_IDLE_ABS_GB_S = 80.0


@dataclass
class SpotCheckRow:
    name: str
    cold_rate_sim: float
    cold_rate_batch: float
    idle_gb_s_sim: float
    idle_gb_s_batch: float

    @property
    def cold_ok(self) -> bool:
        return abs(self.cold_rate_batch - self.cold_rate_sim) \
            <= TOL_COLD_RATE

    @property
    def idle_ok(self) -> bool:
        err = abs(self.idle_gb_s_batch - self.idle_gb_s_sim)
        return (err <= TOL_IDLE_ABS_GB_S
                or err <= TOL_IDLE_REL * max(self.idle_gb_s_sim, 1e-9))

    @property
    def ok(self) -> bool:
        return self.cold_ok and self.idle_ok


def spot_check(scenarios: Sequence, *, dt: float = DEFAULT_DT,
               cost_model=None, trace_fn: Optional[Callable] = None,
               device="cuda") -> List[SpotCheckRow]:
    """Batch-vs-scalar agreement on ``scenarios`` under the documented
    tolerance contract (cold-rate absolute, idle GB-s relative)."""
    from repro_torch.core.simulator import simulate

    batch = simulate_batch(scenarios, dt=dt, cost_model=cost_model,
                           trace_fn=trace_fn, device=device)
    rows = []
    for sc, led in zip(scenarios, batch):
        cm = cost_model if cost_model is not None else sc.cost_model()
        trace = trace_fn(sc) if trace_fn is not None else sc.trace()
        sim = simulate(trace, sc.suite(device), cost_model=cm,
                       cfg=sc.sim_config()).summary()
        bs = led.summary()
        rows.append(SpotCheckRow(
            name=sc.name,
            cold_rate_sim=sim["cold_start_frequency"],
            cold_rate_batch=bs["cold_start_frequency"],
            idle_gb_s_sim=sim["idle_gb_s"],
            idle_gb_s_batch=bs["idle_gb_s"]))
    return rows
