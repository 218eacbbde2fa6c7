"""QoS ledger — the paper's RQ1 parameters, measured.

Latency (pctls), throughput, cost (pay-as-you-go GB-s + idle keep-warm GB-s
— the energy/waste proxy of §6.1), SLA violations, cold-start count and
frequency, scalability (containers launched /s), resource utilisation.
"""
from __future__ import annotations

import bisect
import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.lifecycle import Breakdown

# AWS-Lambda-like pricing: $ per GB-second (x86, 2024) + per-request fee
PRICE_PER_GB_S = 1.6667e-5
PRICE_PER_REQUEST = 2e-7


@dataclass
class RequestRecord:
    function: str
    arrival: float
    start: float                  # execution start (after any cold start)
    end: float
    cold: bool
    startup: Optional[Breakdown] = None

    @property
    def latency(self) -> float:
        return self.end - self.arrival

    @property
    def queue_wait(self) -> float:
        startup = self.startup.total if self.startup else 0.0
        return max(0.0, self.start - self.arrival - startup)


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1, max(0, math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[idx]


@dataclass
class QoSLedger:
    records: List[RequestRecord] = field(default_factory=list)
    # GB-seconds consumed while containers sit idle-resident (wasted
    # resources), total and split by warmth tier — a paused or
    # snapshot-resident container bills its *tier footprint*, not its full
    # allocation, so the per-tier split is the ladder's cost story
    idle_gb_s: float = 0.0
    idle_gb_s_by_tier: Dict[str, float] = field(default_factory=dict)
    exec_gb_s: float = 0.0
    containers_launched: int = 0
    promotions: int = 0               # resident-tier container resumed
    demotions: int = 0                # ladder moves down (excl. death)
    dropped: int = 0
    horizon: float = 0.0
    cluster_capacity_gb: float = 0.0
    _busy_gb_s: float = 0.0
    # bounded-memory mode for trace-scale runs: when set, per-request
    # RequestRecords are NOT retained — counts / means / GB-s stay exact
    # via running aggregates, percentiles become approximate via a
    # deterministic size-``record_cap`` reservoir.  None (default)
    # preserves the historical keep-everything behavior exactly.
    record_cap: Optional[int] = None
    _n: int = 0
    _n_cold: int = 0
    _lat_sum: float = 0.0
    _max_end: float = 0.0
    _sample: List[Tuple[float, bool, float]] = field(
        default_factory=list, repr=False)

    # ------------------------------------------------------------------ #
    def record(self, rec: RequestRecord, *, memory_gb: float):
        self._n += 1
        self._n_cold += rec.cold
        lat = rec.latency
        self._lat_sum += lat
        if rec.end > self._max_end:
            self._max_end = rec.end
        self.exec_gb_s += (rec.end - rec.start) * memory_gb
        self._busy_gb_s += (rec.end - rec.arrival) * memory_gb
        if self.record_cap is None:
            self.records.append(rec)
            return
        # reservoir sampling (Algorithm R) over (latency, cold, queue_wait)
        # with a fixed-seed RNG: deterministic for a given record sequence
        cap = self.record_cap
        if len(self._sample) < cap:
            self._sample.append((lat, rec.cold, rec.queue_wait))
        else:
            rng = getattr(self, "_res_rng", None)
            if rng is None:
                rng = self._res_rng = random.Random(cap)
            j = rng.randrange(self._n)
            if j < cap:
                self._sample[j] = (lat, rec.cold, rec.queue_wait)

    def add_idle(self, seconds: float, memory_gb: float,
                 tier: str = "warm_idle"):
        gb_s = seconds * memory_gb
        self.idle_gb_s += gb_s
        self.idle_gb_s_by_tier[tier] = \
            self.idle_gb_s_by_tier.get(tier, 0.0) + gb_s

    # ------------------------------------------------------------------ #
    def summary(self, *, sla_latency_s: Optional[float] = None) -> Dict[str, float]:
        if self.records or not self._n:
            # exact path: every record retained (default mode, or records
            # appended directly without going through record())
            lat = sorted(r.latency for r in self.records)
            cold_lat = sorted(r.latency for r in self.records if r.cold)
            warm_lat = sorted(r.latency for r in self.records if not r.cold)
            queue_wait = sorted(r.queue_wait for r in self.records)
            n = len(self.records)
            n_cold = len(cold_lat)
            lat_mean = sum(lat) / n if n else float("nan")
            horizon = self.horizon or (
                max((r.end for r in self.records), default=0.0))
            sla_frac = (sum(1 for v in lat if v > sla_latency_s) / n
                        if sla_latency_s is not None and n else None)
        else:
            # bounded mode: exact counts/means, reservoir percentiles
            lat = sorted(s[0] for s in self._sample)
            cold_lat = sorted(s[0] for s in self._sample if s[1])
            warm_lat = sorted(s[0] for s in self._sample if not s[1])
            queue_wait = sorted(s[2] for s in self._sample)
            n = self._n
            n_cold = self._n_cold
            lat_mean = self._lat_sum / n
            horizon = self.horizon or self._max_end
            sla_frac = (sum(1 for v in lat if v > sla_latency_s) / len(lat)
                        if sla_latency_s is not None and lat else None)
        out = {
            "requests": float(n),
            "throughput_rps": n / horizon if horizon else float("nan"),
            "latency_p50_s": _pct(lat, 0.50),
            "latency_p95_s": _pct(lat, 0.95),
            "latency_p99_s": _pct(lat, 0.99),
            "latency_mean_s": lat_mean,
            "warm_p50_s": _pct(warm_lat, 0.50),
            "cold_p50_s": _pct(cold_lat, 0.50),
            "queue_wait_p50_s": _pct(queue_wait, 0.50),
            "queue_wait_p95_s": _pct(queue_wait, 0.95),
            "cold_starts": float(n_cold),
            "cold_start_frequency": n_cold / n if n else float("nan"),
            "containers_launched": float(self.containers_launched),
            "scalability_launch_rate": (self.containers_launched / horizon
                                        if horizon else float("nan")),
            "exec_gb_s": self.exec_gb_s,
            "idle_gb_s": self.idle_gb_s,
            "wasted_fraction": (self.idle_gb_s /
                                max(self.exec_gb_s + self.idle_gb_s, 1e-12)),
            "cost_usd": (self.exec_gb_s + self.idle_gb_s) * PRICE_PER_GB_S
            + n * PRICE_PER_REQUEST,
            "dropped": float(self.dropped),
            "promotions": float(self.promotions),
            "demotions": float(self.demotions),
            "idle_gb_s_warm": self.idle_gb_s_by_tier.get("warm_idle", 0.0),
            "idle_gb_s_paused": self.idle_gb_s_by_tier.get("paused", 0.0),
            "idle_gb_s_snapshot": self.idle_gb_s_by_tier.get(
                "snapshot_ready", 0.0),
        }
        if sla_frac is not None:
            out["sla_violation_rate"] = sla_frac
        if self.cluster_capacity_gb and horizon:
            out["utilization"] = self._busy_gb_s / (self.cluster_capacity_gb * horizon)
        return out


def format_summary(name: str, s: Dict[str, float]) -> str:
    return (f"{name:28s} p50={s['latency_p50_s'] * 1e3:8.1f}ms "
            f"p99={s['latency_p99_s'] * 1e3:8.1f}ms "
            f"cold%={s['cold_start_frequency'] * 100:5.2f} "
            f"waste%={s['wasted_fraction'] * 100:5.1f} "
            f"cost=${s['cost_usd']:.4f} "
            f"thr={s['throughput_rps']:.1f}rps")
