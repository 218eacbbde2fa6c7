"""Join the raw event stream into per-invocation records and tables.

The ledger reports aggregates; these functions answer *where the time
went* for each request and *which warmth tier* served it:

  invocations()        one record per served request, joining arrival /
                       queue / startup / execution events
  phase_percentiles()  p50/p95/max of each startup phase, grouped by
                       serving tier or by function
  cold_attribution()   per-function table: how many requests paid a cold
                       path, from which tier, and how many seconds of
                       total latency that path is responsible for
  serving_paths()      histogram of how requests were served (warm reuse,
                       slot join, promote-from-<tier>, full cold)
  tier_occupancy()     per-tier resident GB-s integrated from dwell
                       intervals — independently re-derives the ledger's
                       ``idle_gb_s_by_tier`` split, so the two can be
                       cross-checked
  offload_table()      where the topology router sent requests: per
                       destination node, counts / QoS-class mix / network
                       seconds, from the ``offload`` events (empty for
                       flat single-cluster logs)
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1,
              max(0, math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[idx]


@dataclass
class InvocationStat:
    """One served request, reassembled from the event stream."""

    function: str
    arrival: float
    start: float                 # execution start
    end: float
    cold: bool
    path: str                    # "warm_idle" | "slot_join" | tier name
    cid: int
    phases: Dict[str, float] = field(default_factory=dict)  # cold paths only
    startup_total: float = 0.0

    @property
    def latency(self) -> float:
        return self.end - self.arrival

    @property
    def queue_wait(self) -> float:
        return max(0.0, self.start - self.arrival - self.startup_total)


def invocations(events: Iterable[Mapping[str, Any]]) -> List[InvocationStat]:
    """Join the stream into per-request records.

    A cold request's serving path is the tier its container started or
    resumed from (the ``startup`` event); a warm request's path comes
    from its container's ``slot_bind``: ``warm_idle`` = idle reuse,
    ``slot_join`` = joined a running container's spare slot.  Each
    ``exec_start`` carries the arrival times of every request in the
    (possibly micro-batched) execution, so one event may yield several
    records.
    """
    last_startup: Dict[int, Tuple[str, Dict[str, float], float]] = {}
    last_bind: Dict[int, str] = {}
    out: List[InvocationStat] = []
    for ev in events:
        kind = ev["kind"]
        if kind == "startup":
            last_startup[ev["cid"]] = (ev["tier"], dict(ev["phases"]),
                                       ev["total"])
        elif kind == "slot_bind":
            last_bind[ev["cid"]] = ev["bind"]
        elif kind == "exec_start":
            cid = ev["cid"]
            if ev["cold"]:
                tier, phases, total = last_startup.get(
                    cid, ("dead", {}, 0.0))
                path = tier
            else:
                bind = last_bind.get(cid, "warm_idle")
                path = "warm_idle" if bind == "warm_idle" else "slot_join"
                phases, total = {}, 0.0
            for a in ev["arrivals"]:
                out.append(InvocationStat(
                    function=ev["function"], arrival=a, start=ev["t"],
                    end=ev["end"], cold=ev["cold"], path=path, cid=cid,
                    phases=phases, startup_total=total))
    return out


def serving_paths(stats: List[InvocationStat]) -> Dict[str, int]:
    """How requests were served: warm reuse / slot join / per-tier cold."""
    out: Dict[str, int] = {}
    for s in stats:
        out[s.path] = out.get(s.path, 0) + 1
    return out


def phase_percentiles(stats: List[InvocationStat], *,
                      by: str = "path") -> Dict[str, Dict[str, Dict[str, float]]]:
    """``{group: {phase: {n, p50, p95, max}}}`` over cold invocations.

    ``by`` groups by serving ``path`` (tier) or by ``function``.  The
    pseudo-phase ``total`` aggregates the whole startup; ``queue`` and
    ``latency`` are included for every invocation (warm ones too) so the
    breakdown sums to something comparable with the ledger percentiles.
    """
    if by not in ("path", "function"):
        raise ValueError(f"by must be 'path' or 'function', got {by!r}")
    buckets: Dict[str, Dict[str, List[float]]] = {}
    for s in stats:
        group = buckets.setdefault(getattr(s, by), {})
        group.setdefault("latency", []).append(s.latency)
        group.setdefault("queue", []).append(s.queue_wait)
        if s.cold:
            group.setdefault("total", []).append(s.startup_total)
            for ph, sec in s.phases.items():
                group.setdefault(ph, []).append(sec)
    out: Dict[str, Dict[str, Dict[str, float]]] = {}
    for name, group in sorted(buckets.items()):
        out[name] = {}
        for ph, vals in group.items():
            vals.sort()
            out[name][ph] = {"n": float(len(vals)),
                             "p50": _pct(vals, 0.50),
                             "p95": _pct(vals, 0.95),
                             "max": vals[-1]}
    return out


def cold_attribution(stats: List[InvocationStat]) -> Dict[str, Dict[str, Any]]:
    """Per-function cold-start attribution table.

    ``cold_latency_s`` is the total startup seconds requests of this
    function spent waiting on spawns/promotes — the latency directly
    attributable to cold paths (the number keep-warm policies buy down).
    """
    out: Dict[str, Dict[str, Any]] = {}
    for s in stats:
        row = out.setdefault(s.function, {
            "requests": 0, "colds": 0, "cold_rate": 0.0,
            "cold_latency_s": 0.0, "mean_cold_s": float("nan"),
            "by_tier": {}})
        row["requests"] += 1
        if s.cold:
            row["colds"] += 1
            row["cold_latency_s"] += s.startup_total
            row["by_tier"][s.path] = row["by_tier"].get(s.path, 0) + 1
    for row in out.values():
        row["cold_rate"] = row["colds"] / row["requests"]
        if row["colds"]:
            row["mean_cold_s"] = row["cold_latency_s"] / row["colds"]
    return dict(sorted(out.items()))


def tier_occupancy(events: Iterable[Mapping[str, Any]], *,
                   horizon: Optional[float] = None) -> Dict[str, float]:
    """Integrate resident GB-s per idle warmth tier from dwell intervals.

    Re-derives the ledger's ``idle_gb_s_by_tier`` from events alone:
    a dwell opens at ``idle`` (warm_idle) or ``demote`` (the new tier)
    and closes at the next ``slot_bind``/``promote``/``demote``/
    ``expire`` for that container — or at ``horizon`` (defaults to the
    last event's timestamp) for containers still resident at the end.
    """
    open_dwell: Dict[int, Tuple[str, float, float]] = {}  # cid -> (tier, since, mb)
    gb_s: Dict[str, float] = {}
    last_t = 0.0

    def close(cid: int, t: float) -> None:
        if cid in open_dwell:
            tier, since, mb = open_dwell.pop(cid)
            gb_s[tier] = gb_s.get(tier, 0.0) + (t - since) * mb / 1024.0

    for ev in events:
        kind = ev["kind"]
        last_t = max(last_t, ev["t"])
        if kind == "idle":
            open_dwell[ev["cid"]] = ("warm_idle", ev["t"], ev["resident_mb"])
        elif kind == "demote":
            close(ev["cid"], ev["t"])
            open_dwell[ev["cid"]] = (ev["to_tier"], ev["t"],
                                     ev["resident_mb"])
        elif kind in ("slot_bind", "promote", "expire"):
            close(ev["cid"], ev["t"])
    end = horizon if horizon is not None else last_t
    for cid in list(open_dwell):
        close(cid, end)
    return gb_s


def offload_table(events: Iterable[Mapping[str, Any]]
                  ) -> Dict[str, Dict[str, Any]]:
    """Per-destination routing table from the topology ``offload`` events.

    ``{dst: {requests, offloaded, fraction, net_s, net_mean_s,
    by_class}}`` — ``offloaded`` counts arrivals whose destination was not
    their ingress (``net_s`` is the RTT + transfer those paid).  Returns
    ``{}`` for flat single-cluster logs, so callers can gate on emptiness.
    """
    out: Dict[str, Dict[str, Any]] = {}
    total = 0
    for ev in events:
        if ev["kind"] != "offload":
            continue
        total += 1
        row = out.setdefault(ev["dst"], {
            "requests": 0, "offloaded": 0, "net_s": 0.0, "by_class": {}})
        row["requests"] += 1
        row["offloaded"] += int(ev["dst"] != ev["src"])
        row["net_s"] += ev["rtt_s"] + ev["xfer_s"]
        c = ev["qos_class"]
        row["by_class"][c] = row["by_class"].get(c, 0) + 1
    for row in out.values():
        row["fraction"] = row["requests"] / total
        row["net_mean_s"] = row["net_s"] / row["requests"]
        row["by_class"] = dict(sorted(row["by_class"].items()))
    return dict(sorted(out.items()))


def format_offload_table(table: Dict[str, Dict[str, Any]]) -> str:
    lines = ["offload routing by destination node:"]
    for dst, row in table.items():
        classes = ",".join(f"{c}:{n}" for c, n in row["by_class"].items())
        lines.append(
            f"  {dst:16s} {row['requests']:8d}  "
            f"({row['fraction'] * 100:5.1f}%)  "
            f"net={row['net_mean_s'] * 1e3:7.1f}ms  {classes}")
    return "\n".join(lines)


# --------------------------------------------------------------------------- #
# plain-text report (the CLI's default output)
# --------------------------------------------------------------------------- #
def format_report(stats: List[InvocationStat],
                  occupancy: Dict[str, float]) -> str:
    lines: List[str] = []
    lat = sorted(s.latency for s in stats)
    lines.append(f"invocations: {len(stats)}  "
                 f"p50={_pct(lat, 0.5) * 1e3:.1f}ms  "
                 f"p95={_pct(lat, 0.95) * 1e3:.1f}ms")
    lines.append("")
    lines.append("serving paths:")
    total = max(len(stats), 1)
    for path, n in sorted(serving_paths(stats).items(),
                          key=lambda kv: -kv[1]):
        lines.append(f"  {path:16s} {n:8d}  ({n / total * 100:5.1f}%)")
    lines.append("")
    lines.append("startup phases by serving path (cold paths only):")
    for path, phases in phase_percentiles(stats, by="path").items():
        if "total" not in phases:
            continue
        lines.append(f"  from {path}:")
        for ph in ("provision", "runtime_init", "deps_load", "code_init",
                   "total"):
            if ph in phases:
                p = phases[ph]
                lines.append(
                    f"    {ph:14s} n={int(p['n']):6d}  "
                    f"p50={p['p50'] * 1e3:8.1f}ms  "
                    f"p95={p['p95'] * 1e3:8.1f}ms")
    lines.append("")
    lines.append("cold-start attribution by function:")
    lines.append(f"  {'function':24s} {'reqs':>6s} {'colds':>6s} "
                 f"{'rate':>6s} {'cold s':>9s} {'mean':>8s}")
    for fn, row in cold_attribution(stats).items():
        tiers = ",".join(f"{t}:{n}" for t, n in sorted(row["by_tier"].items()))
        lines.append(
            f"  {fn:24s} {row['requests']:6d} {row['colds']:6d} "
            f"{row['cold_rate'] * 100:5.1f}% {row['cold_latency_s']:9.3f} "
            f"{row['mean_cold_s'] * 1e3:7.1f}ms  {tiers}")
    if occupancy:
        lines.append("")
        lines.append("idle residency by tier (GB-s, from dwell intervals):")
        for tier, v in sorted(occupancy.items()):
            lines.append(f"  {tier:16s} {v:12.3f}")
    return "\n".join(lines)
