"""Dependency-free SVG plot emitters for event logs.

matplotlib is deliberately not used (it is not in the pinned
environment); each function hand-builds a small, self-contained SVG
string and writes it to ``path``.

  timeline_svg    per-container lanes: provisioning / executing / idle
                  tier dwells over virtual time
  breakdown_svg   horizontal stacked bars of mean startup-phase seconds
                  per serving path (the cold-start anatomy figure)
  pareto_svg      generic labelled scatter — used by the CLI for the
                  per-function cold-rate vs p95-latency trade-off
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Sequence, Tuple

from repro_torch.analyze.stats import InvocationStat, phase_percentiles

# state/tier -> fill colour (colour-blind-safe-ish palette)
COLORS = {
    "provisioning": "#e15759",
    "active": "#4e79a7",
    "warm_idle": "#f28e2b",
    "paused": "#76b7b2",
    "snapshot_ready": "#59a14f",
    "img_cached": "#edc948",
    "provision": "#e15759",
    "runtime_init": "#f28e2b",
    "deps_load": "#76b7b2",
    "code_init": "#4e79a7",
    "total": "#9c755f",
}
_FONT = 'font-family="monospace" font-size="11"'


def _esc(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
            .replace('"', "&quot;"))


def _svg(width: int, height: int, body: List[str]) -> str:
    return ('<svg xmlns="http://www.w3.org/2000/svg" '
            f'width="{width}" height="{height}" '
            f'viewBox="0 0 {width} {height}">\n'
            f'<rect width="{width}" height="{height}" fill="white"/>\n'
            + "\n".join(body) + "\n</svg>\n")


def _rect(x: float, y: float, w: float, h: float, fill: str,
          title: str = "") -> str:
    t = f"<title>{_esc(title)}</title>" if title else ""
    return (f'<rect x="{x:.2f}" y="{y:.2f}" width="{max(w, 0.5):.2f}" '
            f'height="{h:.2f}" fill="{fill}">{t}</rect>')


def _text(x: float, y: float, s: str, anchor: str = "start") -> str:
    return (f'<text x="{x:.2f}" y="{y:.2f}" {_FONT} '
            f'text-anchor="{anchor}">{_esc(s)}</text>')


def _legend(items: Sequence[str], x: float, y: float) -> List[str]:
    out = []
    for i, name in enumerate(items):
        out.append(_rect(x + i * 110, y, 10, 10,
                         COLORS.get(name, "#bab0ac")))
        out.append(_text(x + i * 110 + 14, y + 9, name))
    return out


# --------------------------------------------------------------------------- #
def container_intervals(events: Iterable[Mapping[str, Any]]) \
        -> Dict[int, List[Tuple[str, float, float]]]:
    """Per-container ``(state, t0, t1)`` segments for the timeline.

    States: ``provisioning`` (spawn/promote → first slot_bind or idle),
    ``active`` (exec_start → its modeled end), and the idle tier dwells
    (``warm_idle`` / ``paused`` / ``snapshot_ready`` / ``img_cached``).
    """
    lanes: Dict[int, List[Tuple[str, float, float]]] = {}
    open_seg: Dict[int, Tuple[str, float]] = {}

    def close(cid: int, t: float) -> None:
        if cid in open_seg:
            state, t0 = open_seg.pop(cid)
            if t > t0:
                lanes.setdefault(cid, []).append((state, t0, t))

    for ev in events:
        kind, t = ev["kind"], ev["t"]
        cid = ev.get("cid")
        if cid is None:
            continue
        lanes.setdefault(cid, [])
        if kind in ("spawn", "promote"):
            close(cid, t)
            open_seg[cid] = ("provisioning", t)
        elif kind == "exec_start":
            close(cid, t)
            lanes[cid].append(("active", t, ev["end"]))
        elif kind == "idle":
            close(cid, t)
            open_seg[cid] = ("warm_idle", t)
        elif kind == "demote":
            close(cid, t)
            open_seg[cid] = (ev["to_tier"], t)
        elif kind == "expire":
            close(cid, t)
    last_t = 0.0
    for segs in lanes.values():
        for _, _, t1 in segs:
            last_t = max(last_t, t1)
    for cid in list(open_seg):
        close(cid, max(last_t, open_seg[cid][1]))
    return lanes


def timeline_svg(events: Iterable[Mapping[str, Any]], path: str, *,
                 max_lanes: int = 48) -> str:
    """Container-lifecycle timeline; returns the SVG and writes it."""
    lanes = container_intervals(events)
    cids = sorted(lanes)[:max_lanes]
    t_max = max((t1 for cid in cids for _, _, t1 in lanes[cid]),
                default=1.0) or 1.0
    left, top, lane_h, gap, width = 70, 30, 12, 3, 960
    plot_w = width - left - 20
    height = top + len(cids) * (lane_h + gap) + 40

    def sx(t: float) -> float:
        return left + t / t_max * plot_w

    body = [_text(left, 18, f"container timeline ({len(lanes)} containers"
                  + (f", first {len(cids)} shown" if len(lanes) > len(cids)
                     else "") + f", horizon {t_max:.1f}s)")]
    for i, cid in enumerate(cids):
        y = top + i * (lane_h + gap)
        body.append(_text(left - 6, y + lane_h - 2, f"c{cid}", "end"))
        for state, t0, t1 in lanes[cid]:
            body.append(_rect(sx(t0), y, sx(t1) - sx(t0), lane_h,
                              COLORS.get(state, "#bab0ac"),
                              f"c{cid} {state} {t0:.2f}-{t1:.2f}s"))
    body += _legend(("provisioning", "active", "warm_idle", "paused",
                     "snapshot_ready"), left, height - 22)
    svg = _svg(width, height, body)
    with open(path, "w") as f:
        f.write(svg)
    return svg


# --------------------------------------------------------------------------- #
PHASE_ORDER = ("provision", "runtime_init", "deps_load", "code_init")


def breakdown_svg(stats: List[InvocationStat], path: str) -> str:
    """Stacked mean startup-phase seconds per serving path."""
    pcts = phase_percentiles(stats, by="path")
    rows = [(p, ph) for p, ph in pcts.items() if "total" in ph]
    left, top, bar_h, gap, width = 130, 30, 22, 10, 960
    plot_w = width - left - 20
    height = top + max(len(rows), 1) * (bar_h + gap) + 40
    t_max = max((ph["total"]["p50"] for _, ph in rows), default=1.0) or 1.0
    body = [_text(left, 18, "median startup breakdown by serving path (s)")]
    for i, (pname, ph) in enumerate(rows):
        y = top + i * (bar_h + gap)
        body.append(_text(left - 6, y + bar_h - 6,
                          f"from {pname}", "end"))
        x = float(left)
        for phase in PHASE_ORDER:
            if phase not in ph:
                continue
            w = ph[phase]["p50"] / t_max * plot_w
            body.append(_rect(x, y, w, bar_h, COLORS[phase],
                              f"{pname}/{phase} p50="
                              f"{ph[phase]['p50'] * 1e3:.1f}ms"))
            x += w
        body.append(_text(x + 4, y + bar_h - 6,
                          f"{ph['total']['p50'] * 1e3:.1f}ms"))
    body += _legend(PHASE_ORDER, left, height - 22)
    svg = _svg(width, height, body)
    with open(path, "w") as f:
        f.write(svg)
    return svg


# --------------------------------------------------------------------------- #
def pareto_svg(points: Sequence[Tuple[float, float, str]], path: str, *,
               xlabel: str = "x", ylabel: str = "y",
               title: str = "pareto") -> str:
    """Labelled scatter of ``(x, y, label)`` trade-off points."""
    left, top, width, height = 70, 30, 640, 420
    plot_w, plot_h = width - left - 30, height - top - 50
    xs = [p[0] for p in points] or [0.0, 1.0]
    ys = [p[1] for p in points] or [0.0, 1.0]
    x0, x1 = min(xs), max(xs) or 1.0
    y0, y1 = min(ys), max(ys) or 1.0
    xr = (x1 - x0) or 1.0
    yr = (y1 - y0) or 1.0

    def sx(x: float) -> float:
        return left + (x - x0) / xr * plot_w

    def sy(y: float) -> float:
        return top + plot_h - (y - y0) / yr * plot_h

    body = [_text(left, 18, title),
            f'<line x1="{left}" y1="{top + plot_h}" x2="{left + plot_w}" '
            f'y2="{top + plot_h}" stroke="black"/>',
            f'<line x1="{left}" y1="{top}" x2="{left}" '
            f'y2="{top + plot_h}" stroke="black"/>',
            _text(left + plot_w / 2, height - 8, xlabel, "middle"),
            _text(12, top - 8, ylabel)]
    for x, y, label in points:
        body.append(f'<circle cx="{sx(x):.2f}" cy="{sy(y):.2f}" r="4" '
                    f'fill="#4e79a7"><title>{_esc(label)} '
                    f'({x:.4g}, {y:.4g})</title></circle>')
        body.append(_text(sx(x) + 6, sy(y) - 4, label))
    body.append(_text(left - 6, top + plot_h + 4, f"{x0:.3g}", "end"))
    body.append(_text(left + plot_w, top + plot_h + 16, f"{x1:.3g}", "end"))
    body.append(_text(left - 6, top + 10, f"{y1:.3g}", "end"))
    svg = _svg(width, height, body)
    with open(path, "w") as f:
        f.write(svg)
    return svg
