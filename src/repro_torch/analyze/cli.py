"""``python -m repro_torch.analyze <events.jsonl> [...]`` — event-log analysis.

Default output is the plain-text report (invocation percentiles, serving
paths, startup-phase breakdown, cold attribution, tier occupancy).

  --json            machine-readable version of the same tables
  --validate        schema-check only; exit 1 on problems
  --fidelity        sim-predicted vs measured startup table (uses the
                    scenario recorded in the log header, or --scenario)
  --plots DIR       write timeline.svg / breakdown.svg / pareto.svg
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from repro_torch.core.events import EventLog, validate_events

from repro_torch.analyze import stats as S
from repro_torch.analyze.calibrate import fidelity_report, format_fidelity
from repro_torch.analyze.reader import InvalidEventLog, read_events


def _scenario_functions(log: EventLog, override: Optional[str]):
    """Function specs for the run, via the scenario name stamped in the
    log header (or ``--scenario``)."""
    name = override or log.meta.get("scenario")
    if not name:
        return None, None
    from repro_torch.experiments import registry, runner
    sc = registry.resolve(name)
    return sc, dict(runner.build_trace(sc).functions)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analyze",
        description="Analyze a per-invocation event log (events.jsonl).")
    ap.add_argument("events", help="path to an events JSONL file")
    ap.add_argument("--json", action="store_true",
                    help="emit tables as JSON instead of text")
    ap.add_argument("--validate", action="store_true",
                    help="schema-check only (exit 1 on problems)")
    ap.add_argument("--fidelity", action="store_true",
                    help="score the scenario's cost model vs measured "
                         "startups")
    ap.add_argument("--scenario",
                    help="scenario name (default: from the log header)")
    ap.add_argument("--plots", metavar="DIR",
                    help="write timeline/breakdown/pareto SVGs to DIR")
    args = ap.parse_args(argv)

    if args.validate:
        log = EventLog.read_jsonl(args.events)
        problems = validate_events(log.events)
        for p in problems:
            print(p, file=sys.stderr)
        print(f"{args.events}: {len(log.events)} events, "
              f"{len(problems)} problem(s)")
        return 1 if problems else 0

    try:
        log = read_events(args.events)
    except InvalidEventLog as e:
        print(e, file=sys.stderr)
        return 1
    inv = S.invocations(log.events)
    occupancy = S.tier_occupancy(log.events)
    offloads = S.offload_table(log.events)   # {} for flat-cluster logs

    if args.json:
        payload = {
            "meta": log.meta,
            "n_events": len(log.events),
            "counts": log.counts(),
            "invocations": len(inv),
            "serving_paths": S.serving_paths(inv),
            "phase_percentiles": S.phase_percentiles(inv, by="path"),
            "cold_attribution": S.cold_attribution(inv),
            "tier_occupancy_gb_s": occupancy,
            "offloading": offloads,
        }
        print(json.dumps(payload, indent=2, sort_keys=True))
    else:
        meta = " ".join(f"{k}={v}" for k, v in sorted(log.meta.items()))
        print(f"# {args.events}  ({len(log.events)} events"
              + (f"; {meta}" if meta else "") + ")")
        print(S.format_report(inv, occupancy))
        if offloads:
            print()
            print(S.format_offload_table(offloads))

    if args.fidelity:
        sc, functions = _scenario_functions(log, args.scenario)
        if functions is None:
            print("--fidelity needs a scenario (none in the log header; "
                  "pass --scenario NAME)", file=sys.stderr)
            return 2
        rows = fidelity_report(log.events, functions, sc.cost_model())
        print()
        print(format_fidelity(rows, title=f"fidelity[{sc.name}]"))

    if args.plots:
        from repro_torch.analyze import plots as P
        os.makedirs(args.plots, exist_ok=True)
        P.timeline_svg(log.events, os.path.join(args.plots, "timeline.svg"))
        P.breakdown_svg(inv, os.path.join(args.plots, "breakdown.svg"))
        att = S.cold_attribution(inv)
        pcts = S.phase_percentiles(inv, by="function")
        points = [(row["cold_rate"], pcts[fn]["latency"]["p95"], fn)
                  for fn, row in att.items() if fn in pcts]
        P.pareto_svg(points, os.path.join(args.plots, "pareto.svg"),
                     xlabel="cold-start rate",
                     ylabel="latency p95 (s)",
                     title="per-function cold rate vs p95 latency")
        print(f"\nwrote {args.plots}/{{timeline,breakdown,pareto}}.svg")
    return 0
