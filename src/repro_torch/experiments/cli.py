"""CLI over the scenario registry: list / run / sweep (the port of
``python -m repro.experiments``).

    python -m repro_torch.experiments list [--json]
    python -m repro_torch.experiments run NAME [--driver sim|batch]...
                                   [--json PATH] [--events PATH]
                                   [--require-identical] [--device cuda|cpu]
    python -m repro_torch.experiments sweep NAME [--driver D]
                                   [--axis FIELD=V1,V2,...]...
                                   [--json PATH] [--progress]
                                   [--max-cells N] [--device cuda|cpu]

The batch driver runs on ``--device`` (default ``cuda``: one launch of the
hand kernel; without a card it raises unless ``--device cpu`` is given).
The fleet and engine drivers are not ported yet (ROADMAP A2).

``run`` with several ``--driver`` flags replays the SAME scenario through
each driver and prints the ledger diff; ``--require-identical`` exits
nonzero on any drift (the CI calibration smoke).  ``sweep`` runs a
registered grid, or an ad-hoc one built from ``--axis`` overrides on a
base scenario.  ``--json`` writes machine-readable rows that
``scripts/make_experiments_tables.py scenarios`` renders as a table.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.core.metrics import format_summary
from repro_torch.experiments import registry, runner
from repro_torch.experiments.spec import Scenario
from repro_torch.experiments.sweep import Sweep


DEVICE_HELP = ("where the batch driver runs (default cuda: the hand kernel; "
               "cpu: its plain torch version)")


def _parse_axis(text: str):
    """``field=v1,v2,...`` with JSON-typed values (fallback: string)."""
    if "=" not in text:
        raise argparse.ArgumentTypeError(
            f"--axis wants FIELD=V1,V2,... got {text!r}")
    field, _, raw = text.partition("=")
    values = []
    for tok in raw.split(","):
        try:
            values.append(json.loads(tok))
        except json.JSONDecodeError:
            values.append(tok)
    return field, tuple(values)


def _write_json(path: str, rows) -> None:
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)


def _row(sc: Scenario, driver: str, summary) -> dict:
    return {"scenario": sc.to_dict(), "driver": driver, "summary": summary}


def _cmd_list(args) -> int:
    if args.json:
        _write_json(args.json, {
            "scenarios": [registry.get(n).to_dict()
                          for n in registry.names()],
            "sweeps": [{"name": n,
                        "cells": len(registry.get_sweep(n)),
                        "driver": registry.get_sweep(n).driver,
                        "description": registry.get_sweep(n).description}
                       for n in registry.sweep_names()],
        })
        return 0
    print("scenarios:")
    for name in registry.names():
        sc = registry.get(name)
        print(f"  {name:24s} [{sc.policy:18s}] {sc.description}")
    print("sweeps:")
    for name in registry.sweep_names():
        sw = registry.get_sweep(name)
        print(f"  {name:24s} [{len(sw):3d} cells, driver={sw.driver}] "
              f"{sw.description}")
    return 0


def _events_path(base: str, driver: str, n_drivers: int) -> str:
    """One log per driver: ``PATH`` as-is for a single driver, else
    ``PATH`` with a ``.{driver}.jsonl`` suffix."""
    if n_drivers == 1:
        return base
    stem = base[:-6] if base.endswith(".jsonl") else base
    return f"{stem}.{driver}.jsonl"


def _cmd_run(args) -> int:
    from repro_torch.core.events import EventLog

    sc = registry.get(args.name)
    drivers = args.driver or ["sim"]
    rows, ledgers, logs = [], {}, {}
    for drv in drivers:
        ev = EventLog() if args.events else None
        led = runner.run(sc, drv, events=ev, device=args.device)
        ledgers[drv] = led
        if ev is not None:
            logs[drv] = ev
            path = _events_path(args.events, drv, len(drivers))
            ev.write_jsonl(path)
            print(f"wrote {len(ev)} events to {path}")
        s = runner.summarize(sc, led)
        rows.append(_row(sc, drv, s))
        print(format_summary(f"{sc.name}[{drv}]", s))
    rc = 0
    if len(drivers) >= 2:
        base = drivers[0]
        for drv in drivers[1:]:
            diff = runner.compare(ledgers[base], ledgers[drv],
                                  events_a=logs.get(base),
                                  events_b=logs.get(drv))
            print(f"compare {base} vs {drv}: {diff}")
            rows.append({"scenario": sc.to_dict(),
                         "compare": [base, drv],
                         "identical": diff.identical,
                         "drift": diff.drift()})
            if args.require_identical and not diff.identical:
                rc = 1
    elif args.require_identical:
        print("--require-identical needs at least two --driver flags",
              file=sys.stderr)
        rc = 2
    if args.json:
        _write_json(args.json, rows)
    return rc


def _cmd_sweep(args) -> int:
    if args.axis:
        base = registry.get(args.name)
        sweep = Sweep(name=f"{args.name}-adhoc", base=base,
                      axes=dict(args.axis))
    else:
        sweep = registry.get_sweep(args.name)
    progress = None
    if args.progress:
        def progress(i, total, sc, s):
            print(f"[{i}/{total}] {sc.name}: "
                  f"cold%={s['cold_start_frequency'] * 100:.2f} "
                  f"idle={s['idle_gb_s']:.1f}GB-s", flush=True)
    rows = []
    try:
        for driver in (args.driver or [None]):
            for sc, s in runner.run_sweep(sweep, driver,
                                          progress=progress,
                                          max_cells=args.max_cells,
                                          device=args.device):
                rows.append(_row(sc, driver or sweep.driver, s))
                print(format_summary(
                    f"{sc.name}[{driver or sweep.driver}]", s))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        _write_json(args.json, rows)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments",
        description="run taxonomy-grid scenarios and sweeps")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_list = sub.add_parser("list", help="list registered scenarios/sweeps")
    p_list.add_argument("--json", metavar="PATH")

    p_run = sub.add_parser("run", help="run one scenario on 1+ drivers")
    p_run.add_argument("name")
    p_run.add_argument("--azure-csv", metavar="PATH",
                       help="real Azure Functions trace CSV for the "
                            "azure_stress cells (sets $REPRO_AZURE_CSV)")
    p_run.add_argument("--driver", action="append",
                       choices=runner.DRIVERS,
                       help="repeatable; 2+ drivers also prints the diff")
    p_run.add_argument("--json", metavar="PATH")
    p_run.add_argument("--events", metavar="PATH",
                       help="capture the per-invocation event log to PATH "
                            "(per-driver .{driver}.jsonl suffix when 2+ "
                            "drivers); with --require-identical the diff "
                            "also gates on event-sequence identity")
    p_run.add_argument("--require-identical", action="store_true",
                       help="exit 1 unless all drivers' ledgers (and, with "
                            "--events, event streams) match")
    p_run.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help=DEVICE_HELP)

    p_sw = sub.add_parser("sweep", help="run a registered or ad-hoc grid")
    p_sw.add_argument("name", help="sweep name (or scenario name w/ --axis)")
    p_sw.add_argument("--driver", action="append", choices=runner.DRIVERS)
    p_sw.add_argument("--axis", action="append", type=_parse_axis,
                      metavar="FIELD=V1,V2,...",
                      help="ad-hoc axis over a base *scenario*; repeatable")
    p_sw.add_argument("--json", metavar="PATH")
    p_sw.add_argument("--progress", action="store_true",
                      help="print a [i/N] line as each cell finishes")
    p_sw.add_argument("--max-cells", type=int, default=256, metavar="N",
                      help="refuse grids larger than N cells instead of "
                           "silently running them (default 256)")
    p_sw.add_argument("--azure-csv", metavar="PATH",
                      help="real Azure Functions trace CSV for the "
                           "azure_stress cells (sets $REPRO_AZURE_CSV)")
    p_sw.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                      help=DEVICE_HELP)

    args = ap.parse_args(argv)
    if getattr(args, "azure_csv", None):
        import os

        from repro_torch.core.workload import AZURE_CSV_ENV
        os.environ[AZURE_CSV_ENV] = args.azure_csv
    try:
        return {"list": _cmd_list, "run": _cmd_run,
                "sweep": _cmd_sweep}[args.cmd](args)
    except registry.UnknownScenarioError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
