"""One run of a benchmark cell with an ``EventLog`` given to the program's
router, and the cold starts split by the program's spans.

    python3 tools/spans_run.py --log 1 [--no-check] [--out PATH] -- \
        --workload starcoder2-15b.cold-bursts --seed 7 --seconds 51 --trace 0

Everything after ``--`` goes to the benchmark's harness (``perfbench/run.py``),
which prints its result line as it does alone.  ``--log 0`` runs the harness
as it is (no log: the program's untraced path), ``--log 1`` gives the router
an ``EventLog``, so the two can be run in turns to read what the log costs.
With the log the tool then prints one JSON line, ``{"spans": ...}``: for each
cold invoke of the window sent after the traced stretch, the record's wait
(start - arrival) beside the router's share (``router.serve`` start -
``router.invoke`` start - ``engine.cold_start``), each span of the cold
start in ms and their counters; their means; and the warm request loop's
spans (``engine.prefill``, ``engine.decode_step``, ``engine.readback``,
``engine.h2d``) in ms.  With ``--trace 1`` the program's spans that overlap the
traced stretch join the harness's own, so the breakdown's idle gaps are named
by the innermost program span (``request.engine.deps_load``).  ``--no-check``
skips the reference's check after the window (the line then reads
``correct: false``), for timing runs; ``--out`` writes the whole log as
JSONL.  Needs what the harness needs (a CUDA card, or ``--device cpu
--smoke``).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
sys.path[:0] = [os.path.join(ROOT, "perfbench"), os.path.join(ROOT, "src")]

COLD = ("engine.build_check", "engine.provision", "engine.runtime_init", "engine.deps_load",
        "engine.code_init", "engine.libraries", "engine.warmup", "engine.cold_start",
        "pool.start_replica", "router.place")
WARM = ("engine.h2d", "engine.prefill", "engine.decode_step", "engine.readback")


def _ms(span) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e6


def _within(span, outer) -> bool:
    return outer["start_ns"] <= span["start_ns"] and span["end_ns"] <= outer["end_ns"]


def split(events, records, after_ns: int):
    """Per invoke of ``records`` (the router's, in order) whose
    ``router.invoke`` span starts at or after ``after_ns``: the cold
    starts' spans and counters, and the warm request loop's spans."""
    spans = [e for e in events if e["kind"] == "span"]
    invokes = [s for s in spans if s["name"] == "router.invoke"]
    if len(invokes) != len(records):
        raise RuntimeError(f"{len(invokes)} router.invoke spans for {len(records)} records")
    cold, warm = [], {name: [] for name in WARM}
    for outer, (arrival, start, is_cold) in zip(invokes, records):
        if outer["start_ns"] < after_ns:
            continue
        inner = {}
        for s in spans:
            if s is not outer and _within(s, outer):
                inner.setdefault(s["name"], []).append(s)
        if not is_cold:
            for name in WARM:
                warm[name] += [_ms(s) for s in inner.get(name, [])]
            continue
        (serve,) = inner["router.serve"]
        (engine,) = inner["engine.cold_start"]
        wait_ms = (serve["start_ns"] - outer["start_ns"]) / 1e6
        row = {"record_wait_ms": 1e3 * (start - arrival), "wait_ms": wait_ms,
               "router_ms": wait_ms - _ms(engine)}
        for name in COLD:
            for s in inner.get(name, []):
                row[name.split(".", 1)[1] + "_ms"] = _ms(s)
                row.update(s.get("n", {}))
        cold.append(row)
    means = {k: statistics.mean(r[k] for r in cold) for k in (cold[0] if cold else {})}
    return {"cold": cold, "cold_means": means,
            "warm_means_ms": {k: statistics.mean(v) for k, v in warm.items() if v},
            "warm_counts": {k: len(v) for k, v in warm.items()}}


def main(argv) -> int:
    if "--" not in argv:
        raise SystemExit("usage: spans_run.py [--log 0|1] [--no-check] [--out PATH] -- "
                         "<perfbench/run.py arguments>")
    cut = argv.index("--")
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--log", type=int, choices=(0, 1), default=1)
    p.add_argument("--no-check", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv[:cut])

    from benchlib import run as harness
    from repro_torch.core.events import EventLog
    from repro_torch.serving.router import ServerlessRouter

    logs, records, window = [], [], {}
    if args.log:
        init, invoke = ServerlessRouter.__init__, ServerlessRouter.invoke

        def logged_init(self, *a, **k):
            logs.append(k.setdefault("events", EventLog()))
            init(self, *a, **k)

        def kept_invoke(self, *a, **k):
            out, rec = invoke(self, *a, **k)
            records.append((rec.arrival, rec.start, rec.cold))
            return out, rec

        ServerlessRouter.__init__, ServerlessRouter.invoke = logged_init, kept_invoke
        finish, run_window = harness.Tracer.finish, harness.run_window

        def finish_with_spans(self, elapsed):
            if self.state == "active":
                self._close(elapsed)
            if len(self.markers) == 2:
                a, b = self.markers
                window["stretch_end_ns"] = b
                self.spans += [(e["name"], e["start_ns"], e["end_ns"]) for e in logs[-1]
                               if e["kind"] == "span" and e["end_ns"] >= a
                               and e["start_ns"] <= b]
            finish(self, elapsed)

        def timed_window(*a, **k):
            window["open_ns"] = time.perf_counter_ns()
            return run_window(*a, **k)

        harness.Tracer.finish, harness.run_window = finish_with_spans, timed_window
    if args.no_check:
        harness.check.judge = lambda served, cell, seed, *, device: {}
    rc = harness.main(argv[cut + 1:], t_start=T_START)
    if rc != 0 or not args.log:
        return rc
    (log,) = logs
    if args.out:
        log.write_jsonl(args.out)
    after = window.get("stretch_end_ns", window["open_ns"])
    print(json.dumps({"spans": split(log.events, records, after)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
