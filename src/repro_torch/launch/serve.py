"""Serving entrypoint: a serverless frontend over real model endpoints.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --requests 6 --ttl 5 --gap 0.5 [--device cuda|cpu]

Registers the arch as a 'function', drives a request sequence through the
router (cold starts are genuinely measured: weight init or snapshot load
plus the kernels' warm-up), prints the QoS summary.  The engines run on the
card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.metrics import format_summary
from repro_torch.serving.router import FunctionDef, ServerlessRouter


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", nargs="+")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--ttl", type=float, default=30.0)
    ap.add_argument("--gap", type=float, default=0.2)
    ap.add_argument("--no-snapshots", action="store_true")
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engines run (default cuda)")
    args = ap.parse_args(argv)

    archs = args.arch if isinstance(args.arch, list) else [args.arch]
    router = ServerlessRouter(ttl_s=args.ttl,
                              use_snapshots=not args.no_snapshots,
                              device=args.device)
    for a in archs:
        router.register(FunctionDef(a, a, max_seq=args.seq,
                                    decode_steps=args.decode_steps))
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        name = archs[i % len(archs)]
        tokens = rng.integers(0, 256, (1, args.seq)).astype(np.int32)
        out, rec = router.invoke(name, tokens)
        kind = "COLD" if rec.cold else "warm"
        extra = f" startup={rec.startup!r}" if rec.cold else ""
        print(f"[{rec.arrival:7.2f}s] {name:18s} {kind} "
              f"latency={rec.latency * 1e3:8.1f}ms{extra}")
        time.sleep(args.gap)
    print(format_summary("summary", router.summary()))


if __name__ == "__main__":
    main()
