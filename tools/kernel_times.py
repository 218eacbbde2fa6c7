#!/usr/bin/env python3
"""Device times of the port's cluster-step and selective-scan kernels from a
given source tree.

    python3 tools/kernel_times.py SRC LABEL

SRC is a ``src`` directory holding ``repro_torch`` (this checkout's, or an
older commit's unpacked with ``git archive``); LABEL names it in the output.
Prints one JSON line: the ms of one ``cluster_sim_hopper`` call on the built
``batch_dense64`` and ``batch_grid64`` tables, and of one ``ssm_scan_hopper``
call at the Jamba prefill (Bt 1, T 512, Din 8192, N 16) in bf16 and fp32,
each by CUDA-graph replay (device time: 20 calls captured, the graph replayed
10 times; the cluster step 2 calls, replayed 5 times) and launch by launch
(host included).  Needs one CUDA card.  To compare two trees, run both in
one go on one card, in turns: old, new, new, old.
"""
import json
import sys
from pathlib import Path

from attention_times import graph_ms, loop_ms   # this script's directory is on sys.path


def main() -> int:
    src, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    sys.path.insert(0, str(src))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.core import batchsim
    from repro_torch.experiments import registry, runner
    from repro_torch.kernels import cluster_step as kc
    from repro_torch.kernels import ssm_scan as ks

    dev = torch.device("cuda")
    out = {"tree": label, "device": torch.cuda.get_device_name(0)}
    for grid in ("batch_dense64", "batch_grid64"):
        tables = batchsim.build_tables(registry.get_sweep(grid).scenarios(),
                                       trace_fn=runner.build_trace)
        args = [torch.from_numpy(np.ascontiguousarray(getattr(tables, name))).to(dev)
                for name in ("nw", "fs", "free", "arrivals", "conc", "fparam", "promote",
                             "dwell", "ntier", "frac", "scal")]
        call = lambda: kc.cluster_sim_hopper(*args)       # noqa: E731
        out[f"cluster_{grid}_graph_ms"] = graph_ms(torch, call, reps=2, iters=5)
        out[f"cluster_{grid}_loop_ms"] = loop_ms(torch, call, iters=10)
    gen = torch.Generator(device=dev).manual_seed(1)
    bt, t, din, n = 1, 512, 8192, 16
    for dtype in ("bfloat16", "float32"):
        tdt = getattr(torch, dtype)
        u = torch.randn((bt, t, din), generator=gen, device=dev).to(tdt)
        delta = torch.rand((bt, t, din), generator=gen, device=dev) * 0.1
        A = -(torch.rand((din, n), generator=gen, device=dev) + 0.5)
        B = torch.randn((bt, t, n), generator=gen, device=dev).to(tdt)
        C = torch.randn((bt, t, n), generator=gen, device=dev).to(tdt)
        D = torch.randn((din,), generator=gen, device=dev)
        h0 = torch.randn((bt, din, n), generator=gen, device=dev)
        call = lambda: ks.ssm_scan_hopper(u, delta, A, B, C, D, h0)   # noqa: E731
        out[f"ssm_{dtype}_graph_ms"] = graph_ms(torch, call)
        out[f"ssm_{dtype}_loop_ms"] = loop_ms(torch, call)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
