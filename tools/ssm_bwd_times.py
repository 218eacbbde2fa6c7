#!/usr/bin/env python3
"""Device times of the selective scan's training path from a given source tree.

    python3 tools/ssm_bwd_times.py SRC LABEL

SRC is a ``src`` directory holding ``repro_torch`` (this checkout's, or an
older commit's unpacked with ``git archive``); LABEL names it in the output.
Prints one JSON line: at the two-layer Jamba's training shape (bf16, Bt 8,
T 256, Din 8192, N 16) and SMOKE jamba's (fp32, Bt 2, T 32, Din 512, N 8),
the device ms of the forward and backward through ``SSMScan.apply`` and
``torch.autograd.grad`` and of ``ssm_scan_bwd_hopper`` alone, each by
CUDA-graph replay (``graph_ms`` of ``attention_times.py``: 20 calls
captured, the graph replayed 10 times) and launch by launch, host included
(``loop_ms``); the backward's two kernels' device ms from ``torch.profiler``
(10 calls); the largest error of the backward against
``ssm_scan_bwd_plain``; and a digest of its gradients on these seeded
inputs (two calls of one tree give the same digest).  Needs one CUDA card.
To compare two trees, run both in one go on one card, in turns: old, new,
new, old.
"""
import hashlib
import json
import re
import sys
from pathlib import Path

from attention_times import graph_ms, loop_ms   # this script's directory is on sys.path

# name: (dtype, Bt, T, Din, N)
SHAPES = {"jamba_train": ("bfloat16", 8, 256, 8192, 16),
          "smoke_train": ("float32", 2, 32, 512, 8)}


def _kernel_ms(torch, fn, calls=10):
    """Device ms a call of each CUDA kernel ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us > 0:
            found = re.search(r"ssm_\w+", ev.key)
            name = found.group(0) if found else ev.key[:60]
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def main() -> int:
    src, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        print("ssm_bwd_times: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import ssm_scan as ks

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"tree": label, "device": torch.cuda.get_device_name(0)}
    for name, (dtype, bt, t, din, n) in SHAPES.items():
        dt = getattr(torch, dtype)
        u = torch.randn((bt, t, din), generator=gen, device=dev).to(dt)
        delta = torch.rand((bt, t, din), generator=gen, device=dev) * 0.1
        A = -(torch.rand((din, n), generator=gen, device=dev) + 0.5)
        B, C = (torch.randn((bt, t, n), generator=gen, device=dev).to(dt) for _ in range(2))
        D = torch.randn((din,), generator=gen, device=dev)
        h0 = torch.randn((bt, din, n), generator=gen, device=dev)
        args = (u, delta, A, B, C, D, h0)
        dy = torch.randn((bt, t, din), generator=gen, device=dev).to(dt)
        dhT = torch.randn((bt, din, n), generator=gen, device=dev)
        leaves = [x.clone().requires_grad_(True) for x in args]
        _, _, ckpt = ks.ssm_scan_hopper(*args, checkpoints=True)

        def fwd_bwd():
            y, hT = ks.SSMScan.apply(*leaves)
            return torch.autograd.grad((y, hT), leaves, (dy, dhT))

        def bwd():
            return ks.ssm_scan_bwd_hopper(*args, ckpt, dy, dhT)

        got = bwd()
        want = ks.ssm_scan_bwd_plain(*args, ckpt, dy, dhT)
        digest = hashlib.sha256()
        for g in got:
            digest.update(g.float().cpu().numpy().tobytes())
        out[f"{name}_grads_sha256"] = digest.hexdigest()[:16]
        out[f"{name}_bwd_max_abs_err"] = max((g.float() - w.float()).abs().max().item()
                                             for g, w in zip(got, want))
        out[f"{name}_fwd_bwd_graph_ms"] = graph_ms(torch, fwd_bwd)
        out[f"{name}_bwd_graph_ms"] = graph_ms(torch, bwd)
        out[f"{name}_fwd_bwd_loop_ms"] = loop_ms(torch, fwd_bwd)
        out[f"{name}_bwd_loop_ms"] = loop_ms(torch, bwd)
        out[f"{name}_bwd_kernels_ms"] = _kernel_ms(torch, bwd)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
