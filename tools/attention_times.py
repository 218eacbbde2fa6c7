#!/usr/bin/env python3
"""Device times of the port's two attention kernels from a given source tree.

    python3 tools/attention_times.py SRC LABEL

SRC is a ``src`` directory holding ``repro_torch`` (this checkout's, or an
older commit's unpacked with ``git archive``); LABEL names it in the output.
Prints one JSON line: for flash attention (causal prefill, S 512) and decode
attention (S 512, every key valid) in bf16, at granite-3-2b's heads (32/8,
D 64) and the Jamba period's (32/8, D 128), the device ms of one call (20
calls captured in a CUDA graph, the graph replayed 10 times) and the ms of
one call launch by launch (host included).  Needs one CUDA card.  To compare
two trees, run both in one go on one card, in turns: old, new, new, old.
"""
import json
import sys
from pathlib import Path


def graph_ms(torch, fn, reps=20, iters=10):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * reps)


def loop_ms(torch, fn, iters=50):
    for _ in range(3):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> int:
    src, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        print("attention_times: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"tree": label, "device": torch.cuda.get_device_name(0)}
    for name, (hq, hkv, d) in {"granite": (32, 8, 64), "jamba": (32, 8, 128)}.items():
        q = torch.randn((1, 512, hq, d), generator=gen, device=dev).bfloat16()
        k = torch.randn((1, 512, hkv, d), generator=gen, device=dev).bfloat16()
        v = torch.randn((1, 512, hkv, d), generator=gen, device=dev).bfloat16()
        pos = torch.arange(512, device=dev, dtype=torch.int32)
        dq = torch.randn((1, hq, d), generator=gen, device=dev).bfloat16()
        mask = torch.ones((1, 512), dtype=torch.bool, device=dev)
        calls = {"flash": lambda: kf.flash_attention_hopper(q, k, v, causal=True,
                                                             q_pos=pos, kv_pos=pos),
                 "decode": lambda: kd.decode_attention_hopper(dq, k, v, mask)}
        for kernel, fn in calls.items():
            out[f"{kernel}_{name}_graph_ms"] = graph_ms(torch, fn)
            out[f"{kernel}_{name}_loop_ms"] = loop_ms(torch, fn)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
