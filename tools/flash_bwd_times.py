#!/usr/bin/env python3
"""Device times of the flash-attention training path from a given source tree.

    python3 tools/flash_bwd_times.py SRC LABEL

SRC is a ``src`` directory holding ``repro_torch`` (this checkout's, or an
older commit's unpacked with ``git archive``); LABEL names it in the output.
Prints one JSON line: at granite-3-2b's training shape (bf16, B 8, S 256,
32/8 heads, D 64, causal) and the forecaster's (fp32, B 64, S 16, 4/4 heads,
D 8, causal), the device ms of the forward and backward through
``FlashAttention.apply`` and ``torch.autograd.grad`` (an interface every tree
of the port since training shares), of that forward alone, and of serving's
forward with no grad, each by CUDA-graph replay (``graph_ms`` of
``attention_times.py``: 20 calls captured, the graph replayed 10 times);
and the forward and backward launch by launch, host included (``loop_ms``);
and a digest of serving's forward output on these seeded inputs, so that two
trees' lines show whether serving's forward is bit-equal across them.
Needs one CUDA card.  To compare two trees, run both in one go on one card,
in turns: old, new, new, old.
"""
import hashlib
import json
import sys
from pathlib import Path

from attention_times import graph_ms, loop_ms

# name: (dtype, B, S, Hq, Hkv, D)
SHAPES = {"granite_train": ("bfloat16", 8, 256, 32, 8, 64),
          "forecaster_train": ("float32", 64, 16, 4, 4, 8)}


def main() -> int:
    src, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_times: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import flash_attention as kf

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"tree": label, "device": torch.cuda.get_device_name(0)}
    for name, (dtype, b, s, hq, hkv, d) in SHAPES.items():
        dt = getattr(torch, dtype)
        q = torch.randn((b, s, hq, d), generator=gen, device=dev).to(dt).requires_grad_(True)
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dt).requires_grad_(True)
                for _ in range(2))
        dout = torch.randn((b, s, hq, d), generator=gen, device=dev).to(dt)
        pos = torch.arange(s, device=dev, dtype=torch.int32)

        def train_fwd():
            return kf.FlashAttention.apply(q, k, v, pos, pos, True, None)

        def fwd_bwd():
            return torch.autograd.grad(train_fwd(), (q, k, v), dout)

        def serve():
            with torch.no_grad():
                return kf.flash_attention_hopper(q, k, v, causal=True, q_pos=pos, kv_pos=pos)

        served = serve().cpu().view(torch.int16 if dt == torch.bfloat16 else torch.int32)
        out[f"{name}_serve_fwd_sha256"] = hashlib.sha256(served.numpy().tobytes()).hexdigest()[:16]
        out[f"{name}_fwd_bwd_graph_ms"] = graph_ms(torch, fwd_bwd)
        out[f"{name}_train_fwd_graph_ms"] = graph_ms(torch, train_fwd)
        out[f"{name}_serve_fwd_graph_ms"] = graph_ms(torch, serve)
        out[f"{name}_fwd_bwd_loop_ms"] = loop_ms(torch, fwd_bwd)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
