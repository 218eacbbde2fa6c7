"""Training entrypoint (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        [--smoke] --steps 200 --batch 8 --seq 256 --checkpoint out.npz \
        [--device cuda|cpu]

Trains on the card unless ``--device cpu`` is given; without ``--smoke`` the
config is the full-width one (granite-3-2b: 2.53 B parameters, about 30 GB
of parameters, gradients and AdamW state in bf16 / fp32).  ``--checkpoint``
writes the model's ``state_dict`` in the port's format
(``training/checkpoint.save``).
"""
from __future__ import annotations

import argparse

from repro_torch.config import InputShape, get_config, reduced
from repro_torch.data import pipeline
from repro_torch.models import registry
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains (default cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg, layers=args.layers, d_model=args.d_model)
    shape = InputShape("cli", args.seq, args.batch, "train")
    bundle = registry.build(cfg, max_seq=args.seq, device=args.device)
    data = pipeline.batches(cfg, shape)
    res = train(bundle, data, steps=args.steps,
                opt_cfg=OptimizerConfig(lr=args.lr, warmup_steps=args.steps // 10,
                                        total_steps=args.steps))
    print(f"done: loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f} "
          f"({res.tokens_per_s:.0f} tok/s)")
    if args.checkpoint:
        n = checkpoint.save(args.checkpoint, res.final_params.state_dict(),
                            extra={"arch": args.arch, "steps": args.steps})
        print(f"checkpoint: {args.checkpoint} ({n / 2**20:.1f} MB)")
    return res


if __name__ == "__main__":
    main()
