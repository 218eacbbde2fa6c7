"""The readings a cell's limit is set from, on several seeds in one process.

    python3 perfbench/tools/readings.py --workload <cell> --seeds 11,12,13 --seconds 12

Sets the cell up once and runs a short window at the cell's own load for
each seed; then, with the program's replicas released, samples each
window's rows as a run does (``check.sample_rows``) and prints one JSON line
a seed: the program's widest logit gap against the reference (a lower
reading) and the control's, the fp8 reference's own first tokens read
against the same reference (an upper reading).  The reference's weights are
drawn once.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
sys.path[:0] = [HERE, os.path.join(ROOT, "src")]


def readings(cell, served, ref, seed: int, device: str) -> dict:
    import torch
    from benchlib import check

    rows = check.sample_rows(served, cell, seed)
    prompts, tokens = check.row_arrays(served, rows)
    t0 = time.perf_counter()
    ref_logits = ref.logits(prompts, tokens)
    ref_s = time.perf_counter() - t0
    ctrl = ref.logits(prompts, tokens, precision="fp8").argmax(-1)
    out = {"workload": cell.name, "seed": seed, "invokes": len(served),
           "failed": sum(s.error is not None for s in served),
           "cold": sum(bool(s.record and s.record.cold) for s in served),
           "rows": len(rows), "tokens": int(tokens.size),
           "program_gap": check.widest_gap(ref_logits, tokens),
           "control_gap": check.widest_gap(ref_logits, ctrl.cpu().numpy()),
           "control_first_differs": float((ctrl.cpu().numpy() != tokens).mean()),
           "reference_s": ref_s}
    del ref_logits, ctrl
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=12.0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--smoke", action="store_true")
    args = p.parse_args(argv)
    import torch
    from benchlib import check, run, spec
    from benchlib.endpoint import opened

    torch.set_num_threads(2)
    from benchlib.reference import DenseLM

    cell = spec.load_cell(args.workload, smoke=args.smoke)
    seeds = [int(s) for s in args.seeds.split(",")]
    with opened(cell, device=args.device, smoke=args.smoke) as endpoint:
        run.set_up(endpoint, cell, seeds[0])
        windows = [run.run_window(endpoint, cell, seed, args.seconds,
                                  run.Tracer(None, args.device))[0] for seed in seeds]
    run.free_device(args.device)
    ref = DenseLM(cell.config, device=args.device, seed=check.ENGINE_SEED)
    for seed, served in zip(seeds, windows):
        print(json.dumps(readings(cell, served, ref, seed, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
