"""Dry run (port of ``repro.launch.dryrun``): every (architecture × input
shape) on the production meshes, with no devices and no allocation.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--both-meshes]
        [--no-compile] [--out results.json]

Each pair's record keeps the reference's keys where their meaning carries
over.  Two passes:

* the spec pass (``--no-compile``): the rules on the mesh
  (``sharding.make_rules``), the partition spec of every argument
  (``launch.specs``) and ``bytes_per_device["argument"]``, each leaf counted
  at its per-device ``local_shape``: the parameters, the AdamW state (fp32 m
  and v, the int32 step) and the batch for train; the parameters and the
  batch for prefill; the parameters, the caches, the token and the position
  for decode.
* the meta pass (the default, in place of the reference's lower + compile):
  the entry point run on meta tensors at full size under the rules, with the
  weights from ``bundle.empty()`` — the train step (loss, backward, the
  in-place AdamW), ``prefill`` or ``decode_step``; ``lower_s`` is its
  seconds.  The hand kernels' meta branches give empty outputs and launch
  nothing.  ``collectives`` holds the all-reduce bytes a device sends in the
  expert-parallel MoE's combine (the only collective the port places); the
  pass runs the global batch, so its bytes are divided by the ranks the
  rules split the tokens over.

``bytes_per_device`` also has the reference's ``output``, ``temp`` and
``peak``, which are null: a meta tensor has no storage and the pass no
allocator, so nothing measures what an execution would hold live (XLA's
``memory_analysis`` reads its buffer assignment).  There is no HLO, so no
``collective_bytes`` parser and no ``hlo_flops`` (``launch.roofline``
counts FLOPs and bytes on the meta pass).
"""
from __future__ import annotations

import argparse
import json
import math
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import sharding
from repro_torch.config import (ARCH_IDS, SHAPES, InputShape, get_config, get_shape,
                                supports_shape)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import moe, registry
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train_loop import make_train_step, param_tree

SKIP_REASON = ("full-attention arch: long_500k requires sub-quadratic attention "
               "(DESIGN.md §3)")


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in sharding.axis_sizes(mesh).values())


def _leaf_bytes(x: torch.Tensor, spec, mesh) -> int:
    return math.prod(S.local_shape(tuple(x.shape), spec, mesh)) * x.element_size()


def _tree_bytes(tree, specs, mesh) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(tree[k], specs[k], mesh) for k in tree)
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(t, s, mesh) for t, s in zip(tree, specs))
    return _leaf_bytes(tree, specs, mesh)


def argument_bytes(bundle, shape: InputShape, rules, mesh) -> int:
    """Per-device bytes of the entry point's arguments, each leaf at its
    ``local_shape`` under its partition spec."""
    cfg = bundle.cfg
    ispec = registry.input_specs(cfg, shape)
    params = bundle.params_spec()
    p_sh = S.params_shardings(params, rules, mesh)
    total = _tree_bytes(params, p_sh, mesh)
    if shape.kind == "train":
        # AdamW: fp32 m and v mirror the params, the step is an int32 scalar
        total += 2 * sum(math.prod(S.local_shape(tuple(x.shape), p_sh[k], mesh)) * 4
                         for k, x in params.items()) + 4
    if shape.kind in ("train", "prefill"):
        batch = ispec["batch"]
        return total + _tree_bytes(batch, S.batch_shardings(batch, rules, mesh), mesh)
    caches = ispec["caches"]
    total += _tree_bytes(caches, S.caches_shardings(caches, rules, mesh), mesh)
    total += _leaf_bytes(ispec["token"], (rules.get("cache_batch"),), mesh)
    return total + ispec["pos"].element_size()


def meta_entry(bundle, shape: InputShape) -> Callable[[], Any]:
    """The shape's entry point on meta tensors at full size, weights from
    ``bundle.empty()``: a call runs it once and returns its outputs."""
    ispec = registry.input_specs(bundle.cfg, shape)
    params = bundle.empty()
    if shape.kind == "train":
        opt_state = init_opt_state(param_tree(params))
        step = make_train_step(bundle, OptimizerConfig())
        return lambda: step(params, opt_state, ispec["batch"])[2]

    def serve():
        with torch.no_grad():
            if shape.kind == "prefill":
                return bundle.prefill(params, ispec["batch"])
            return bundle.decode_step(params, ispec["caches"], ispec["token"], ispec["pos"])
    return serve


def _token_shards(rules, shape: InputShape, mesh) -> int:
    """The ranks the rules split a (B, S) token batch over (an axis that does
    not divide its dim is dropped, as the reference's EP ``shard_map`` does)."""
    n = 1
    for ax, dim in ((rules.get("batch"), shape.global_batch), (rules.get("seq"), shape.seq_len)):
        size = sharding._axsize(mesh, ax)
        if dim % size == 0:
            n *= size
    return n


def dry_run(cfg, shape: InputShape, mesh, *, meta: bool = True) -> Dict[str, Any]:
    """One pair's record on ``mesh`` (no skip check): the spec pass, and the
    meta pass where ``meta``."""
    rec: Dict[str, Any] = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name(mesh)}
    rules = sharding.make_rules(cfg, shape, mesh)
    bundle = registry.build(cfg, shape, device="meta")
    rec["bytes_per_device"] = {"argument": argument_bytes(bundle, shape, rules, mesh),
                               "output": None, "temp": None, "peak": None}
    rec["collectives"] = None
    if meta:
        moe.allreduce_bytes.update(combine=0, backward=0)
        t0 = time.perf_counter()
        with sharding.use_rules(rules, mesh):
            meta_entry(bundle, shape)()
        rec["lower_s"] = round(time.perf_counter() - t0, 2)
        combine = moe.allreduce_bytes["combine"] / _token_shards(rules, shape, mesh)
        rec["collectives"] = {"all-reduce": combine} if combine else {}
        rec["collective_bytes_total"] = float(combine)
    rec["num_params"] = int(cfg.param_count())
    rec["num_params_active"] = int(cfg.param_count(active_only=True))
    rec["status"] = "ok"
    return rec


def run_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
             do_compile: bool = True) -> Dict[str, Any]:
    """The reference's entry: ``arch`` x ``shape_name`` on the production
    mesh; ``do_compile`` runs the meta pass."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    if not supports_shape(cfg, shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
                "status": "skipped", "reason": SKIP_REASON}
    rec = dry_run(cfg, shape, mesh, meta=do_compile)
    rec["arch"] = arch
    return rec


def run_all(archs, shapes, meshes, *, do_compile: bool, out: Optional[str] = None,
            echo: bool = True) -> Tuple[list, Dict[str, int]]:
    """Every pair on every mesh (``meshes``: multi_pod flags); an error is
    recorded and the run goes on.  Returns the records and the counts."""
    results = []
    for mp in meshes:
        for a in archs:
            for s in shapes:
                t0 = time.perf_counter()
                try:
                    rec = run_pair(a, s, multi_pod=mp, do_compile=do_compile)
                except Exception as e:  # noqa: BLE001 — report, keep going
                    rec = {"arch": a, "shape": s, "mesh": "2x16x16" if mp else "16x16",
                           "status": "error", "error": repr(e)[:500]}
                rec["wall_s"] = round(time.perf_counter() - t0, 2)
                results.append(rec)
                if echo:
                    print(json.dumps(rec), flush=True)
                if out:
                    with open(out, "w") as f:
                        json.dump(results, f, indent=1)
    counts = {k: sum(1 for r in results if r["status"] == k) for k in ("ok", "skipped", "error")}
    return results, counts


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-compile", action="store_true",
                    help="the spec pass only (no meta pass)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    t0 = time.perf_counter()
    results, n = run_all(archs, shapes, meshes, do_compile=not args.no_compile, out=args.out)
    print(f"# dry-run: {n['ok']} ok, {n['skipped']} skipped, {n['error']} errors "
          f"/ {len(results)} pairs in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
