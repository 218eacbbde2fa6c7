"""What ``tests/test_torch_gspmd*.py`` share: the inputs of a gloo world, the
world itself (``tests/gspmd_worker.py``, one process a rank) and the JAX
package's own sharded run beside it, and the comparison.

Weights come from the JAX package (``init`` of the reduced config at
``jax.random.key(0)``) through ``convert.params_from_jax``; no side draws its
own.  The reference runs in a subprocess with ``XLA_FLAGS=
--xla_force_host_platform_device_count=<world>`` on a mesh built with
``AxisType.Auto`` axes: jax 0.9's ``jax.make_mesh`` makes Explicit axes by
default, under which the reference's embedding gather raises
(``ShardingTypeError: Use .at[...].get(out_sharding=)``), while Auto axes
give it GSPMD's propagation, which its ``with_sharding_constraint`` sites
were written for.  Nothing in the JAX package changes for that.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np

from repro.config import get_config as jget, reduced as jreduced
from repro.models import registry as jregistry
from repro_torch import config as tconfig
from repro_torch.data import pipeline as tpipeline
from repro_torch.models.convert import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("gspmd_worker.py")
TOL = 1e-5        # a leaf's largest difference over its largest magnitude; the loss's too
# ... where that magnitude is at least a hundredth of its tree's largest (the
# gradients', m's, v's, the caches'): fp32 rounding scales with the terms a
# leaf sums, not with their sum, and a leaf whose gradient cancels to ~0 (the
# all-ones batch's wq / wk, every token alike: 4e-9 beside the embedding's
# 4.0; the sLSTM's input-gate bias, 1e-10) keeps ~1e-8 of rounding on every
# path, the single-device port against the reference included
FLOOR_FRAC = 1e-2


def case(name, arch, kind, *, seq=32, batch=4, reduce=None, expect=None,
         tokens="pipeline", reference=True, prompt=14, steps=4):
    """One case of a world.  ``kind``: ``loss`` (loss and gradients), ``step``
    (one in-place train step), ``prefill`` or ``decode`` (an unsharded
    prefill of ``prompt`` tokens, then ``steps`` decode steps under the
    decode rules at ``max_seq`` = ``seq``, fed fixed seeded tokens);
    ``tokens``: the pipeline's first batch, ``ones`` (tokens and labels 1,
    the reference test's) or ``random``; ``expect``: rules the case must
    have on the mesh."""
    return {"name": name, "arch": arch, "kind": kind, "seq": seq, "batch": batch,
            "reduce": reduce or {}, "expect": expect or {}, "tokens": tokens,
            "reference": reference and kind != "step", "prompt": prompt, "steps": steps}


def _batch(c):
    cfg = tconfig.reduced(tconfig.get_config(c["arch"]), **c["reduce"])
    seq = c["prompt"] if c["kind"] == "decode" else c["seq"]
    shape = tconfig.InputShape("t", seq, c["batch"], "train")
    b = dict(next(tpipeline.batches(cfg, shape, seed=0)))
    if c["tokens"] == "ones":
        b["tokens"] = np.ones_like(b["tokens"])
        b["labels"] = np.ones_like(b["labels"])
    elif c["tokens"] == "random":
        rng = np.random.default_rng(11)
        b["tokens"] = rng.integers(0, cfg.vocab_size, b["tokens"].shape).astype(np.int32)
        b["labels"] = rng.integers(0, cfg.vocab_size, b["labels"].shape).astype(np.int32)
    if c["kind"] in ("prefill", "decode"):
        b.pop("labels")
    if c["kind"] == "decode":    # the tokens decode is fed, a row a step
        rng = np.random.default_rng(5)
        b["decode"] = rng.integers(0, cfg.vocab_size, (c["steps"], c["batch"])).astype(np.int32)
    return b


def write_inputs(cases, path):
    arrays = {"cases": json.dumps(cases)}
    for c in cases:
        cfg = jreduced(jget(c["arch"]), **c["reduce"])
        params = jregistry.build(cfg, max_seq=c["seq"]).init(jax.random.key(0))
        for k, v in params_from_jax(jax.tree.map(np.asarray, params)).items():
            arrays[f"{c['name']}/p/{k}"] = v.numpy()
        for k, v in _batch(c).items():
            arrays[f"{c['name']}/b/{k}"] = np.asarray(v)
    np.savez(path, **arrays)


_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={sys.argv[3]}"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro import sharding
from repro.config import InputShape, get_config, reduced
from repro.launch import specs as S
from repro.models import registry
from repro_torch.models.convert import params_from_jax

inputs, out = np.load(sys.argv[1]), sys.argv[2]
dsize, msize = int(sys.argv[4]), int(sys.argv[5])
mesh = jax.make_mesh((dsize, msize), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
for c in json.loads(inputs["cases"].item()):
    if not c["reference"]:
        continue
    name = c["name"]
    cfg = reduced(get_config(c["arch"]), **c["reduce"])
    kind = c["kind"] if c["kind"] in ("prefill", "decode") else "train"
    rules = sharding.make_rules(cfg, InputShape("t", c["seq"], c["batch"], kind), mesh)
    bundle = registry.build(cfg, max_seq=c["seq"])
    params = bundle.init(jax.random.key(0))
    for k, v in params_from_jax(jax.tree.map(np.asarray, params)).items():
        assert np.array_equal(v.numpy(), inputs[f"{name}/p/{k}"]), k   # the same weights
    batch = {k[len(name) + 3:]: jnp.asarray(inputs[k]) for k in inputs.files
             if k.startswith(name + "/b/")}
    fed = batch.pop("decode", None)
    res = {}
    if kind == "decode":
        # the prefill unsharded; decode_step jitted under the decode rules on
        # placed parameters, caches and token (the dry run's in_shardings)
        _, caches, pos = jax.jit(bundle.prefill)(params, batch)
        shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), caches)
        caches = jax.tree.map(jax.device_put, caches, S.caches_shardings(shapes, rules, mesh))
        token_sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(
            rules.get("cache_batch")))
    shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params)
    params = jax.tree.map(jax.device_put, params, S.params_shardings(shapes, rules, mesh))
    with sharding.use_rules(rules, mesh), mesh:
        if kind == "decode":
            step = jax.jit(bundle.decode_step)
            for i, t in enumerate(fed):
                res[f"logits.{i}"], caches = step(params, caches,
                                                  jax.device_put(jnp.asarray(t), token_sh),
                                                  jnp.int32(int(pos) + i))
        elif kind == "prefill":
            res["logits"] = jax.jit(bundle.prefill)(params, batch)[0]
        else:
            (loss, _), grads = jax.jit(jax.value_and_grad(bundle.loss, has_aux=True))(
                params, batch)
            res["loss"] = loss
            res.update({"grads." + k: v.numpy() for k, v in params_from_jax(
                jax.tree.map(lambda g: np.asarray(g, np.float32), grads)).items()})
    np.savez(f"{out}/ref.{name}.npz", **{k: np.asarray(v, np.float32) for k, v in res.items()})
"""


def run_world(tmp, cases, dsize, msize, *, timeout=240):
    """The world's ranks and the reference's run, started together.  Returns
    (each rank's results, {case name: the reference's results})."""
    data = tmp / "inputs.npz"
    write_inputs(cases, data)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    world = dsize * msize
    procs = []
    if any(c["reference"] for c in cases):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, str(data), str(tmp), str(world), str(dsize),
             str(msize)], env={**env, "JAX_PLATFORMS": "cpu"}, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    procs += [subprocess.Popen([sys.executable, str(WORKER), str(r), str(dsize), str(msize),
                                str(data), str(tmp)], env=env, cwd=ROOT,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
              for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()
    ranks = [dict(np.load(tmp / f"{r}.npz")) for r in range(world)]
    refs = {c["name"]: dict(np.load(tmp / f"ref.{c['name']}.npz")) for c in cases
            if c["reference"]}
    return ranks, refs


def close(got, want, what, tol=TOL, tree_scale=0.0):
    """``got`` within ``tol`` of ``want``'s largest magnitude, or of
    FLOOR_FRAC of ``tree_scale`` (its tree's largest) where that is more."""
    want = np.asarray(want, np.float64)
    assert np.shape(got) == want.shape, f"{what}: shape {np.shape(got)} != {want.shape}"
    scale = max(float(np.abs(want).max()) if want.size else 0.0, FLOOR_FRAC * tree_scale)
    err = float(np.abs(np.asarray(got, np.float64) - want).max()) if want.size else 0.0
    assert err <= tol * scale, \
        f"{what}: max|diff| {err:.3e}, scale {scale:.3e}, tol {tol:g}"


def _tree_scales(want):
    """The largest magnitude of each tree (a key's first dotted part)."""
    scales = {}
    for key, v in want.items():
        tree = key.split(".", 1)[0]
        scales[tree] = max(scales.get(tree, 0.0), float(np.abs(v).max()) if v.size else 0.0)
    return scales


def results(rank0, tag, name):
    """``{key: array}`` of one case's ``sharded`` or ``single`` results."""
    pre = f"{tag}/{name}."
    return {k[len(pre):]: v for k, v in rank0.items() if k.startswith(pre)}


def seen(rank, name):
    return [tuple(x) for x in json.loads(rank[f"seen/{name}"].item())]


def check_single(world, c, tol=TOL):
    """The sharded results of case ``c`` against the single-device path's:
    the same keys, each within ``tol``."""
    ranks, _ = world
    got, want = results(ranks[0], "sharded", c["name"]), results(ranks[0], "single", c["name"])
    assert sorted(got) == sorted(want) and want
    scales = _tree_scales(want)
    for key in want:
        close(got[key], want[key], f"{c['name']} {key}", tol, scales[key.split(".", 1)[0]])


def check_reference(world, c, tol=TOL, skip=()):
    """The sharded loss and gradients (or prefill's logits) of case ``c``
    against the JAX package's sharded run (but the keys in ``skip``)."""
    ranks, refs = world
    got, ref = results(ranks[0], "sharded", c["name"]), refs[c["name"]]
    keys = [k for k in ref if k not in skip and (k == "loss" or k.split(".")[0] == "logits"
                                                 or k.startswith("grads."))]
    assert keys and sorted(k for k in got if k.startswith("grads.")) == \
        sorted(k for k in keys if k.startswith("grads."))
    scales = _tree_scales({k: ref[k] for k in keys})
    for key in keys:
        close(got[key], ref[key], f"{c['name']} {key} vs reference", tol,
              scales[key.split(".", 1)[0]])


def _global_shapes(c):
    """The whole shapes of the kernels' first inputs in case ``c``: q of the
    flash attention, u of the scan."""
    cfg = tconfig.reduced(tconfig.get_config(c["arch"]), **c["reduce"])
    shapes = {}
    if "A" in cfg.layer_pattern or cfg.encoder is not None:
        shapes["flash_attention_plain"] = (c["batch"], c["seq"], cfg.num_heads, cfg.head_dim)
    if cfg.ssm is not None:
        shapes["ssm_scan_plain"] = (c["batch"], c["seq"], cfg.ssm.expand * cfg.d_model)
    for name in list(shapes):
        shapes[name.replace("_plain", "_bwd_plain")] = shapes[name]
    return shapes


def check_local(world, c, mesh):
    """Every rank holds only its shards of the parameters (their bytes are
    ``specs.local_shape``'s, and a world-th of the whole where everything
    splits), every call of a kernel's plain version took a local shard (a
    world-th of the whole tensor: batch split over ``data``, heads, rows or
    channels over ``model``), every kernel of the case's path ran, and a
    plain tensor the rules would split is refused."""
    ranks, _ = world
    name, world_size = c["name"], mesh[0] * mesh[1]
    shapes = _global_shapes(c)
    want = {k for k in shapes if "bwd" not in k or c["kind"] != "prefill"}
    for r, res in enumerate(ranks):
        have, spec_bytes = res[f"bytes/{name}"]
        assert have == spec_bytes, f"rank {r}: {have} parameter bytes, specs say {spec_bytes}"
        calls = seen(res, name)
        assert {k for k, _ in calls} == want, f"rank {r}: kernels {calls}"
        for kernel, shape in calls:
            whole = shapes[kernel]
            assert np.prod(shape) * world_size == np.prod(whole) and shape[-1] <= whole[-1], \
                f"rank {r}: {kernel} took {shape}, of {whole} over {world_size} ranks"
        assert bool(res[f"refused/{name}"]) == (mesh[0] > 1)


def check_decode_local(world, c, mesh):
    """Decode's local shards on every rank: the parameters' bytes are
    ``specs.local_shape``'s; every call of the decode kernel's plain version
    took this rank's cache rows (a data-th of the batch where ``cache_batch``
    splits it; a model-th of a self cache's rows where ``cache_seq`` splits
    them, the cross cache's whole), with the statistics exactly where the
    rows are split, and one combine for each such call; every cache leaf
    kept ``caches_shardings``' placements (the worker raises if not); a
    plain tensor the decode rules would split is refused."""
    ranks, _ = world
    name = c["name"]
    cfg = tconfig.reduced(tconfig.get_config(c["arch"]), **c["reduce"])
    rules = json.loads(ranks[0][f"rules/{name}"].item())
    b = c["batch"] // (mesh[0] if rules["cache_batch"] else 1)
    split = mesh[1] if rules["cache_seq"] else 1
    rows = min(cfg.sliding_window or c["seq"], c["seq"])
    want = [((b, rows // split, cfg.num_kv_heads, cfg.head_dim), split > 1)]
    if cfg.encoder is not None:
        want.append(((b, cfg.encoder.num_frames, cfg.num_kv_heads, cfg.head_dim), False))
    calls_a_step = cfg.layer_pattern.count("A")
    for r, res in enumerate(ranks):
        have, spec_bytes = res[f"bytes/{name}"]
        assert have == spec_bytes, f"rank {r}: {have} parameter bytes, specs say {spec_bytes}"
        calls = [(tuple(s), stats) for s, stats in json.loads(res[f"decode/{name}"].item())]
        assert len(calls) == c["steps"] * calls_a_step * len(want), f"rank {r}: {calls}"
        assert set(calls) == (set(want) if calls_a_step else set()), f"rank {r}: {calls}"
        assert int(res[f"combine/{name}"]) == sum(stats for _, stats in calls)
        assert bool(res[f"refused/{name}"])


def check_moe_path(world, c, path):
    """Every rank's MoE layers took ``path`` ("ep" or "gspmd") on DTensors."""
    ranks, _ = world
    cfg = tconfig.reduced(tconfig.get_config(c["arch"]), **c["reduce"])
    want = [[path, [c["batch"], c["seq"], cfg.d_model]]] * sum(cfg.moe_layer_mask())
    for res in ranks:
        assert json.loads(res[f"moe/{c['name']}"].item()) == want
