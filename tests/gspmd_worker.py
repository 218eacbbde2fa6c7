"""One rank of a gloo world that runs the port's GSPMD path (DTensor
parameters and batches under ``sharding.use_rules`` on a ``DeviceMesh``) and,
on rank 0, the same cases on the single-device path.  Run by the
``tests/test_torch_gspmd*.py`` files, one process a rank:

    python tests/gspmd_worker.py RANK DATA MODEL INPUTS.npz OUT_DIR

``INPUTS.npz`` holds ``cases`` (JSON: a list of ``{"name", "arch", "reduce",
"seq", "batch", "kind", "expect", "prompt", "steps"}``, ``kind`` one of
``loss``, ``step``, ``prefill``, ``decode``) and, for each case, its weights
under ``<name>/p/<leaf>`` (the port's ``state_dict`` names) and its batch
under ``<name>/b/<key>`` (for ``decode`` the prompt's, and under
``<name>/b/decode`` the tokens each step is fed).  Each rank writes
``OUT_DIR/<rank>.npz``: its parameter bytes and the bytes
``launch.specs.local_shape`` gives, the shapes its kernels' plain versions
were called with (decode's: the caches' local rows, and whether with
statistics), the MoE's DTensor paths, and, on rank 0, every result gathered
whole (``sharded/<name>/...``) beside the single-device path's
(``single/<name>/...``).  A decode case raises if a cache leaf leaves a step
in other placements than ``caches_shardings``'.  It imports no JAX and
nothing of ``repro``.
"""
import json
import math
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import sharding
from repro_torch.config import InputShape, get_config, reduced
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_scan as ss
from repro_torch.launch import specs
from repro_torch.models import moe, registry
from repro_torch.training import optimizer, train_loop

ADAM = optimizer.OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10, eps=1e-3)

seen = []      # (plain version, its first argument's shape), on the sharded runs


def _record(mod, name):
    plain = getattr(mod, name)

    def wrapped(*args, **kw):
        seen.append((name, tuple(args[0].shape)))
        return plain(*args, **kw)

    setattr(mod, name, wrapped)


for _name in ("flash_attention_plain", "flash_attention_bwd_plain"):
    _record(fa, _name)
for _name in ("ssm_scan_plain", "ssm_scan_bwd_plain"):
    _record(ss, _name)

decode_seen = []   # (the local k cache's shape, stats) of each decode plain call
combines = []      # one entry a cross-rank combine
_decode_plain = da.decode_attention_plain


def _decode_recorded(q, k_cache, v_cache, valid_mask, *, stats=False):
    decode_seen.append((tuple(k_cache.shape), stats))
    return _decode_plain(q, k_cache, v_cache, valid_mask, stats=stats)


da.decode_attention_plain = _decode_recorded
_combine = ops.combine_partials


def _combine_recorded(*args, **kw):
    combines.append(1)
    return _combine(*args, **kw)


ops.combine_partials = _combine_recorded

moe_paths = []  # ("ep" or "gspmd", x's whole shape) of each DTensor MoE call
_moe_sharded = moe._moe_ffn_sharded


def _moe_recorded(p, x, cfg, rules, mesh, *, ep):
    moe_paths.append(("ep" if ep else "gspmd", tuple(x.shape)))
    return _moe_sharded(p, x, cfg, rules, mesh, ep=ep)


moe._moe_ffn_sharded = _moe_recorded


def _whole(x):
    return x.full_tensor() if sharding.is_dtensor(x) else x


def _flat(tree, prefix, out, leaf=lambda t: _whole(t).detach().float().numpy()):
    """Every tensor of a nest of dicts / lists under a dotted name, whole
    (a collective on every rank for a DTensor), or as ``leaf`` gives it."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat(tree[k], f"{prefix}.{k}", out, leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat(v, f"{prefix}.{i}", out, leaf)
    elif torch.is_tensor(tree):
        out[prefix] = leaf(tree)
    return out


def _model(bundle, inputs, name):
    model = bundle.empty()
    model.load_state_dict({k[len(name) + 3:]: torch.from_numpy(inputs[k]).clone()
                           for k in inputs.files if k.startswith(name + "/p/")}, assign=True)
    return model


def run(case, bundle, model, batch, state=None):
    """The case's results as {key: tensor or nest}: the loss and gradients,
    a train step's parameters and moments (from ``state``, else a new AdamW
    state), or prefill's logits and caches."""
    if case["kind"] == "loss":
        loss, metrics, grads = train_loop.value_and_grad(bundle, model, batch)
        return {"loss": loss, "metrics": metrics, "grads": grads}
    if case["kind"] == "step":
        if state is None:
            state = optimizer.init_opt_state(train_loop.param_tree(model))
        step = train_loop.make_train_step(bundle, ADAM)
        _, state, metrics = step(model, state, batch)
        return {"params": train_loop.param_tree(model), "m": state.m, "v": state.v,
                "loss": metrics["total_loss"], "grad_norm": metrics["grad_norm"]}
    with torch.no_grad():
        logits, caches, pos = bundle.prefill(model, batch)
    return {"logits": logits, "caches": caches, "pos": torch.tensor(pos)}


def decode(bundle, model, prefilled, fed, place=None):
    """Decode steps after ``prefilled`` = prefill's (logits, caches, next
    position), fed the rows of ``fed`` in turn.  With ``place`` = (rules,
    mesh) the caches and tokens are placed by ``launch/specs.py`` and the
    position is a tensor; every cache leaf must keep its placements."""
    _, caches, pos = prefilled
    placed = None
    if place is not None:
        caches = specs.distribute_caches(caches, *place)
        placed = [list(t.placements) for t in _leaves(caches)]
    logits = []
    with torch.no_grad():
        for i, t in enumerate(fed):
            token = torch.from_numpy(t)
            if place is not None:
                token = specs.distribute_token(token, *place)
            lg, caches = bundle.decode_step(model, caches, token,
                                            pos + i if place is None else torch.tensor(pos + i))
            logits.append(lg)
            if placed is not None and [list(t.placements) for t in _leaves(caches)] != placed:
                raise AssertionError(f"step {i}: cache placements "
                                     f"{[t.placements for t in _leaves(caches)]}, not {placed}")
    return {"logits": logits, "caches": caches}


def _leaves(tree):
    return list(_flat(tree, "", {}, lambda t: t).values())


def main():
    rank, dsize, msize, inputs, out = (int(sys.argv[1]), int(sys.argv[2]),
                                       int(sys.argv[3]), sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store", rank=rank,
                            world_size=dsize * msize)
    mesh = init_device_mesh("cpu", (dsize, msize), mesh_dim_names=("data", "model"))
    inputs = np.load(inputs)
    res = {}
    for case in json.loads(inputs["cases"].item()):
        name = case["name"]
        cfg = reduced(get_config(case["arch"]), **case["reduce"])
        kind = case["kind"] if case["kind"] in ("prefill", "decode") else "train"
        shape = InputShape("t", case["seq"], case["batch"], kind)
        bundle = registry.build(cfg, shape, device="cpu")
        batch = {k[len(name) + 3:]: torch.from_numpy(inputs[k]) for k in inputs.files
                 if k.startswith(name + "/b/")}
        fed = batch.pop("decode", torch.zeros(0)).numpy()
        rules = sharding.make_rules(cfg, shape, mesh)
        for key, want in case.get("expect", {}).items():
            if json.loads(json.dumps(rules.get(key))) != want:
                raise AssertionError(f"{name}: rule {key} is {rules.get(key)!r}, not {want!r}")

        model = _model(bundle, inputs, name)
        if kind == "decode":   # the prefill runs unsharded, before the placement
            with torch.no_grad():
                prefilled = bundle.prefill(model, batch)
        state = optimizer.init_opt_state(train_loop.param_tree(model))
        specs.distribute_params(model, rules, mesh)
        params = dict(model.named_parameters())
        shardings = specs.params_shardings(params, rules, mesh)
        # a state made whole and placed by the specs is the state made on
        # the placed parameters
        state = specs.distribute_opt_state(state, shardings, mesh)
        fresh = optimizer.init_opt_state(params)
        for k, p in params.items():
            for t in (state.m[k], state.v[k], fresh.m[k], fresh.v[k]):
                if list(t.placements) != list(p.placements):
                    raise AssertionError(f"{name}: AdamW state {k} placed {t.placements}")
        res[f"bytes/{name}"] = np.array([
            sum(p.to_local().numel() * p.element_size() for p in params.values()),
            sum(math.prod(specs.local_shape(tuple(p.shape), shardings[k], mesh))
                * p.element_size() for k, p in params.items())])
        for log in (seen, moe_paths, decode_seen, combines):
            log.clear()
        with sharding.use_rules(rules, mesh):
            if kind == "decode":
                out_sharded = decode(bundle, model, prefilled, fed, (rules, mesh))
            else:
                out_sharded = run(case, bundle, model,
                                  specs.distribute_batch(batch, rules, mesh), state)
            # a plain tensor the rules would split is refused (decode: one
            # with a cache's batch and rows)
            names = ("cache_batch", "cache_seq") if kind == "decode" else ("batch", None)
            try:
                sharding.logical(torch.zeros((case["batch"], case["seq"])), names)
                refused = False
            except ValueError:
                refused = True
        res[f"refused/{name}"] = np.array(refused)
        res[f"rules/{name}"] = np.array(json.dumps(rules))
        res[f"seen/{name}"] = np.array(json.dumps(seen))
        res[f"moe/{name}"] = np.array(json.dumps(moe_paths))
        res[f"decode/{name}"] = np.array(json.dumps(decode_seen))
        res[f"combine/{name}"] = np.array(len(combines))
        # gradients and AdamW moments keep their parameters' placements
        for tree in ("grads", "m", "v"):
            for k, g in out_sharded.get(tree, {}).items():
                if list(g.placements) != list(params[k].placements):
                    raise AssertionError(f"{name}: {tree} {k} placed {g.placements}, "
                                         f"its parameter {params[k].placements}")
        flat = _flat(out_sharded, f"sharded/{name}", {})
        if rank == 0:
            res.update(flat)
            if kind == "decode":
                plain = _model(bundle, inputs, name)
                with torch.no_grad():
                    single = decode(bundle, plain, bundle.prefill(plain, batch), fed)
            else:
                single = run(case, bundle, _model(bundle, inputs, name), batch)
            res.update(_flat(single, f"single/{name}", {}))
    np.savez(f"{out}/{rank}.npz", **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
