"""One rank of a gloo world that runs the port's GSPMD path (DTensor
parameters and batches under ``sharding.use_rules`` on a ``DeviceMesh``) and,
on rank 0, the same cases on the single-device path.  Run by the
``tests/test_torch_gspmd*.py`` files, one process a rank:

    python tests/gspmd_worker.py RANK DATA MODEL INPUTS.npz OUT_DIR

``INPUTS.npz`` holds ``cases`` (JSON: a list of ``{"name", "arch", "reduce",
"seq", "batch", "kind", "expect"}``, ``kind`` one of ``loss``, ``step``,
``prefill``) and, for each case, its weights under ``<name>/p/<leaf>`` (the
port's ``state_dict`` names) and its batch under ``<name>/b/<key>``.  Each
rank writes ``OUT_DIR/<rank>.npz``: its parameter bytes and the bytes
``launch.specs.local_shape`` gives, the shapes its kernels' plain versions
were called with, the MoE's DTensor paths, and, on rank 0, every result gathered whole
(``sharded/<name>/...``) beside the single-device path's
(``single/<name>/...``).  It imports no JAX and nothing of ``repro``.
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
from repro_torch.kernels import flash_attention as fa
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

moe_paths = []  # ("ep" or "gspmd", x's whole shape) of each DTensor MoE call
_moe_sharded = moe._moe_ffn_sharded


def _moe_recorded(p, x, cfg, rules, mesh, *, ep):
    moe_paths.append(("ep" if ep else "gspmd", tuple(x.shape)))
    return _moe_sharded(p, x, cfg, rules, mesh, ep=ep)


moe._moe_ffn_sharded = _moe_recorded


def _whole(x):
    return x.full_tensor() if sharding.is_dtensor(x) else x


def _flat(tree, prefix, out):
    """Every tensor of a nest of dicts / lists under a dotted name, whole
    (a collective on every rank for a DTensor)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat(tree[k], f"{prefix}.{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat(v, f"{prefix}.{i}", out)
    elif torch.is_tensor(tree):
        out[prefix] = _whole(tree).detach().float().numpy()
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
        shape = InputShape("t", case["seq"], case["batch"],
                           "prefill" if case["kind"] == "prefill" else "train")
        bundle = registry.build(cfg, shape, device="cpu")
        batch = {k[len(name) + 3:]: torch.from_numpy(inputs[k]) for k in inputs.files
                 if k.startswith(name + "/b/")}
        rules = sharding.make_rules(cfg, shape, mesh)
        for key, want in case.get("expect", {}).items():
            if json.loads(json.dumps(rules.get(key))) != want:
                raise AssertionError(f"{name}: rule {key} is {rules.get(key)!r}, not {want!r}")

        model = _model(bundle, inputs, name)
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
        seen.clear()
        moe_paths.clear()
        with sharding.use_rules(rules, mesh):
            out_sharded = run(case, bundle, model, specs.distribute_batch(batch, rules, mesh),
                              state)
            # a plain tensor the rules would split is refused
            try:
                sharding.logical(batch["tokens"], ("batch", None))
                refused = False
            except ValueError:
                refused = True
        res[f"refused/{name}"] = np.array(refused)
        res[f"rules/{name}"] = np.array(json.dumps(rules))
        res[f"seen/{name}"] = np.array(json.dumps(seen))
        res[f"moe/{name}"] = np.array(json.dumps(moe_paths))
        # gradients and AdamW moments keep their parameters' placements
        for tree in ("grads", "m", "v"):
            for k, g in out_sharded.get(tree, {}).items():
                if list(g.placements) != list(params[k].placements):
                    raise AssertionError(f"{name}: {tree} {k} placed {g.placements}, "
                                         f"its parameter {params[k].placements}")
        flat = _flat(out_sharded, f"sharded/{name}", {})
        if rank == 0:
            res.update(flat)
            single = run(case, bundle, _model(bundle, inputs, name), batch)
            res.update(_flat(single, f"single/{name}", {}))
    np.savez(f"{out}/{rank}.npz", **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
