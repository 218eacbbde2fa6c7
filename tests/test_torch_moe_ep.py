"""The port's expert-parallel MoE on ``torch.distributed`` (gloo, four CPU
processes) against the port's single-device path and against the JAX
package's ``_moe_ffn_ep`` (its ``shard_map`` over four forced host devices).

Worlds: a ``(data 1, model 4)`` and a ``(data 2, model 2)`` mesh, each rank
holding the whole weights and its data slice of the tokens, with
``reduced(qwen3-moe-30b-a3b)`` and ``reduced(arctic-480b)`` (the dense
residual) in fp32 at B 4 x S 2048: 8192 tokens, two dispatch groups of 4096,
so the EP path is taken (B x S >= 2048) and a data slice of the ``(2, 2)``
mesh is exactly one group of the single-device call.

Quantities: y, the aux loss, and the gradients of ``y.sum()`` and of the aux
loss with respect to x and every leaf.  Each is held within 1e-5 of the
largest magnitude of the value it is compared with, but one: the aux loss's
gradient with respect to x against the reference, at 1e-4.  Its entries are
~1e-9 differences of softmax-Jacobian terms that cancel, summed in fp32 in
another order on each side (1.1e-5 to 3.0e-5 apart here).  The port's EP
path holds it to the port's single-device path at 1e-5.
  * against the single-device path on the rank's data slice: the expert
    leaves' gradients summed over the model group (each rank holds only its
    experts' rows);
  * against the reference: y and the x gradients on the rank's slice, the aux
    loss against the reference's per-device value, the leaves' gradients
    also summed over the data group for ``y.sum()`` and averaged for the aux
    loss, whose x gradient is divided by the data ranks (the reference
    differentiates the mean of the data slices' aux losses).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.config import get_config as jget, reduced as jreduced
from repro.models import moe as jmoe

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3_moe_30b_a3b", "arctic_480b")
MESHES = ((1, 4), (2, 2))
B, S = 4, 2048
TOL = 1e-5
AUX_X_TOL = 1e-4      # the aux loss's x gradient against the reference

_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import sharding
from repro_torch.config import InputShape, get_config, reduced
from repro_torch.models import moe

torch.set_num_threads(1)
rank, dsize, msize, data, out = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                 sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"file://{out}/store", rank=rank,
                        world_size=dsize * msize)
mesh = init_device_mesh("cpu", (dsize, msize), mesh_dim_names=("data", "model"))
di, mi = mesh.get_local_rank("data"), mesh.get_local_rank("model")
inputs = np.load(data)
B, S = inputs["x"].shape[:2]
bl = B // dsize
for arch in json.loads(inputs["archs"].item()):
    cfg = reduced(get_config(arch))
    layer = moe.MoE(cfg, device="meta")
    layer.load_state_dict({k.split("/", 1)[1]: torch.from_numpy(inputs[k])
                           for k in inputs.files if k.startswith(arch + "/")}, assign=True)
    names = [n for n, _ in layer.named_parameters()]
    x = torch.from_numpy(inputs["x"][di * bl:(di + 1) * bl])
    rules = sharding.make_rules(cfg, InputShape("t", S, B, "train"), mesh)
    res = {}

    def run(tag, ep):
        leaves = [p.requires_grad_(True) for _, p in layer.named_parameters()]
        xt = x.clone().requires_grad_(True)
        if ep:
            with sharding.use_rules(rules, mesh):
                y, aux = moe.moe_ffn(layer, xt, cfg)
        else:
            y, aux = moe.moe_ffn(layer, xt, cfg)
        for loss_name, loss in (("y", y.sum()), ("aux", aux)):
            gs = torch.autograd.grad(loss, [xt] + leaves, retain_graph=True,
                                     allow_unused=True)
            gs = [torch.zeros_like(t) if g is None else g for g, t in zip(gs, [xt] + leaves)]
            res[f"{tag}/g{loss_name}/x"] = gs[0]
            for n, g in zip(names, gs[1:]):
                res[f"{tag}/g{loss_name}/{n}"] = g
        res[f"{tag}/y"], res[f"{tag}/aux"] = y.detach(), aux.detach()

    run("single", False)
    moe.allreduce_bytes.update(combine=0, backward=0)
    run("ep", True)
    res["ep/bytes"] = torch.tensor([moe.allreduce_bytes["combine"],
                                    moe.allreduce_bytes["backward"]])
    # each rank holds its experts' gradient rows (and its slice of the dense
    # residual's): their sum over the model group is the whole gradient
    for key in [k for k in res if k.startswith("ep/g")]:
        leaf = key.split("/", 2)[2]
        if leaf not in ("x", "router"):
            dist.all_reduce(res[key], group=mesh.get_group("model"))
        if leaf != "x":     # the reference's gradient over the whole batch
            g = res[key].clone()
            dist.all_reduce(g, group=mesh.get_group("data"))
            if key.startswith("ep/gaux"):
                g /= dsize
            res["global/" + key] = g
    np.savez(f"{out}/{arch}.{rank}.npz", di=di, mi=mi,
             **{k: v.numpy() for k, v in res.items()})
dist.destroy_process_group()
"""

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax, jax.numpy as jnp, numpy as np
from repro import sharding
from repro.config import InputShape, get_config, reduced
from repro.models import moe

inputs = np.load(sys.argv[1])
out = sys.argv[2]
x = jnp.asarray(inputs["x"])
B, S = x.shape[:2]
for arch in json.loads(inputs["archs"].item()):
    cfg = reduced(get_config(arch))
    flat = {k.split("/", 1)[1]: jnp.asarray(inputs[k]) for k in inputs.files
            if k.startswith(arch + "/")}
    p = {k: v for k, v in flat.items() if "." not in k}
    if any(k.startswith("dense.") for k in flat):
        p["dense"] = {k[6:]: v for k, v in flat.items() if k.startswith("dense.")}
    for shape in json.loads(inputs["meshes"].item()):
        mesh = jax.make_mesh(tuple(shape), ("data", "model"))
        rules = sharding.make_rules(cfg, InputShape("t", S, B, "train"), mesh)

        def f(p, x):
            with sharding.use_rules(rules, mesh):
                return moe.moe_ffn(p, x, cfg)

        res = {}
        with mesh:
            y, aux = jax.jit(f)(p, x)
            for name, loss in (("y", lambda p, x: f(p, x)[0].sum()),
                               ("aux", lambda p, x: f(p, x)[1])):
                gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
                res[f"g{name}/x"] = gx
                for k, v in gp.items():
                    if isinstance(v, dict):
                        res.update({f"g{name}/dense.{kk}": vv for kk, vv in v.items()})
                    else:
                        res[f"g{name}/{k}"] = v
        shards = {s.device.id: float(s.data) for s in aux.addressable_shards}
        res["aux_shards"] = np.array([[shards[d.id] for d in row] for row in mesh.devices])
        res["y"] = y
        tag = "x".join(map(str, shape))
        np.savez(f"{out}/ref.{arch}.{tag}.npz", **{k: np.asarray(v) for k, v in res.items()})
"""


def _inputs(tmp_path):
    """The weights (``init_moe`` of each reduced config, by the port's
    names) and x, from seeds, as one npz both sides read."""
    arrays = {"archs": json.dumps(ARCHS), "meshes": json.dumps(MESHES)}
    for i, arch in enumerate(ARCHS):
        cfg = jreduced(jget(arch))
        for k, v in jmoe.init_moe(jax.random.key(i), cfg).items():
            if isinstance(v, dict):
                arrays.update({f"{arch}/{k}.{kk}": np.asarray(vv) for kk, vv in v.items()})
            else:
                arrays[f"{arch}/{k}"] = np.asarray(v)
    d = jreduced(jget(ARCHS[0])).d_model
    arrays["x"] = np.random.default_rng(7).normal(size=(B, S, d)).astype(np.float32)
    path = tmp_path / "inputs.npz"
    np.savez(path, **arrays)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both gloo worlds and the reference's run, started together; their
    results as {(mesh, arch): (per-rank port arrays, reference arrays)}."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    data = _inputs(tmp)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", _REFERENCE, str(data), str(tmp)],
                              env={**env, "JAX_PLATFORMS": "cpu"}, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    for dsize, msize in MESHES:
        out = tmp / f"{dsize}x{msize}"
        out.mkdir()
        procs += [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(dsize),
                                    str(msize), str(data), str(out)], env=env, cwd=ROOT,
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                  for r in range(dsize * msize)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            p.kill()
    got = {}
    for dsize, msize in MESHES:
        tag = f"{dsize}x{msize}"
        for arch in ARCHS:
            ranks = [dict(np.load(tmp / tag / f"{arch}.{r}.npz"))
                     for r in range(dsize * msize)]
            got[(tag, arch)] = ranks, dict(np.load(tmp / f"ref.{arch}.{tag}.npz"))
    return got


def _close(got, want, what, tol=TOL):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * max(scale, 1e-30), f"{what}: max|diff| {err:.3e}, max|want| {scale:.3e}"


CASES = [(f"{d}x{m}", arch) for d, m in MESHES for arch in ARCHS]


@pytest.mark.parametrize("mesh,arch", CASES)
def test_ep_matches_the_single_device_path(runs, mesh, arch):
    ranks, _ = runs[(mesh, arch)]
    for r, res in enumerate(ranks):
        _close(res["ep/y"], res["single/y"], f"rank {r} y")
        _close(res["ep/aux"], res["single/aux"], f"rank {r} aux")
        grads = [k[3:] for k in res if k.startswith("ep/g")]
        assert sorted(grads) == sorted(k[7:] for k in res if k.startswith("single/g"))
        for key in grads:
            _close(res["ep/" + key], res["single/" + key], f"rank {r} {key}")
        # the path did go through the collectives: the combine of fp32 y and
        # the backward of x and the router, for each of the two losses
        combine, backward = res["ep/bytes"]
        assert combine == res["ep/y"].size * 4
        assert backward == 2 * (res["ep/y"].size + res["single/gy/router"].size) * 4


@pytest.mark.parametrize("mesh,arch", CASES)
def test_ep_matches_the_reference_shard_map(runs, mesh, arch):
    ranks, ref = runs[(mesh, arch)]
    dsize = int(mesh.split("x")[0])
    bl = B // dsize
    for r, res in enumerate(ranks):
        di, mi = int(res["di"]), int(res["mi"])
        rows = slice(di * bl, (di + 1) * bl)
        _close(res["ep/y"], ref["y"][rows], f"rank {r} y")
        _close(res["ep/aux"], ref["aux_shards"][di, mi], f"rank {r} aux")
        _close(res["ep/gy/x"], ref["gy/x"][rows], f"rank {r} gy x")
        _close(res["ep/gaux/x"] / dsize, ref["gaux/x"][rows], f"rank {r} gaux x", AUX_X_TOL)
        for loss in ("gy", "gaux"):
            leaves = [k.split("/", 3)[3] for k in res if k.startswith(f"global/ep/{loss}/")]
            assert sorted(leaves) == sorted(k.split("/", 1)[1] for k in ref
                                            if k.startswith(f"{loss}/") and k != f"{loss}/x")
            for leaf in leaves:
                _close(res[f"global/ep/{loss}/{leaf}"], ref[f"{loss}/{leaf}"],
                       f"rank {r} {loss} {leaf}")
