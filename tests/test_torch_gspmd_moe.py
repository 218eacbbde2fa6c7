"""The reference's own sharded case on the port: ``reduced(qwen3-moe-30b-a3b,
d_model=256)`` at ``InputShape("t", 32, 4, "train")`` on a ``(data 2, model
4)`` mesh, here a gloo world of eight CPU processes, with tokens and labels
all ones (the reference test's batch) and with random ones.

At 128 tokens the MoE takes its GSPMD path (under 2048 tokens): one group of
all tokens, which splits over no data rank, so each rank routes the whole
group and multiplies only its experts' rows (``expert`` over ``model``);
``tests/test_torch_gspmd_ep.py`` runs the expert-parallel path.
Four q heads over the model axis of 4 with one kv head: each rank passes the
kernel its q head and the one kv head of its group.

The loss against the JAX package's sharded run (eight forced host devices,
an ``Auto``-axis mesh, its ``use_rules``) and the port's single-device path,
within 1e-5 of its magnitude; every gradient leaf against
``jax.value_and_grad`` under that mesh and against the single-device path,
within 1e-5 of the leaf's largest magnitude.  Also: the parameter bytes of
every rank, the kernels' local shapes, and ``sharding.logical``'s contract
(placements of a spec, the no-op cases, the refusals).
"""
import types

import pytest
import torch

import gspmd_common as G
from repro_torch import sharding
from repro_torch.config import get_config, get_shape
from repro_torch.launch.mesh import MeshShape, make_production_mesh

MESH = (2, 4)
CASES = [
    G.case("ones", "qwen3-moe-30b-a3b", "loss", reduce={"d_model": 256}, tokens="ones",
           expect={"expert": "model", "heads": "model", "kv_heads": None}),
    G.case("random", "qwen3-moe-30b-a3b", "loss", reduce={"d_model": 256}, tokens="random"),
]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return G.run_world(tmp_path_factory.mktemp("gspmd_moe"), CASES, *MESH)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_sharded_matches_the_single_device_path(world, case):
    G.check_single(world, case)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_sharded_matches_the_reference_sharded_run(world, case):
    G.check_reference(world, case)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_parameters_stay_sharded_and_kernels_see_local_shards(world, case):
    G.check_local(world, case, MESH)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_the_moe_takes_its_gspmd_path(world, case):
    G.check_moe_path(world, case, "gspmd")


def _mesh(*names, sizes=None):
    return types.SimpleNamespace(mesh_dim_names=names, shape=sizes or (2,) * len(names))


@pytest.mark.parametrize("spec,want", [
    ((None, "model"), ["R", "S1"]),
    ((("data",), None), ["S0", "R"]),
    (("data", "model"), ["S0", "S1"]),
    ((None, None), ["R", "R"]),
])
def test_placements_of_a_spec(spec, want):
    got = sharding.placements(spec, _mesh("data", "model"))
    assert [f"S{p.dim}" if p.is_shard() else "R" for p in got] == want


def test_placements_split_one_dim_over_axes_in_mesh_order():
    got = sharding.placements((("pod", "data"), "model"), _mesh("pod", "data", "model"))
    assert [p.dim for p in got] == [0, 0, 1]
    with pytest.raises(ValueError, match="mesh's order"):
        sharding.placements((("data", "pod"), None), _mesh("pod", "data", "model"))
    with pytest.raises(ValueError, match="two dims"):
        sharding.placements(("model", "model"), _mesh("data", "model"))
    with pytest.raises(ValueError, match="not in mesh"):
        sharding.placements(("pod",), _mesh("data", "model"))
    # an axis of one rank splits nothing
    got = sharding.placements(("data", "model"), _mesh("data", "model", sizes=(1, 4)))
    assert [p.is_shard() for p in got] == [False, True]


def test_logical_under_a_mesh_shape_returns_its_input():
    cfg, shape = get_config("granite-3-2b"), get_shape("train_4k")
    mesh = make_production_mesh()
    rules = sharding.make_rules(cfg, shape, mesh)
    meta = torch.empty((256, 4096, 2048), device="meta")
    small = torch.zeros(4, 8)
    with sharding.use_rules(rules, mesh):
        # the dry run's meta pass: whole-size meta tensors under production rules
        assert sharding.logical(meta, ("batch", "seq", "embed")) is meta
        assert sharding.logical(small, (None, "embed")) is small
        with pytest.raises(NotImplementedError, match="no devices"):
            sharding.logical(small, ("batch", None))
    one = MeshShape((1, 1), ("data", "model"))
    with sharding.use_rules(sharding.make_rules(cfg, shape, one), one):
        assert sharding.logical(small, ("batch", "heads")) is small


def test_replicate_like_leaves_plain_tensors_alone():
    t = torch.arange(4)
    assert sharding.replicate_like(t, torch.zeros(2)) is t
    assert not sharding.is_dtensor(t)
