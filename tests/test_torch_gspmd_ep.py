"""The expert-parallel MoE on DTensor activations: ``reduced(qwen3-moe-30b-a3b,
d_model=256)`` at train S 2048 x B 4 (8192 tokens, at least the 2048 that
take the EP path) on a ``(data 2, model 2)`` gloo world of four CPU
processes.  Each data rank's 4096 tokens are one dispatch group, as they are
of the single-device call (two groups of 4096), and each model rank
dispatches only its two experts (``_moe_ffn_sharded(..., ep=True)``: the
reference's ``shard_map``).

The loss and every gradient leaf against the port's single-device path
within 1e-5 of their magnitudes; the gradients against the JAX package's
sharded run (its ``shard_map``) likewise, and its loss within 2e-3, the
reference's own tolerance: its ``shard_map`` returns each device's own aux
loss under a replicated out_spec, so its loss carries one data slice's aux
loss, while its gradient differentiates their mean
(``tests/test_torch_moe_ep.py``); the port's loss is the mean, the
single-device path's.  The two differ by the router's aux weight times the
slices' spread (8e-4 of 6.8 here).
"""
import pytest

import gspmd_common as G

MESH = (2, 2)
REFERENCE_LOSS_TOL = 2e-3
CASES = [G.case("ep", "qwen3-moe-30b-a3b", "loss", reduce={"d_model": 256}, seq=2048,
                expect={"expert": "model", "moe_group": ("data",)})]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return G.run_world(tmp_path_factory.mktemp("gspmd_ep"), CASES, *MESH)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_the_moe_takes_its_expert_parallel_path(world, case):
    G.check_moe_path(world, case, "ep")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_sharded_matches_the_single_device_path(world, case):
    G.check_single(world, case)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_sharded_gradients_match_the_reference_shard_map(world, case):
    ranks, refs = world
    got, ref = G.results(ranks[0], "sharded", case["name"]), refs[case["name"]]
    G.close(got["loss"], ref["loss"], "loss vs reference", REFERENCE_LOSS_TOL)
    G.check_reference(world, case, skip=("loss",))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_parameters_stay_sharded_and_kernels_see_local_shards(world, case):
    G.check_local(world, case, MESH)
