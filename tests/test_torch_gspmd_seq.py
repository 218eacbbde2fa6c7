"""Sequence parallelism on the port's GSPMD path: granite-3-2b reduced (4 q
heads, 1 kv head), fp32, at train S 64 x B 4 on a ``(data 1, model 8)`` gloo
world of eight CPU processes.  Four heads do not divide the model axis of 8,
so the rules turn on the context-parallel ``attn_seq`` (each rank's 8
queries against the whole keys and values, at their global positions) and
the sequence-parallel residual (``seq`` over ``model``); the worker asserts
both rules before it runs, so the path cannot quietly go away.

The loss and every gradient leaf against the port's single-device path and
the JAX package's sharded run on eight forced host devices, within 1e-5 of
their magnitudes (``gspmd_common``); the parameter bytes of every rank and
the kernels' local shapes (a rank's rows: an eighth of q).
"""
import json

import pytest

import gspmd_common as G

MESH = (1, 8)
CASES = [G.case("granite_seq", "granite-3-2b", "loss", seq=64,
                expect={"attn_seq": "model", "seq": "model", "heads": None})]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return G.run_world(tmp_path_factory.mktemp("gspmd_seq"), CASES, *MESH)


def test_context_and_sequence_parallel_rules_are_active(world):
    ranks, _ = world
    for res in ranks:
        rules = json.loads(res["rules/granite_seq"].item())
        assert rules["attn_seq"] == "model" and rules["seq"] == "model"
        assert rules["heads"] is None
        # a rank's queries: its eighth of the rows, all heads, the whole batch
        assert {tuple(s) for _, s in G.seen(res, "granite_seq")} == {(4, 8, 4, 64)}


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_sharded_matches_the_single_device_path(world, case):
    G.check_single(world, case)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_sharded_matches_the_reference_sharded_run(world, case):
    G.check_reference(world, case)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_parameters_stay_sharded_and_kernels_see_local_shards(world, case):
    G.check_local(world, case, MESH)
