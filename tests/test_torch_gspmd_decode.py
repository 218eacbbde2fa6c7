"""Decode under the decode rules on the port's GSPMD path, a ``(data 2,
model 2)`` gloo world of four CPU processes (``tests/gspmd_worker.py``):
an unsharded prefill of a 14-token prompt at ``max_seq`` 32 and B 4, then
the caches placed by ``launch.specs.distribute_caches`` (batch over
``data``, rows over ``model``) and 4 decode steps at positions 14-17, fed
fixed seeded tokens; the writes cross the row boundary at 16.  Cases:
granite-3-2b, jamba-v0.1-52b (attention, Mamba and MoE decode),
qwen3-moe-30b-a3b, whisper-large-v3 (self caches split, cross caches
whole), xlstm-125m (no attention: states split by batch only) and
h2o-danube-3-4b (window 64 at ``max_seq`` 128: a 60-token prompt and 8 steps
wrap the ring from slot 63 to slot 0, across the two ranks), reduced, fp32.

Held here: each step's logits and every cache leaf after the last step
against the port's single-device path; each step's logits against the JAX
package's ``decode_step`` jitted under the same rules on four forced host
devices (parameters, caches and token placed as its dry run places them);
the decode kernel's plain version on each rank's own rows, with the
statistics and a cross-rank combine exactly where the rows are split; the
cache placements after every step (the worker raises); the refusal of a
plain tensor the rules would split.  Tolerances: ``gspmd_common.TOL``.
"""
import pytest

import gspmd_common as G

MESH = (2, 2)
CASES = [
    G.case("granite", "granite-3-2b", "decode"),
    G.case("jamba", "jamba-v0.1-52b", "decode"),
    G.case("qwen3_moe", "qwen3-moe-30b-a3b", "decode"),
    G.case("whisper", "whisper-large-v3", "decode"),
    G.case("xlstm", "xlstm-125m", "decode"),
    G.case("danube", "h2o-danube-3-4b", "decode", seq=128, prompt=60, steps=8),
]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return G.run_world(tmp_path_factory.mktemp("gspmd_decode"), CASES, *MESH)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_sharded_decode_matches_the_single_device_path(world, case):
    G.check_single(world, case)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_sharded_decode_matches_the_reference_sharded_decode(world, case):
    G.check_reference(world, case)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_decode_runs_on_local_rows_and_caches_keep_their_placements(world, case):
    G.check_decode_local(world, case, MESH)
