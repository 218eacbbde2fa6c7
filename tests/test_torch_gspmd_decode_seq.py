"""Decode under the decode rules on a ``(data 1, model 4)`` gloo world
(``tests/gspmd_worker.py``): the caches' rows split over four ranks, the
batch whole.  granite-3-2b and whisper-large-v3 decode at positions 14-17 of
a 32-row cache (8 rows a rank: the writes move from the second rank's rows
to the third's, and the fourth's rows are all masked at every step, the
third's at the first two); h2o-danube-3-4b's 64-slot ring (16 slots a
rank) takes positions 60-67, slots 60-63 on the last rank, then 0-3 on the
first.  Reduced, fp32.

Held, as in ``tests/test_torch_gspmd_decode.py``: each step's logits and
every cache leaf against the single-device path, each step's logits
against the JAX package's sharded ``decode_step`` on four forced host
devices, the decode kernel's plain version on a quarter of each self
cache's rows (the cross cache's whole) with the statistics and a combine
over the four ranks, the cache placements after every step, the refusal of
a plain tensor the rules would split.  Tolerances: ``gspmd_common.TOL``.
"""
import pytest

import gspmd_common as G

MESH = (1, 4)
CASES = [
    G.case("granite_seq", "granite-3-2b", "decode"),
    G.case("whisper_seq", "whisper-large-v3", "decode"),
    G.case("danube_seq", "h2o-danube-3-4b", "decode", seq=128, prompt=60, steps=8),
]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return G.run_world(tmp_path_factory.mktemp("gspmd_decode_seq"), CASES, *MESH)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_sharded_decode_matches_the_single_device_path(world, case):
    G.check_single(world, case)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_sharded_decode_matches_the_reference_sharded_decode(world, case):
    G.check_reference(world, case)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_decode_runs_on_local_rows_and_caches_keep_their_placements(world, case):
    G.check_decode_local(world, case, MESH)
