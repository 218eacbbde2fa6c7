"""The port's GSPMD path on a ``(data 2, model 2)`` gloo world for the
encoder-decoder (whisper-large-v3), the vision backbone (internvl2-1b, with
image embeddings) and the xLSTM family (xlstm-125m), reduced, fp32, at train
S 32 x B 4: the loss and every gradient leaf against the port's
single-device path and against the JAX package's sharded run on four forced
host devices, every rank's parameter bytes against ``specs.local_shape``,
the kernels' plain versions on local shards (``gspmd_common``).

Tolerances (``gspmd_common``): the loss and each leaf within 1e-5 of their
magnitude, but the xLSTM's leaves within 1e-4.  The xLSTM has no hand
kernel: its recurrences are DTensor ops, split over the batch and
``xlstm_inner``.  Its gradients walk the 32-step stabilised recurrence back
through exp gates, and the mLSTM forget-gate bias's gradient is a sum over
B x T of terms about ten times its size: the model ranks' partial sums of
the split contractions and the data ranks' partial sums of the batch
reorder fp32 sums and move it by ~1e-7, 3e-5 of its magnitude (5e-8 from
the reference's sharded run); every other xLSTM leaf moves by less than
6e-6 of its magnitude.
"""
import pytest

import gspmd_common as G

MESH = (2, 2)
XLSTM_TOL = 1e-4
CASES = [
    G.case("whisper", "whisper-large-v3", "loss"),
    G.case("internvl2", "internvl2-1b", "loss"),
    G.case("xlstm", "xlstm-125m", "loss"),
]


def _tol(case):
    return XLSTM_TOL if case["arch"].startswith("xlstm") else G.TOL


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return G.run_world(tmp_path_factory.mktemp("gspmd_families"), CASES, *MESH)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_sharded_matches_the_single_device_path(world, case):
    G.check_single(world, case, _tol(case))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_sharded_matches_the_reference_sharded_run(world, case):
    G.check_reference(world, case, _tol(case))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_parameters_stay_sharded_and_kernels_see_local_shards(world, case):
    G.check_local(world, case, MESH)


def test_the_vision_batch_carries_image_embeddings(world):
    ranks, _ = world
    assert G.results(ranks[0], "sharded", "internvl2")["metrics.tokens"] < 4 * 32
