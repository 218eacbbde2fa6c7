"""The port's GSPMD path on a ``(data 2, model 2)`` gloo world of four CPU
processes (``tests/gspmd_worker.py``): granite-3-2b, jamba-v0.1-52b and
qwen3-moe-30b-a3b, reduced, fp32, at train S 32 x B 4.

Parameters and batches are DTensors placed by ``launch/specs.py``; the
models' ``sharding.logical`` constraints redistribute them under the rules
of ``make_rules`` for the mesh.  Held here:
  * the loss and every gradient leaf, one in-place AdamW step (parameters,
    m and v) and prefill at a prefill shape (last-token logits and every
    cache leaf), against the port's single-device path on the same weights;
  * the loss and gradients, and prefill's logits, against the JAX package's
    own sharded run on four forced host devices under the same rules;
  * every rank's parameter bytes against ``specs.local_shape``, the shapes
    the kernels' plain versions were called with against the local shards,
    and the refusal of a plain tensor the rules would split.
Tolerances (``gspmd_common``): the loss within 1e-5 of its magnitude, each
leaf within 1e-5 of its largest magnitude.  The train step runs AdamW with
``eps`` 1e-3 on both sides: at 1e-8 the first step divides a gradient by its
own magnitude, so an element whose gradient is ~0 turns a 1e-9 difference of
summation order into a tenth of a step.
"""
import pytest

import gspmd_common as G

MESH = (2, 2)
CASES = [
    G.case("granite", "granite-3-2b", "loss"),
    G.case("granite_step", "granite-3-2b", "step"),
    G.case("granite_prefill", "granite-3-2b", "prefill"),
    G.case("jamba", "jamba-v0.1-52b", "loss"),
    G.case("jamba_prefill", "jamba-v0.1-52b", "prefill"),
    G.case("qwen3_moe_step", "qwen3-moe-30b-a3b", "step"),
]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return G.run_world(tmp_path_factory.mktemp("gspmd"), CASES, *MESH)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_sharded_matches_the_single_device_path(world, case):
    G.check_single(world, case)


@pytest.mark.parametrize("case", [c for c in CASES if c["reference"]], ids=lambda c: c["name"])
def test_sharded_matches_the_reference_sharded_run(world, case):
    G.check_reference(world, case)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_parameters_stay_sharded_and_kernels_see_local_shards(world, case):
    G.check_local(world, case, MESH)
