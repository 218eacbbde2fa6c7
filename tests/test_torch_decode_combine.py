"""Decode attention split over a cache's rows and merged: the kernel's row
statistics and ``ops.combine_partials``, on the CPU.

The decode rules split a KV cache's rows over ranks (``cache_seq``); each
rank takes the decode kernel's statistics on its rows (``stats=True``: the
fp32 output, each row's max score m and its sum of exponentials l) and the
ranks merge them.  Here the plain version runs on 2 and 4 contiguous row
slices of one cache, and the slices' results, stacked, are merged by
``combine_partials`` with no process group (``tests/test_torch_gspmd_decode
*.py`` run the merge across gloo ranks).  The merge is held against the
whole-cache plain call and against the JAX package's
``repro.kernels.ops.decode_attention`` (``impl`` "reference" and "oracle")
on the same seeded numpy arrays, within 3e-5 (the reference's fp32
tolerance).  Cases: GQA groups 1, 4, 7; a slice wholly masked (weight
exactly 0); every key masked (the mean of V); a valid key only in the last
slice.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import NEG_INF

B, S, HKV, D = 2, 64, 2, 32
TOL = dict(atol=3e-5, rtol=3e-5)
# the valid rows of each batch row
MASKS = {
    "ragged": lambda idx: np.stack([idx <= 40, idx <= 9]),      # later slices all masked
    "slice_masked": lambda idx: np.stack([idx % 32 < 16, idx >= 48]),
    "none_valid": lambda idx: np.zeros((B, S), bool),
    "last_only": lambda idx: np.stack([idx == S - 1, idx >= S - 3]),
}


def _inputs(g, mask, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, g * HKV, D)).astype(np.float32)
    k = rng.normal(size=(B, S, HKV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, HKV, D)).astype(np.float32)
    return q, k, v, MASKS[mask](np.arange(S))


def _split(q, k, v, mask, parts):
    """The plain version's statistics on ``parts`` contiguous row slices,
    stacked on a new first dim."""
    n = S // parts
    outs = [tdecode.decode_attention_plain(q, k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n],
                                           mask[:, i * n:(i + 1) * n], stats=True)
            for i in range(parts)]
    return tuple(torch.stack(t) for t in zip(*outs))


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("g", [1, 4, 7])
def test_split_and_combine_matches_the_whole_call_and_the_reference(g, mask, parts):
    arrays = _inputs(g, mask)
    q, k, v, m = (torch.from_numpy(x) for x in arrays)
    got = ops.combine_partials(*_split(q, k, v, m, parts), dtype=q.dtype).numpy()
    np.testing.assert_allclose(got, tdecode.decode_attention_plain(q, k, v, m).numpy(), **TOL)
    jq, jk, jv, jm = (jnp.asarray(x) for x in arrays)
    for impl in ("reference", "oracle"):
        want = np.asarray(jops.decode_attention(jq, jk, jv, jm, impl=impl))
        np.testing.assert_allclose(got, want, **TOL, err_msg=impl)
    if mask == "none_valid":     # the mean of every V, as in the reference
        mean = np.repeat(arrays[2].mean(axis=1), g, axis=1)
        np.testing.assert_allclose(got, mean, **TOL)


@pytest.mark.parametrize("g", [1, 4, 7])
def test_a_wholly_masked_slice_weighs_exactly_zero(g):
    q, k, v, m = (torch.from_numpy(x) for x in _inputs(g, "slice_masked"))
    out, mm, ll = _split(q, k, v, m, 4)
    # batch row 0: slices 1 and 3 are masked; row 1: slices 0-2
    for b, masked in ((0, (1, 3)), (1, (0, 1, 2))):
        for s in masked:
            assert (mm[s, b] == NEG_INF).all() and (ll[s, b] == S // 4).all()
        w = ll[:, b] * torch.exp(mm[:, b] - mm[:, b].amax(dim=0))
        assert (w[list(masked)] == 0).all() and (w.sum(dim=0) > 0).all()
    # a combine that leaves the masked slices out gives the same bits
    keep = [0, 2]
    alone = ops.combine_partials(out[keep][:, :1], mm[keep][:, :1], ll[keep][:, :1])
    assert torch.equal(ops.combine_partials(out[:, :1], mm[:, :1], ll[:, :1]), alone)


@pytest.mark.parametrize("mask", list(MASKS))
def test_statistics_follow_the_kernel_conventions(mask):
    q, k, v, m = (torch.from_numpy(x) for x in _inputs(4, mask, seed=1))
    out, mm, ll = tdecode.decode_attention_plain(q, k, v, m, stats=True)
    assert out.dtype == mm.dtype == ll.dtype == torch.float32
    assert out.shape == q.shape and mm.shape == ll.shape == q.shape[:2]
    torch.testing.assert_close(out, tdecode.decode_attention_plain(q, k, v, m), **TOL)
    none = ~m.any(dim=1)
    assert (mm[none] == NEG_INF).all() and (ll[none] == S).all()
    assert (ll[~none] >= 1).all() and (mm[~none] > NEG_INF).all()
    # the oracle's statistics are the same numbers
    for a, b in zip(ref.decode_attention_ref(q, k, v, m, stats=True), (out, mm, ll)):
        torch.testing.assert_close(a, b, **TOL)
    # the wrapper on CPU tensors is the plain version, statistics included
    for a, b in zip(tdecode.decode_attention_hopper(q, k, v, m, stats=True), (out, mm, ll)):
        assert torch.equal(a, b)


def test_statistics_on_meta_tensors_are_shapes_only():
    q = torch.empty((B, 8, D), device="meta", dtype=torch.bfloat16)
    k = torch.empty((B, S, HKV, D), device="meta", dtype=torch.bfloat16)
    mask = torch.empty((B, S), device="meta", dtype=torch.bool)
    out, mm, ll = tdecode.decode_attention_hopper(q, k, k, mask, stats=True)
    assert out.shape == (B, 8, D) and mm.shape == ll.shape == (B, 8)
    assert {t.dtype for t in (out, mm, ll)} == {torch.float32}


def test_combine_rounds_once_to_the_asked_dtype():
    q, k, v, m = (torch.from_numpy(x) for x in _inputs(4, "ragged", seed=2))
    parts = _split(q, k, v, m, 2)
    f32 = ops.combine_partials(*parts)
    assert f32.dtype == torch.float32
    assert torch.equal(ops.combine_partials(*parts, dtype=torch.bfloat16),
                       f32.to(torch.bfloat16))
