"""The port's attention kernels against the JAX package's.

On the CPU the port's wrappers run their plain torch versions; the JAX side
runs as its own tests run it (the ``ref.py`` oracles and the Pallas kernels
with ``interpret=True``).  Inputs come from numpy with a seed and enter both
frameworks as the same numbers.  Tolerances are ``tests/test_kernels.py``'s:
3e-5 in fp32, 5e-2 in bf16.  The hand kernels themselves run only on a CUDA
card: ``test_torch_gpu.py`` holds them against these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops, ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=5e-2, rtol=5e-2) if name == "bfloat16" else \
        dict(atol=3e-5, rtol=3e-5)


def _pair(x, name):
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


ATTN_CASES = [
    # (b, sq, skv, hq, hkv, d, causal, window): a subset of test_kernels.py's
    (2, 128, 128, 4, 2, 64, True, None),
    (2, 128, 128, 4, 1, 64, True, 64),      # SWA
    (1, 128, 384, 2, 2, 128, True, None),   # suffix-aligned prefill
    (1, 128, 128, 4, 4, 64, False, None),   # encoder (non-causal)
    (3, 256, 256, 6, 2, 48, True, 128),
    # ragged lengths the hand kernel takes and 64-row tiles do not divide
    (1, 24, 24, 4, 2, 64, True, None),
    (2, 24, 40, 8, 2, 32, True, 16),        # ragged, suffix-aligned, windowed
]


def _attn_inputs(case, seed):
    b, sq, skv, hq, hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, hq, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax(case, dtype):
    causal, window = case[6], case[7]
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in _attn_inputs(case, 0))
    want = _np(jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window))
    pallas = _np(flash_attention_pallas(jq, jk, jv, causal=causal, window=window))
    plain = _np(ops.flash_attention(tq, tk, tv, causal=causal, window=window))
    oracle = _np(ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                     impl="oracle"))
    for got in (plain, oracle):
        np.testing.assert_allclose(got, want, **_tol(dtype))
        np.testing.assert_allclose(got, pallas, **_tol(dtype))


DECODE_CASES = [
    # (b, s, hq, hkv, d): a subset of test_kernels.py's, plus a ragged length
    (2, 512, 8, 2, 64),
    (1, 1024, 4, 4, 128),
    (3, 512, 8, 1, 32),
    (1, 24, 8, 2, 64),
]


def _decode_inputs(case, seed):
    b, s, hq, hkv, d = case
    rng = np.random.default_rng(seed)
    mask = rng.random((b, s)) > 0.25
    if b > 1:
        mask[1] = False          # a fully masked row: the finite sentinel's case
    return (rng.normal(size=(b, hq, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32), mask)


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(case, dtype):
    q, k, v, mask = _decode_inputs(case, 1)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    want = _np(jref.decode_attention_ref(jq, jk, jv, jm))
    pallas = _np(decode_attention_pallas(jq, jk, jv, jm))
    plain = _np(ops.decode_attention(tq, tk, tv, tm))
    oracle = _np(ops.decode_attention(tq, tk, tv, tm, impl="oracle"))
    for got in (plain, oracle):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **_tol(dtype))
        np.testing.assert_allclose(got, pallas, **_tol(dtype))


def test_cpu_tensors_take_the_plain_path_and_count_no_launch(monkeypatch):
    monkeypatch.setattr(tflash, "launches", 0)
    monkeypatch.setattr(tdecode, "launches", 0)
    q, k, v = (torch.from_numpy(x) for x in _attn_inputs(ATTN_CASES[5], 2))
    pos = torch.arange(24, dtype=torch.int32)
    got = tflash.flash_attention_hopper(q, k, v, causal=True, q_pos=pos, kv_pos=pos)
    torch.testing.assert_close(
        got, tflash.flash_attention_plain(q, k, v, causal=True, q_pos=pos, kv_pos=pos),
        rtol=0, atol=0)
    dq, dk, dv, mask = (torch.from_numpy(x) for x in _decode_inputs(DECODE_CASES[3], 3))
    got = tdecode.decode_attention_hopper(dq, dk, dv, mask)
    torch.testing.assert_close(got, tdecode.decode_attention_plain(dq, dk, dv, mask),
                               rtol=0, atol=0)
    assert (tflash.launches, tdecode.launches) == (0, 0)


def test_plain_versions_match_the_oracles_on_default_positions():
    q, k, v = (torch.from_numpy(x) for x in _attn_inputs(ATTN_CASES[2], 4))
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(ops.flash_attention(q, k, v), want,
                               atol=3e-5, rtol=3e-5)


def test_unknown_impl_raises():
    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="unknown attention impl"):
        ops.flash_attention(q, q, q, impl="triton")


# --------------------------------------------------------------------------- #
# the kernels' shape rules against every served config, and parity at the
# head shapes the first kernels refused
# --------------------------------------------------------------------------- #

SERVED_FAMILIES = ("dense", "moe", "hybrid")


def _served_configs():
    from repro_torch.config import ARCH_IDS, get_config
    return [c for c in (get_config(a) for a in ARCH_IDS) if c.family in SERVED_FAMILIES]


def test_every_served_config_fits_the_attention_kernels():
    """Every full dense, MoE and hybrid config's attention shape (Hq, Hkv,
    head_dim, sliding_window) is one both hand kernels take, at a 512-token
    prefill, a one-token decode over the cache and a batch of 4."""
    cfgs = _served_configs()
    assert {c.name for c in cfgs} >= {"h2o-danube-3-4b", "starcoder2-15b",
                                       "granite-3-2b", "jamba-v0.1-52b"}
    for c in cfgs:
        hq, hkv, d = c.num_heads, c.num_kv_heads, c.head_dim
        for b in (1, 4):
            assert tflash.shape_error(b, 512, 512, hq, hkv, d, c.sliding_window) is None, c.name
            assert tflash.shape_error(b, 1, 512, hq, hkv, d, c.sliding_window) is None, c.name
            assert tdecode.shape_error(b, 512, hq, hkv, d) is None, c.name
            assert tdecode.shape_error(b, 4096, hq, hkv, d) is None, c.name


def test_shape_rules_refuse_what_the_kernels_cannot_take():
    assert "multiple of 8" in tflash.shape_error(1, 8, 8, 4, 2, 12)
    assert "multiple of 8" in tflash.shape_error(1, 8, 8, 4, 2, 136)
    assert "group" in tflash.shape_error(1, 8, 8, 6, 4, 64)
    assert "empty" in tflash.shape_error(1, 0, 8, 4, 2, 64)
    assert "window" in tflash.shape_error(1, 8, 8, 4, 2, 64, window=-1)
    assert "multiple of 8" in tdecode.shape_error(1, 64, 8, 2, 100)
    assert "group" in tdecode.shape_error(1, 64, 12, 5, 128)
    assert "shared memory" in tdecode.shape_error(1, 64, 256, 1, 128)
    assert tdecode.shape_error(1, 64, 96, 1, 128) is None   # G * D = 12288: no fixed cap
    assert tflash.shape_error(1, 3, 5, 8, 8, 8) is None


@pytest.mark.parametrize("b,s,hkv,want", [
    (1, 512, 8, 16),      # granite / jamba decode: 16 splits x 8 kv heads = 128 blocks
    (1, 512, 4, 16),      # starcoder2: capped by 32-row chunks
    (1, 24, 8, 1),        # short cache: one chunk
    (1, 1000, 8, 32),     # 32 chunks of 32 rows, the last ragged
    (64, 4096, 8, 1),     # a full batch already fills the card
    (3, 500, 8, 11),
])
def test_decode_splits(b, s, hkv, want):
    splits = tdecode.decode_splits(b, s, hkv)
    assert splits == want
    chunk = -(-s // splits)
    assert chunk >= min(s, tdecode.MIN_CHUNK)
    assert (splits - 1) * chunk < s           # no split is empty


REPAIRED_ATTN_CASES = [
    # (b, sq, skv, hq, hkv, d, causal, window): h2o-danube-3's head shape
    (1, 24, 24, 32, 8, 120, True, None),
    (1, 24, 40, 32, 8, 120, True, 16),       # ragged, suffix-aligned, windowed
    (1, 16, 16, 32, 8, 120, False, None),
]


@pytest.mark.parametrize("case", REPAIRED_ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax_at_danube_head_dim(case, dtype):
    assert tflash.shape_error(*case[:6], window=case[7]) is None
    test_flash_attention_matches_jax(case, dtype)


REPAIRED_DECODE_CASES = [
    # (b, s, hq, hkv, d): starcoder2's grouping (G * D = 12 x 128) and D 120
    (1, 40, 12, 1, 128),
    (2, 40, 12, 1, 128),
    (1, 24, 32, 8, 120),
]


@pytest.mark.parametrize("case", REPAIRED_DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax_at_repaired_shapes(case, dtype):
    b, s, hq, hkv, d = case
    assert tdecode.shape_error(b, s, hq, hkv, d) is None
    test_decode_attention_matches_jax(case, dtype)
