"""The config's long shapes, at small width: the port against the JAX package
on the same weights (``params_from_jax``) and inputs, on the CPU.

- The sliding-window ring wraps in prefill (``_format_caches``' roll) and in
  decode (slot ``pos % window``): danube SMOKE with its window cut to 16
  slots, and jamba SMOKE built for ``long_500k``, where ``resolve_window``
  gives 4096 and a small ``max_seq`` makes the ring ``min(4096, max_seq)``.
- Decode at positions 32767 and 524287: RoPE's fp32 angles reach 5.2e5
  radians, where torch's and XLA's ``cos`` / ``sin`` could part; the tables
  are held within two ulps (measured: at most one, 5.96e-8), the logits at
  the models' 1e-4.
- A prefill of S tokens against a prefill of S - 16 followed by 16 decode
  steps fed the same tokens, in the port alone: one function, two routes
  (whole softmax against the ring or cache and the recurrent hand-off).
- The plain flash attention evaluated over slices of q rows (the card's
  reference at 32768 keys) against the whole plain call and the JAX oracle.
- The kernels' shape rules at 32768 and 4096 rows and on the 4096 ring, for
  every config.
- The card's bf16 row gate (``chip_smoke.ROW_TOL``) at the long shapes: it
  refuses an output with the last key tile dropped, which the absolute 5e-2
  gate passes, and takes a row whose exact value is zero.

Logits and caches are held at 1e-4 abs / rel, ``tests/test_torch_models.py``'s
tolerance: both sides run the same fp32 arithmetic in another summation
order (~1e-6 on 2-layer logits); a misrolled ring or a wrong slot moves them
by 1e-2 or more.
"""
import dataclasses
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro_torch import config as tconfig
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.models import layers as tlayers
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import params_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)
# RoPE tables: two ulps of a value in [0.5, 1) (2 x 2^-24), no relative part
ROPE_TOL = dict(atol=2 * 2.0 ** -24, rtol=0.0)
B = 2


def _models(arch, *, shape=None, max_seq, impl="reference", **changes):
    """The JAX bundle and weights, and the port's bundle carrying them;
    ``changes`` replace fields of both SMOKE configs."""
    jcfg = dataclasses.replace(importlib.import_module(f"repro.configs.{arch}").SMOKE,
                               attention_impl=impl, **changes)
    tcfg = dataclasses.replace(importlib.import_module(f"repro_torch.configs.{arch}").SMOKE,
                               **changes)
    jb = jregistry.build(jcfg, None if shape is None else jconfig.SHAPES[shape],
                         max_seq=max_seq)
    tb = tregistry.build(tcfg, None if shape is None else tconfig.SHAPES[shape],
                         max_seq=max_seq, device="cpu")
    assert tb.window == jb.window and tb.max_seq == jb.max_seq
    jparams = jb.init(jax.random.key(0))
    model = tb.empty()
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)), assign=True)
    return jb, jparams, tb, model


def _assert_caches(tb, tcaches, jcaches, what):
    """Layer l of the port is JAX's period position l % period, repeat
    l // period."""
    per = ttransformer.period_len(tb.cfg)
    for layer, c in enumerate(tcaches):
        want = jcaches[layer % per]
        assert set(c) == set(want)
        for key, t in c.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(want[key][layer // per]),
                                       err_msg=f"{what} layer {layer} {key}", **TOL)


def _run_both(jb, jparams, tb, model, tokens, steps, first_pos=None):
    """Prefill ``tokens`` on both sides, then a decode step for each row of
    ``steps`` at ``first_pos`` + i (default: right after the prompt), holding
    the logits after every call and the caches after the prefill and at the
    end.  Returns the port's last caches."""
    prompt = tokens.shape[1]
    jlogits, jcaches, jpos = jax.jit(jb.prefill)(jparams, {"tokens": jnp.asarray(tokens)})
    tlogits, tcaches, tpos = tb.prefill(model, {"tokens": torch.from_numpy(tokens)})
    assert tpos == int(jpos) == prompt
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    _assert_caches(tb, tcaches, jcaches, "after prefill")
    start = prompt if first_pos is None else first_pos
    jstep = jax.jit(jb.decode_step)
    for i, tok in enumerate(steps):
        pos = start + i
        jlogits, jcaches = jstep(jparams, jcaches, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        tlogits, tcaches = tb.decode_step(model, tcaches, torch.from_numpy(tok), pos)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   err_msg=f"decode at position {pos}", **TOL)
    _assert_caches(tb, tcaches, jcaches, "after decode")
    return tcaches


def _tokens(tb, prompt, steps, seed=0, batch=B):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, tb.cfg.vocab_size, (batch, prompt)).astype(np.int32),
            rng.integers(0, tb.cfg.vocab_size, (steps, batch)).astype(np.int32))


# --------------------------------------------------------------------------- #
# the wrapped ring against the JAX package
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_danube_ring_wraps_in_prefill_and_decode_matches_jax(impl):
    """A 16-slot ring: the 40-token prompt keeps positions 24-39, rolled by
    24 % 16 = 8; 12 decode steps (positions 40-51) pass the ring's end at
    48.  JAX runs its jnp oracles or its Pallas kernels (interpreted)."""
    jb, jparams, tb, model = _models("h2o_danube3_4b", max_seq=128, impl=impl,
                                     sliding_window=16)
    assert tb.window == 16
    tokens, steps = _tokens(tb, 40, 12)
    caches = _run_both(jb, jparams, tb, model, tokens, steps)
    assert caches[0]["k"].shape == (B, 16, tb.cfg.num_kv_heads, tb.cfg.head_dim)


def test_jamba_long_500k_window_ring_matches_jax():
    """jamba SMOKE at ``long_500k``: ``resolve_window`` gives 4096 on both
    sides, so the attention layer's cache is a ring of min(4096, 32) = 32
    slots; the 40-token prompt wraps it, 8 decode steps write on."""
    jb, jparams, tb, model = _models("jamba_v01_52b", shape="long_500k", max_seq=32)
    assert tb.window == 4096
    tokens, steps = _tokens(tb, 40, 8, seed=1)
    caches = _run_both(jb, jparams, tb, model, tokens, steps)
    attn = tb.cfg.layer_pattern.index("A")
    assert caches[attn]["k"].shape[1] == 32


# --------------------------------------------------------------------------- #
# rope at large angles
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("head_dim", [64, 120, 128])
def test_rope_tables_at_large_positions_match_jax(head_dim):
    """cos / sin of fp32 angles up to 524287 rad (head dims of granite,
    danube, Jamba): torch's and XLA's CPU functions within two ulps."""
    pos = np.array([0, 4095, 4096, 8191, 32767, 32768, 262143, 524287], np.int32)
    jc, js = jlayers.rope_cos_sin(jnp.asarray(pos), head_dim, 10000.0)
    tc, ts = tlayers.rope_cos_sin(torch.from_numpy(pos), head_dim, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **ROPE_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **ROPE_TOL)


@pytest.mark.parametrize("pos", [32767, 524287])
def test_ring_decode_at_large_positions_matches_jax(pos):
    """danube SMOKE built for ``long_500k`` (max_seq 524288, a 64-slot
    ring): a wrapped 80-token prefill, then decode steps at ``pos`` and the
    two positions after it (slots pos % 64 on)."""
    jb, jparams, tb, model = _models("h2o_danube3_4b", shape="long_500k", max_seq=None)
    assert tb.max_seq == 524288 and tb.window == 64
    tokens, steps = _tokens(tb, 80, 3, seed=2)
    _run_both(jb, jparams, tb, model, tokens, steps, first_pos=pos)


def test_full_cache_decode_at_its_last_row_matches_jax():
    """granite SMOKE at max_seq 32768 (the ``decode_32k`` cache): a 16-token
    prefill padded to 32768 rows, then decode steps at 32766 and 32767, the
    last row."""
    jb, jparams, tb, model = _models("granite3_2b", max_seq=32768)
    tokens, steps = _tokens(tb, 16, 2, seed=3)
    caches = _run_both(jb, jparams, tb, model, tokens, steps, first_pos=32766)
    assert caches[0]["k"].shape[1] == 32768


# --------------------------------------------------------------------------- #
# prefill(S) == prefill(S - 16) + 16 decode steps, the port alone
# --------------------------------------------------------------------------- #

SELF_CASES = [
    # (arch, shape, max_seq, prompt S, batch, config changes)
    ("granite3_2b", None, 64, 64, B, {}),                       # the cache's last row
    ("h2o_danube3_4b", None, 128, 48, B, {"sliding_window": 16}),  # ring wrapped twice
    ("jamba_v01_52b", "long_500k", None, 4096 + 48, 1, {}),     # the 4096 ring, the scan
]


@pytest.mark.parametrize("case", SELF_CASES, ids=lambda c: c[0])
def test_prefill_equals_prefill_then_decode(case):
    """The last position's logits of a prefill of S tokens against a prefill
    of S - 16 tokens and 16 decode steps fed the same tokens: the same
    function, so within 1e-4 (the window equals the ring for danube and for
    jamba's ``long_500k`` 4096)."""
    arch, shape, max_seq, s, b, changes = case
    cfg = dataclasses.replace(importlib.import_module(f"repro_torch.configs.{arch}").SMOKE,
                              **changes)
    tb = tregistry.build(cfg, None if shape is None else tconfig.SHAPES[shape],
                         max_seq=max_seq, device="cpu")
    model = tb.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_tokens(tb, s, 0, seed=4, batch=b)[0]).long()
    with torch.inference_mode():
        whole, _, _ = tb.prefill(model, {"tokens": tokens})
        logits, caches, pos = tb.prefill(model, {"tokens": tokens[:, :s - 16]})
        for i in range(16):
            logits, caches = tb.decode_step(model, caches, tokens[:, s - 16 + i], pos + i)
    torch.testing.assert_close(logits, whole, **TOL)


# --------------------------------------------------------------------------- #
# the plain flash attention over slices of q rows
# --------------------------------------------------------------------------- #

SLICE_CASES = [
    # (b, sq, skv, hq, hkv, d, causal, window, max_bytes)
    (2, 100, 130, 4, 2, 16, True, None, 4 * 2 * 4 * 130 * 7),   # 7 rows a slice
    (1, 96, 96, 8, 2, 8, True, 24, 4 * 8 * 96),                 # one row a slice
    (2, 33, 65, 4, 4, 16, False, None, 1),                      # at least one row
    (1, 64, 64, 4, 1, 8, True, None, 1 << 30),                  # one slice
]


@pytest.mark.parametrize("case", SLICE_CASES, ids=lambda c: "-".join(map(str, c[:8])))
def test_row_sliced_plain_flash_matches_the_whole_call_and_jax(case):
    b, sq, skv, hq, hkv, d, causal, window, max_bytes = case
    rng = np.random.default_rng(5)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, skv, hkv, d)).astype(np.float32) for _ in range(2))
    q_pos = np.arange(sq, dtype=np.int32) + (skv - sq if causal else 0)
    kv_pos = np.arange(skv, dtype=np.int32)
    args = dict(causal=causal, window=window, q_pos=torch.from_numpy(q_pos),
                kv_pos=torch.from_numpy(kv_pos))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tflash.flash_attention_plain_rows(tq, tk, tv, max_bytes=max_bytes, **args)
    whole = tflash.flash_attention_plain(tq, tk, tv, **args)
    torch.testing.assert_close(got, whole, atol=1e-6, rtol=1e-6)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, window=window, q_pos=jnp.asarray(q_pos),
                                    kv_pos=jnp.asarray(kv_pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=3e-5)


# --------------------------------------------------------------------------- #
# the kernels' shape rules at the long shapes
# --------------------------------------------------------------------------- #

ATTENTION_ARCHS = [a for a in jconfig.ARCH_IDS   # every config with attention layers
                   if "A" in importlib.import_module(f"repro_torch.configs.{a}").CONFIG.layer_pattern]
LONG = [  # (name, batch, Sq, Skv, window or the config's)
    ("prefill_32k", 1, 32768, 32768, "config"),
    ("decode_32k", 8, 1, 32768, "config"),
    ("train_4k", 8, 4096, 4096, "config"),
    ("ring_4096", 1, 8192, 8192, 4096),
]


@pytest.mark.parametrize("shape", LONG, ids=lambda c: c[0])
@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_kernels_take_every_config_at_the_long_shapes(arch, shape):
    """Flash and decode's shape rules accept every config's heads at 32768
    and 4096 rows and on the 4096 ring; the decode kernel's split count
    leaves each split at least MIN_CHUNK rows and its block within the
    shared memory an SM gives."""
    cfg = importlib.import_module(f"repro_torch.configs.{arch}").CONFIG
    name, b, sq, skv, window = shape
    window = cfg.sliding_window if window == "config" else window
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    assert tflash.shape_error(b, sq, skv, hq, hkv, d, window) is None
    rows = min(window, skv) if window else skv       # a ring's rows, or the cache's
    assert tdecode.shape_error(b, rows, hq, hkv, d) is None
    splits = tdecode.decode_splits(b, rows, hkv)
    chunk = -(-rows // splits)
    assert 1 <= splits <= tdecode.MAX_SPLITS and -(-rows // chunk) == splits
    assert splits == 1 or chunk >= tdecode.MIN_CHUNK
    assert tdecode.split_smem_bytes(hq // hkv, d) <= tdecode.MAX_SHARED


@pytest.mark.parametrize("b,s,hkv,want", [
    (1, 32768, 8, (33, 993)),      # granite / danube / Jamba heads, decode_32k at B 1
    (8, 32768, 8, (5, 6554)),      # decode_32k at B 8: 320 blocks of 205 32-row tiles
    (1, 4096, 8, (33, 125)),       # the 4096 ring at B 1
    (1, 32768, 4, (66, 497)),      # starcoder2 / qwen3-moe's 4 kv heads
])
def test_decode_splits_at_the_long_caches(b, s, hkv, want):
    splits = tdecode.decode_splits(b, s, hkv)
    assert (splits, -(-s // splits)) == want


# --------------------------------------------------------------------------- #
# the card's bf16 row gate at the long shapes
# --------------------------------------------------------------------------- #

def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GATE_CASES = [
    # (kind, b, rows, hq, hkv, d, window): a kernel's output with its last key
    # tile dropped (flash: the last 64 keys, seen by the last 128 q rows
    # computed here; decode: the last 32 valid rows)
    ("flash", 1, 32768, 4, 1, 64, None),
    ("flash", 1, 8192, 4, 1, 120, 4096),
    ("decode", 1, 32768, 32, 8, 64, None),
    ("decode", 8, 4096, 32, 8, 120, None),
]


@pytest.mark.parametrize("case", GATE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_row_gate_refuses_a_dropped_key_tile_the_absolute_gate_passes(case):
    """bf16 outputs from unit-scale inputs over thousands of keys: the
    absolute gate (``_close`` at 5e-2) passes the output that lacks the last
    key tile, the row gate refuses it."""
    cs = _chip_smoke()
    kind, b, rows, hq, hkv, d, window = case
    g = torch.Generator().manual_seed(9)
    k, v = (torch.randn((b, rows, hkv, d), generator=g).bfloat16() for _ in range(2))
    if kind == "flash":
        q = torch.randn((b, 128, hq, d), generator=g).bfloat16()
        pos = torch.arange(rows, dtype=torch.int32)
        args = dict(causal=True, window=window, q_pos=pos[-128:])
        want = tflash.flash_attention_plain(q, k, v, kv_pos=pos, **args)
        bad = tflash.flash_attention_plain(q, k[:, :-64], v[:, :-64], kv_pos=pos[:-64], **args)
    else:
        q = torch.randn((b, hq, d), generator=g).bfloat16()
        mask = torch.ones((b, rows), dtype=torch.bool)
        want = tdecode.decode_attention_plain(q, k, v, mask)
        mask[:, -32:] = False
        bad = tdecode.decode_attention_plain(q, k, v, mask)
    assert cs._close(bad, want, cs.KERNEL_TOL["bfloat16"])[1]
    assert cs._row_err(bad, want) > cs.ROW_TOL
    assert cs._long_close(want, want, "bfloat16") == (0.0, 0.0, True)


def test_row_gate_takes_a_row_whose_exact_value_is_zero():
    """The first q row's dq is zero (one key: no gradient through its
    softmax); its rounding noise is held against a hundredth of the rows'
    root-mean-square norm, not against its own zero norm."""
    cs = _chip_smoke()
    want = torch.randn((64, 8, 64), generator=torch.Generator().manual_seed(3))
    want[0] = 0.0
    got = want + 1e-6
    assert cs._row_err(got, want) < 1e-3
    got[5] += 0.1
    assert cs._row_err(got, want) > cs.ROW_TOL
