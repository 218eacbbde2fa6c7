"""The port's decoder-only LM against the JAX package's, on the same weights.

JAX initialises the SMOKE config from ``jax.random.key(0)``; the tree is
carried across as numpy arrays by ``repro_torch.models.convert.
params_from_jax``.  Prefill logits and four decode steps are compared at
1e-4 abs/rel in fp32: both sides compute the same fp32 arithmetic and differ
only in summation order (XLA's and torch's matmuls, the chunked online softmax
against the plain one), which moves 2-layer logits by ~1e-6, while a layout
or rounding-order fault (a transposed weight, swapped SwiGLU halves, a wrong
RoPE split, a misrolled ring) moves them by 1e-2 or more.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.core import lifecycle as jlifecycle
from repro.models import lm as jlm
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro_torch import config as tconfig
from repro_torch.core import lifecycle as tlifecycle
from repro_torch.models import lm as tlm
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import params_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)
B = 2

CASES = [
    # (arch, prompt, max_seq, jax attention_impl)
    ("granite3_2b", 16, 32, "reference"),
    ("granite3_2b", 16, 32, "pallas"),
    ("h2o_danube3_4b", 96, 128, "reference"),   # window 64: the ring roll runs
    ("qwen25_14b", 16, 32, "reference"),        # QKV bias, rope_theta 1e6
    ("starcoder2_15b", 16, 32, "reference"),    # LayerNorm, GELU, rope_theta 1e5
    ("jamba_v01_52b", 16, 32, "reference"),     # Mamba + attention, MoE every 2nd
    ("jamba_v01_52b", 16, 32, "pallas"),        # the Pallas scan, interpreted
    ("qwen3_moe_30b_a3b", 16, 32, "reference"),  # MoE on every layer, no dense FFN
    ("arctic_480b", 16, 32, "reference"),       # MoE with a dense residual
]


def _configs(arch):
    jmod = importlib.import_module(f"repro.configs.{arch}")
    tmod = importlib.import_module(f"repro_torch.configs.{arch}")
    return jmod, tmod


def _models(arch, max_seq, impl, **changes):
    """The JAX bundle and its weights, and the port's bundle with those
    weights; ``changes`` replace fields of both SMOKE configs."""
    jmod, tmod = _configs(arch)
    jcfg = dataclasses.replace(jmod.SMOKE, attention_impl=impl, **changes)
    jb = jregistry.build(jcfg, max_seq=max_seq)
    jparams = jb.init(jax.random.key(0))
    tb = tregistry.build(dataclasses.replace(tmod.SMOKE, **changes), max_seq=max_seq,
                         device="cpu")
    model = tb.empty()
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)),
                          assign=True)
    return jb, jparams, tb, model


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[3]}")
def test_prefill_and_decode_logits_match_jax(case):
    _prefill_and_decode_match(*case)


def test_qwen3_moe_with_query_width_past_d_model_matches_jax():
    """qwen3-moe's real heads are 32 x 128 = 4096 query features on a 2048
    model width; SMOKE's head_dim is d_model / heads.  Twice that here makes
    wq (256, 512) and wo (512, 256): every reshape by d_model would break."""
    cfg = _configs("qwen3_moe_30b_a3b")[1].SMOKE
    hd = 2 * cfg.d_model // cfg.num_heads
    model = _prefill_and_decode_match("qwen3_moe_30b_a3b", 16, 32, "reference", head_dim=hd)
    attn = model.blocks[0].attn
    assert attn.wq.shape == (cfg.d_model, cfg.num_heads * hd) == attn.wo.shape[::-1]
    assert cfg.num_heads * hd != cfg.d_model


def _prefill_and_decode_match(arch, prompt, max_seq, impl, **changes):
    """Prefill and 4 decode steps of the port against the JAX package at B 2,
    logits and caches; the carried weights' names and shapes are the port's
    own.  Returns the port's model."""
    jb, jparams, tb, model = _models(arch, max_seq, impl, **changes)
    fresh = tb.empty().state_dict()
    assert {k: (v.shape, v.dtype) for k, v in model.state_dict().items()} == \
        {k: (v.shape, v.dtype) for k, v in fresh.items()}
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tb.cfg.vocab_size, (B, prompt)).astype(np.int32)
    steps = rng.integers(0, tb.cfg.vocab_size, (4, B)).astype(np.int32)

    jlogits, jcaches, jpos = jax.jit(jb.prefill)(jparams, {"tokens": jnp.asarray(tokens)})
    tlogits, tcaches, tpos = tb.prefill(model, {"tokens": torch.from_numpy(tokens)})
    assert tpos == int(jpos) == prompt
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)

    jstep = jax.jit(jb.decode_step)
    for i, tok in enumerate(steps):
        jlogits, jcaches = jstep(jparams, jcaches, jnp.asarray(tok),
                                 jnp.asarray(prompt + i, jnp.int32))
        tlogits, tcaches = tb.decode_step(model, tcaches, torch.from_numpy(tok),
                                          prompt + i)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   err_msg=f"{arch} decode step {i}", **TOL)
    # the caches agree too (ring slots, Mamba conv inputs and states included):
    # layer l is JAX's period position l % period, repeat l // period
    per = ttransformer.period_len(tb.cfg)
    for layer, c in enumerate(tcaches):
        want = jcaches[layer % per]
        assert set(c) == set(want)
        for key, t in c.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(want[key][layer // per]),
                                       err_msg=f"{arch} layer {layer} {key}", **TOL)
    return model


@pytest.mark.parametrize("arch", ["granite3_2b", "h2o_danube3_4b", "jamba_v01_52b",
                                  "qwen25_14b", "starcoder2_15b", "qwen3_moe_30b_a3b",
                                  "arctic_480b"])
def test_full_forward_logits_match_jax(arch):
    jb, jparams, tb, model = _models(arch, 128, "reference")
    tokens = np.random.default_rng(1).integers(0, tb.cfg.vocab_size, (B, 80)).astype(np.int32)
    jlogits, jaux, _ = jlm.lm_forward(jparams, jb.cfg, {"tokens": jnp.asarray(tokens)},
                                      window=jb.window)
    tlogits, taux, _ = tlm.lm_forward(model, tb.cfg, {"tokens": torch.from_numpy(tokens)},
                                      window=tb.window)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)   # MoE aux loss (0 without)


def test_state_dict_names_match_the_port_model():
    jb, jparams, tb, model = _models("qwen25_14b", 32, "reference")
    carried = params_from_jax(jax.tree.map(np.asarray, jparams))
    fresh = tb.init(torch.Generator().manual_seed(0)).state_dict()
    assert set(carried) == set(fresh)
    for name, t in fresh.items():
        assert carried[name].shape == t.shape and carried[name].dtype == t.dtype, name


@pytest.mark.parametrize("arch", ["jamba_v01_52b", "qwen3_moe_30b_a3b", "arctic_480b"])
def test_hybrid_and_moe_state_dict_names_match(arch):
    """params_from_jax flattens the nested ``ssm.*`` and ``moe.dense.*`` leaves
    into the port's names, with the fp32 leaves (router, dt_w, A_log, ...) kept."""
    jb, jparams, tb, model = _models(arch, 32, "reference")
    carried = params_from_jax(jax.tree.map(np.asarray, jparams))
    fresh = tb.init(torch.Generator().manual_seed(0)).state_dict()
    assert set(carried) == set(fresh)
    for name, t in fresh.items():
        assert carried[name].shape == t.shape and carried[name].dtype == t.dtype, name
    kinds = {name.split(".")[2] for name in fresh if name.startswith("blocks.")}
    assert {"jamba_v01_52b": {"norm1", "attn", "ssm", "norm2", "ffn", "moe"},
            "qwen3_moe_30b_a3b": {"norm1", "attn", "norm2", "moe"},
            "arctic_480b": {"norm1", "attn", "norm2", "moe"}}[arch] == kinds
    if arch == "arctic_480b":
        assert "blocks.0.moe.dense.wi" in fresh


@pytest.mark.parametrize("arch", jconfig.ARCH_IDS)
def test_config_copies_equal_the_reference(arch):
    jmod, tmod = _configs(arch)
    for attr in ("CONFIG", "SMOKE"):
        assert dataclasses.asdict(getattr(tmod, attr)) == \
            dataclasses.asdict(getattr(jmod, attr)), f"{arch}.{attr}"
    assert tconfig.get_config(arch).param_count() == jconfig.get_config(arch).param_count()


def test_lifecycle_copy_equals_the_reference():
    assert [p.value for p in tlifecycle.STARTUP_PHASES] == \
        [p.value for p in jlifecycle.STARTUP_PHASES]
    assert [t.value for t in tlifecycle.WarmthTier] == [t.value for t in jlifecycle.WarmthTier]


@pytest.mark.parametrize("arch", ["whisper_large_v3", "internvl2_1b"])
def test_unported_families_raise_not_implemented(arch):
    """The two families that raised ``NotImplementedError`` (A5) until the
    encoder-decoder and vision slice now build, init and prefill on the CPU
    (their parity: tests/test_torch_encdec.py, tests/test_torch_vision.py)."""
    tb = tregistry.build_arch(arch, smoke=True, max_seq=16, device="cpu")
    model = tb.init(torch.Generator().manual_seed(0))
    cfg = tb.cfg
    batch = {"tokens": torch.zeros((1, 16), dtype=torch.int64)}
    if cfg.encoder is not None:
        batch["frames"] = torch.zeros((1, cfg.encoder.num_frames, cfg.encoder.d_model))
    if cfg.vision is not None:
        batch["image_embeds"] = torch.zeros((1, cfg.vision.num_image_tokens,
                                             cfg.vision.d_embed))
    with torch.inference_mode():
        logits, caches, pos = tb.prefill(model, batch)
        logits, _ = tb.decode_step(model, caches, logits.argmax(-1), pos - 1)
    assert pos == 16 and logits.shape == (1, cfg.vocab_size)
    assert torch.isfinite(logits).all()


def test_granite_full_width_parameter_count():
    """2.53 B parameters at full width (counted on the meta device: no memory).
    ``param_count`` leaves out the final norm's d_model scales."""
    tb = tregistry.build_arch("granite-3-2b", max_seq=512, device="cpu")
    n = sum(t.numel() for t in tb.empty().state_dict().values())
    assert n == tb.cfg.param_count() + tb.cfg.d_model
    assert 2.5e9 < n < 2.6e9


@pytest.mark.parametrize("arch,max_seq", [("granite3_2b", 32), ("h2o_danube3_4b", 128),
                                          ("jamba_v01_52b", 32)])
def test_decode_cache_layout_matches_jax(arch, max_seq):
    """One zero cache per layer, ring-sized (window 64) for SWA configs; a
    Mamba layer's is its conv inputs (cfg.dtype) and its fp32 state."""
    jmod, tmod = _configs(arch)
    window = tregistry.resolve_window(tmod.SMOKE, None)
    jc = jtransformer.init_decode_caches(jmod.SMOKE, B, max_seq, window=window)
    tc = ttransformer.init_decode_caches(tmod.SMOKE, B, max_seq, window=window,
                                         device="cpu")
    assert len(tc) == tmod.SMOKE.num_layers
    per = ttransformer.period_len(tmod.SMOKE)
    for layer, c in enumerate(tc):
        kind = tmod.SMOKE.layer_pattern[layer]
        assert set(c) == ({"k", "v"} if kind == "A" else {"conv", "h"})
        for key, t in c.items():
            want = np.asarray(jc[layer % per][key][layer // per])
            assert t.shape == want.shape and not t.any()
            assert str(t.dtype).split(".")[1] == str(want.dtype), (layer, key)


def test_attention_head_keywords_match_jax():
    """``init_cache`` and ``decode_attention`` take the reference's
    ``num_heads`` / ``num_kv_heads``, which override the config's counts
    (granite SMOKE has 4 / 1 heads; 8 / 2 here)."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn

    jcfg, tcfg = (m.SMOKE for m in _configs("granite3_2b"))
    h, hkv, hd = 8, 2, tcfg.head_dim
    jc = jattn.init_cache(jcfg, 1, 16, num_kv_heads=2)
    tc = tattn.init_cache(tcfg, 1, 16, num_kv_heads=2, device="cpu")
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape == (1, 16, 2, hd)
        assert str(tc[key].dtype).split(".")[1] == str(jc[key].dtype) and not tc[key].any()
    jp = jattn.init_attention(jax.random.key(3), jcfg, num_heads=h, num_kv_heads=hkv)
    tp = tattn.Attention(tcfg, num_heads=h, num_kv_heads=hkv, device="cpu")
    tp.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()},
                       assign=True)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, tcfg.d_model)).astype(np.float32)
    kv = {key: rng.standard_normal((B, 16, hkv, hd)).astype(np.float32)
          for key in ("k", "v")}
    pos = 9
    jy, jcache = jattn.decode_attention(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in kv.items()},
        jnp.asarray(pos, jnp.int32), jcfg, impl="reference", num_heads=h, num_kv_heads=hkv)
    ty, tcache = tattn.decode_attention(
        tp, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in kv.items()}, pos,
        tcfg, num_heads=h, num_kv_heads=hkv)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL)
