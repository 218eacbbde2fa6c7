"""The port's encoder-decoder (whisper) against the JAX package's, on the
same weights, and the port's KV-cache accounting against the reference's.

JAX initialises the SMOKE config from ``jax.random.key(0)``; the tree (its
``enc_blocks`` / ``dec_blocks`` stacked over layers) is carried across by
``params_from_jax``.  The reference runs its CPU path
(``attention_impl="reference"``: the jnp flash attention); the port runs its
kernels' plain versions.  Tolerances: attention layers 3e-5 (the kernels'
fp32 tolerance, ``tests/test_kernels.py``), 2-layer logits 1e-4 (as
``tests/test_torch_models.py``), engine tokens equal.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.models import attention as jattention
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro.serving import kvcache as jkvcache
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.engine import SnapshotStore as JaxStore
from repro_torch.models import attention as tattention
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.models import registry as tregistry
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.serving import kvcache as tkvcache
from repro_torch.serving.engine import InferenceEngine, SnapshotStore

ARCH = "whisper_large_v3"
TOL = dict(atol=1e-4, rtol=1e-4)
ATTN_TOL = dict(atol=3e-5, rtol=3e-5)
B, PROMPT, MAX_SEQ = 2, 12, 24


def _cfgs():
    jcfg = importlib.import_module(f"repro.configs.{ARCH}").SMOKE
    tcfg = importlib.import_module(f"repro_torch.configs.{ARCH}").SMOKE
    return dataclasses.replace(jcfg, attention_impl="reference"), tcfg


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jb = jregistry.build(jcfg, max_seq=MAX_SEQ)
    jparams = jb.init(jax.random.key(0))
    tb = tregistry.build(tcfg, max_seq=MAX_SEQ, device="cpu")
    model = tb.empty()
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)), assign=True)
    return jb, jparams, tb, model


def _inputs(cfg, seed, prompt=PROMPT):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, prompt)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.encoder.num_frames,
                                  cfg.encoder.d_model)).astype(np.float32)
    return tokens, frames


@pytest.mark.parametrize("length,d_model", [(32, 256), (1500, 1280), (7, 2), (5, 3)])
def test_sinusoid_embed_is_bit_equal_in_fp32(length, d_model):
    want = np.asarray(jlayers.sinusoid_embed(length, d_model, jnp.float32))
    got = tlayers.sinusoid_embed(length, d_model, torch.float32).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_state_dict_names_match_the_port_model(models):
    """The stacked ``enc_blocks`` / ``dec_blocks`` dicts become one entry a
    layer (no q/k/v bias anywhere: whisper has none, a cross layer never),
    and ``params_to_jax`` stacks them back."""
    jb, jparams, tb, model = models
    carried = params_from_jax(jax.tree.map(np.asarray, jparams))
    fresh = tb.init(torch.Generator().manual_seed(0)).state_dict()
    assert set(carried) == set(fresh)
    for name, t in fresh.items():
        assert carried[name].shape == t.shape and carried[name].dtype == t.dtype, name
    assert {"dec_blocks.1.self.wq", "dec_blocks.1.cross.wo", "enc_blocks.1.attn.wk",
            "pos", "enc_norm.bias"} <= set(fresh)
    back = params_to_jax(carried, period=1)
    flat_j = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jparams))[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), back))[0])
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_t[path], leaf, err_msg=str(path))


def test_cross_attention_layer_matches_jax():
    """``kv_x`` (prefill) and ``cross_kv`` (decode) at Sq != Skv, with a
    ``qkv_bias`` config: the cross layer has no biases in either package."""
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, qkv_bias=True)
    tcfg = dataclasses.replace(tcfg, qkv_bias=True)
    jp = jattention.init_attention(jax.random.key(3), jcfg, cross=True)
    assert set(jp) == {"wq", "wk", "wv", "wo"}
    tp = tattention.Attention(tcfg, cross=True, device="meta")
    tp.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)), assign=True)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 10, tcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, 33, tcfg.d_model)).astype(np.float32)
    q_pos = np.arange(10)
    want, (wk, wv) = jattention.full_attention(
        jp, jnp.asarray(x), jcfg, q_pos=jnp.asarray(q_pos), kv_x=jnp.asarray(enc),
        causal=False, use_rope=False, return_kv=True)
    got, (gk, gv) = tattention.full_attention(
        tp, torch.from_numpy(x), tcfg, q_pos=torch.from_numpy(q_pos), kv_x=torch.from_numpy(enc),
        causal=False, use_rope=False, return_kv=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **ATTN_TOL)
    np.testing.assert_allclose(gk.detach().numpy(), np.asarray(wk), **ATTN_TOL)
    cache = {"k": torch.zeros(1)}
    want_d, _ = jattention.decode_attention(jp, jnp.asarray(x[:, 0]), None, 40, jcfg,
                                            cross_kv=(wk, wv), use_rope=False)
    got_d, same = tattention.decode_attention(tp, torch.from_numpy(x[:, 0]), cache, 40, tcfg,
                                              cross_kv=(gk, gv), use_rope=False)
    assert same is cache
    np.testing.assert_allclose(got_d.detach().numpy(), np.asarray(want_d), **ATTN_TOL)


def test_encoder_output_matches_jax(models):
    jb, jparams, tb, model = models
    _, frames = _inputs(tb.cfg, 0)
    want = jencdec.encode(jparams, jb.cfg, jnp.asarray(frames))
    with torch.inference_mode():
        got = tencdec.encode(model, tb.cfg, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_and_decode_logits_match_jax(models, seed):
    """Prefill logits, the caches (self padded to max_seq, cross as computed)
    and 4 teacher-forced decode steps, against the reference's."""
    jb, jparams, tb, model = models
    tokens, frames = _inputs(tb.cfg, seed)
    steps = np.random.default_rng(seed + 10).integers(0, tb.cfg.vocab_size, (4, B))
    jlogits, jcaches, jpos = jax.jit(jb.prefill)(
        jparams, {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)})
    with torch.inference_mode():
        tlogits, tcaches, tpos = tb.prefill(
            model, {"tokens": torch.from_numpy(tokens), "frames": torch.from_numpy(frames)})
    assert tpos == int(jpos) == PROMPT
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    jstep = jax.jit(jb.decode_step)
    for i, tok in enumerate(steps.astype(np.int32)):
        jlogits, jcaches = jstep(jparams, jcaches, jnp.asarray(tok),
                                 jnp.asarray(PROMPT + i, jnp.int32))
        with torch.inference_mode():
            tlogits, tcaches = tb.decode_step(model, tcaches, torch.from_numpy(tok), PROMPT + i)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   err_msg=f"decode step {i}", **TOL)
    for kind in ("self", "cross"):
        assert len(tcaches[kind]) == tb.cfg.num_layers
        for layer, c in enumerate(tcaches[kind]):
            for kv in ("k", "v"):
                want = np.asarray(jcaches[kind][kv][layer])
                assert c[kv].shape == want.shape, (kind, layer, kv)
                np.testing.assert_allclose(c[kv].numpy(), want, err_msg=f"{kind} {layer} {kv}",
                                           **TOL)


def test_decode_matches_the_full_forward(models):
    """The reference's cache invariant (``tests/test_models.py``): teacher-
    forced decode logits equal the full decoder's at each position."""
    jb, jparams, tb, model = models
    tokens, frames = _inputs(tb.cfg, 2, prompt=MAX_SEQ)
    t_tok = torch.from_numpy(tokens)
    with torch.inference_mode():
        enc = tencdec.encode(model, tb.cfg, torch.from_numpy(frames))
        full, _, _ = tencdec._dec_full(model, tb.cfg, t_tok, enc)
        logits, caches, pos = tb.prefill(model, {"tokens": t_tok[:, :PROMPT],
                                                 "frames": torch.from_numpy(frames)})
        for i in range(PROMPT, MAX_SEQ):
            np.testing.assert_allclose(logits.numpy(), full[:, i - 1].numpy(), **TOL)
            logits, caches = tb.decode_step(model, caches, t_tok[:, i], i)
    want, _, _ = jencdec._dec_full(jparams, jb.cfg, jnp.asarray(tokens),
                                   jencdec.encode(jparams, jb.cfg, jnp.asarray(frames)))
    np.testing.assert_allclose(full.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pos", [MAX_SEQ, MAX_SEQ + 5, torch.tensor(MAX_SEQ + 1)])
def test_decode_past_the_position_table_gives_nan_without_raising(models, pos):
    """``jnp.take`` fills a row past the learned positions with NaN; the
    port's masked gather does the same and never indexes out of bounds."""
    jb, jparams, tb, model = models
    tokens, frames = _inputs(tb.cfg, 3)
    tok = tokens[:, 0]
    with torch.inference_mode():
        _, caches, _ = tb.prefill(model, {"tokens": torch.from_numpy(tokens),
                                          "frames": torch.from_numpy(frames)})
        logits, after = tb.decode_step(model, caches, torch.from_numpy(tok), pos)
    assert torch.isnan(logits).all()
    assert (logits.argmax(-1) == 0).all()
    for before, now in zip(caches["self"], after["self"]):   # the write is dropped
        assert torch.equal(before["k"], now["k"]) and torch.equal(before["v"], now["v"])
    _, jcaches, _ = jb.prefill(jparams, {"tokens": jnp.asarray(tokens),
                                         "frames": jnp.asarray(frames)})
    jlogits, _ = jb.decode_step(jparams, jcaches, jnp.asarray(tok), jnp.asarray(int(pos)))
    assert np.isnan(np.asarray(jlogits)).all()


# --------------------------------------------------------------------------- #
# the engine with frames
# --------------------------------------------------------------------------- #

ENGINE_ARCH, ENGINE_SEQ, STEPS = "whisper-large-v3", 16, 4


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    root = tmp_path_factory.mktemp("whisper")
    jeng = JaxEngine(ENGINE_ARCH, smoke=True, max_seq=ENGINE_SEQ, batch=1,
                     store=JaxStore(str(root / "jax")))
    jeng.cold_start()
    store = SnapshotStore(str(root / "torch"))
    teng = InferenceEngine(ENGINE_ARCH, smoke=True, max_seq=ENGINE_SEQ, batch=1,
                           store=store, device="cpu")
    store.save_params(teng.key, params_from_jax(jax.tree.map(np.asarray, jeng.params)))
    teng.cold_start(from_snapshot=True)
    return jeng, teng


def _request(seed, cfg):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (1, ENGINE_SEQ)).astype(np.int32)
    frames = rng.standard_normal((1, cfg.encoder.num_frames,
                                  cfg.encoder.d_model)).astype(np.float32)
    return tokens, frames


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_tokens_equal_the_jax_engine(engines, seed):
    """Both engines prefill max_seq tokens and decode past the position
    table: the first token, then zeros (argmax of NaN logits)."""
    jeng, teng = engines
    tokens, frames = _request(seed, teng.bundle.cfg)
    want, _ = jeng.serve(tokens, decode_steps=STEPS, extras={"frames": frames})
    got, _ = teng.serve(tokens, decode_steps=STEPS, extras={"frames": frames})
    np.testing.assert_array_equal(got, want)
    assert (got[0, 1:] == 0).all()


def test_engine_refuses_missing_or_misshapen_frames(engines):
    _, teng = engines
    tokens, frames = _request(5, teng.bundle.cfg)
    with pytest.raises(ValueError, match=r"'frames' of shape \(1, 32, 256\)"):
        teng.serve(tokens, decode_steps=1)
    with pytest.raises(ValueError, match="'frames' must be"):
        teng.serve(tokens, decode_steps=1, extras={"frames": frames[:, :-1]})
    with pytest.raises(ValueError, match="image_embeds"):
        teng.serve(tokens, decode_steps=1,
                   extras={"frames": frames, "image_embeds": np.zeros((1, 8, 256))})


# --------------------------------------------------------------------------- #
# KV-cache accounting
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", jconfig.ARCH_IDS)
@pytest.mark.parametrize("smoke", [False, True])
def test_cache_bytes_equal_the_reference(arch, smoke):
    jcfg = importlib.import_module(f"repro.configs.{arch}")
    tcfg = importlib.import_module(f"repro_torch.configs.{arch}")
    jc, tc = (m.SMOKE if smoke else m.CONFIG for m in (jcfg, tcfg))
    for batch, seq in ((1, 448), (4, 4096), (1, 500_000)):
        assert tkvcache.cache_bytes(tc, batch, seq) == jkvcache.cache_bytes(jc, batch, seq)
    assert tkvcache.param_bytes(tc) == jkvcache.param_bytes(jc)


def _tree_bytes(tree) -> int:
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(_tree_bytes(t) for t in items)


@pytest.mark.parametrize("arch", jconfig.ARCH_IDS)
def test_cache_bytes_equal_the_port_prefill_caches(arch):
    """The accounting counts what the port's prefill really returns: KV
    caches (ring-sized for SWA), recurrent states, whisper's cross caches."""
    cfg = importlib.import_module(f"repro_torch.configs.{arch}").SMOKE
    max_seq = 32
    tb = tregistry.build(cfg, max_seq=max_seq, device="cpu")
    model = tb.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((1, max_seq), dtype=torch.int64)}
    if cfg.encoder is not None:
        batch["frames"] = torch.zeros((1, cfg.encoder.num_frames, cfg.encoder.d_model))
    with torch.inference_mode():
        _, caches, _ = tb.prefill(model, batch)
    assert _tree_bytes(caches) == tkvcache.cache_bytes(cfg, 1, max_seq)
