"""The port's vision-language backbone (internvl2) against the JAX package's,
on the same weights.

The projected image embeddings are prepended to the text and the last
``n_img`` text tokens dropped, so the sequence keeps the tokens' length; a
decode step after the prefill teacher-forces from the text stream shifted by
``n_img`` (``tests/test_models.py``'s invariant).  Logits at 1e-4 (as
``tests/test_torch_models.py``), engine tokens equal; the reference runs its
CPU path (``attention_impl="reference"``).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.models import registry as jregistry
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.engine import SnapshotStore as JaxStore
from repro_torch.models import lm as tlm
from repro_torch.models import registry as tregistry
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import InferenceEngine, SnapshotStore

ARCH = "internvl2_1b"
TOL = dict(atol=1e-4, rtol=1e-4)
B, PROMPT, MAX_SEQ = 2, 16, 32


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(importlib.import_module(f"repro.configs.{ARCH}").SMOKE,
                               attention_impl="reference")
    tcfg = importlib.import_module(f"repro_torch.configs.{ARCH}").SMOKE
    jb = jregistry.build(jcfg, max_seq=MAX_SEQ)
    jparams = jb.init(jax.random.key(0))
    tb = tregistry.build(tcfg, max_seq=MAX_SEQ, device="cpu")
    model = tb.empty()
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)), assign=True)
    return jb, jparams, tb, model


def _inputs(cfg, seed, prompt):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, prompt)).astype(np.int32)
    img = rng.standard_normal((B, cfg.vision.num_image_tokens,
                               cfg.vision.d_embed)).astype(np.float32)
    return tokens, img


def test_projector_is_carried_across(models):
    jb, jparams, tb, model = models
    fresh = tb.init(torch.Generator().manual_seed(0)).state_dict()
    carried = params_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(carried) == set(fresh) and "proj" in fresh and "unembed" in fresh
    assert fresh["proj"].shape == (tb.cfg.vision.d_embed, tb.cfg.d_model)
    np.testing.assert_array_equal(model.proj.numpy(), np.asarray(jparams["proj"]))


@pytest.mark.parametrize("prompt", [PROMPT, 5])
def test_inputs_prepend_the_projected_image(models, prompt):
    """S stays the tokens' length where it is at least n_img; below that
    (5 < 8) both packages take Python's slice ``[: S - n_img]`` as it is."""
    jb, jparams, tb, model = models
    tokens, img = _inputs(tb.cfg, 0, prompt)
    want = jlm._inputs_to_x(jparams, jb.cfg, {"tokens": jnp.asarray(tokens),
                                               "image_embeds": jnp.asarray(img)})
    got = tlm._inputs_to_x(model, tb.cfg, {"tokens": torch.from_numpy(tokens),
                                           "image_embeds": torch.from_numpy(img)})
    assert got.shape == want.shape
    if prompt >= tb.cfg.vision.num_image_tokens:
        assert got.shape == (B, prompt, tb.cfg.d_model)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_and_decode_logits_match_jax(models, seed):
    """Prefill logits with image embeds, then 4 decode steps teacher-forced
    from the text stream shifted by n_img, against the reference's."""
    jb, jparams, tb, model = models
    n_img = tb.cfg.vision.num_image_tokens
    tokens, img = _inputs(tb.cfg, seed, PROMPT + 4)
    pre = tokens[:, :PROMPT]
    jlogits, jcaches, jpos = jax.jit(jb.prefill)(
        jparams, {"tokens": jnp.asarray(pre), "image_embeds": jnp.asarray(img)})
    with torch.inference_mode():
        tlogits, tcaches, tpos = tb.prefill(
            model, {"tokens": torch.from_numpy(pre), "image_embeds": torch.from_numpy(img)})
    assert tpos == int(jpos) == PROMPT
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    jstep = jax.jit(jb.decode_step)
    for i in range(PROMPT, PROMPT + 4):
        tok = tokens[:, i - n_img]
        jlogits, jcaches = jstep(jparams, jcaches, jnp.asarray(tok), jnp.asarray(i, jnp.int32))
        with torch.inference_mode():
            tlogits, tcaches = tb.decode_step(model, tcaches, torch.from_numpy(tok), i)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   err_msg=f"decode at {i}", **TOL)
    for layer, c in enumerate(tcaches):
        for kv in ("k", "v"):
            np.testing.assert_allclose(c[kv].numpy(), np.asarray(jcaches[0][kv][layer]),
                                       err_msg=f"layer {layer} {kv}", **TOL)


def test_decode_matches_the_full_forward(models):
    """Teacher-forced decode logits equal the full forward's at each
    position (the image prefix included in both)."""
    jb, jparams, tb, model = models
    n_img = tb.cfg.vision.num_image_tokens
    tokens, img = _inputs(tb.cfg, 2, MAX_SEQ)
    t_img = torch.from_numpy(img)
    with torch.inference_mode():
        full, _, _ = tlm.lm_forward(model, tb.cfg, {"tokens": torch.from_numpy(tokens),
                                                    "image_embeds": t_img})
        logits, caches, pos = tb.prefill(
            model, {"tokens": torch.from_numpy(tokens[:, :PROMPT]), "image_embeds": t_img})
        for i in range(PROMPT, MAX_SEQ):
            np.testing.assert_allclose(logits.numpy(), full[:, i - 1].numpy(), **TOL)
            tok = torch.from_numpy(tokens[:, i - n_img])
            logits, caches = tb.decode_step(model, caches, tok, i)
    want, _, _ = jlm.lm_forward(jparams, jb.cfg, {"tokens": jnp.asarray(tokens),
                                                  "image_embeds": jnp.asarray(img)})
    np.testing.assert_allclose(full.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------- #
# the engine with image_embeds
# --------------------------------------------------------------------------- #

ENGINE_ARCH, ENGINE_SEQ, STEPS = "internvl2-1b", 16, 4


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    root = tmp_path_factory.mktemp("internvl2")
    jeng = JaxEngine(ENGINE_ARCH, smoke=True, max_seq=ENGINE_SEQ, batch=1,
                     store=JaxStore(str(root / "jax")))
    jeng.cold_start()
    store = SnapshotStore(str(root / "torch"))
    teng = InferenceEngine(ENGINE_ARCH, smoke=True, max_seq=ENGINE_SEQ, batch=1,
                           store=store, device="cpu")
    store.save_params(teng.key, params_from_jax(jax.tree.map(np.asarray, jeng.params)))
    teng.cold_start(from_snapshot=True)
    return jeng, teng


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_tokens_equal_the_jax_engine(engines, seed):
    jeng, teng = engines
    cfg = teng.bundle.cfg
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (1, ENGINE_SEQ)).astype(np.int32)
    img = rng.standard_normal((1, cfg.vision.num_image_tokens,
                               cfg.vision.d_embed)).astype(np.float32)
    want, _ = jeng.serve(tokens, decode_steps=STEPS, extras={"image_embeds": img})
    got, _ = teng.serve(tokens, decode_steps=STEPS, extras={"image_embeds": img})
    np.testing.assert_array_equal(got, want)


def test_engine_refuses_missing_or_misshapen_image_embeds(engines):
    _, teng = engines
    tokens = np.zeros((1, ENGINE_SEQ), np.int32)
    with pytest.raises(ValueError, match=r"'image_embeds' of shape \(1, 8, 256\)"):
        teng.serve(tokens, decode_steps=1)
    with pytest.raises(ValueError, match="'image_embeds' must be"):
        teng.serve(tokens, decode_steps=1, extras={"image_embeds": np.zeros((1, 8, 255))})
    with pytest.raises(ValueError, match="frames"):
        teng.serve(tokens, decode_steps=1, extras={"frames": np.zeros((1, 32, 256))})
