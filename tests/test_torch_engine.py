"""The port's InferenceEngine against the JAX engine on the same weights.

Both serve granite-3-2b SMOKE at ``max_seq=16``.  The JAX engine initialises
its weights from its seed; the port's engine restores them from its own
``SnapshotStore``, written from ``params_from_jax``.  Greedy tokens must be
equal (the logits agree to ~1e-6 in fp32, far inside any argmax margin of
these random weights); the port runs on the CPU here (``device="cpu"``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lifecycle import STARTUP_PHASES
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.engine import SnapshotStore as JaxStore
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import InferenceEngine, SnapshotStore

ARCH, MAX_SEQ, STEPS = "granite-3-2b", 16, 6


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    root = tmp_path_factory.mktemp("engines")
    jeng = JaxEngine(ARCH, smoke=True, max_seq=MAX_SEQ, batch=1,
                     store=JaxStore(str(root / "jax")))
    jbd = jeng.cold_start()
    store = SnapshotStore(str(root / "torch"))
    teng = InferenceEngine(ARCH, smoke=True, max_seq=MAX_SEQ, batch=1,
                           store=store, device="cpu")
    store.save_params(teng.key, params_from_jax(jax.tree.map(np.asarray, jeng.params)))
    tbd = teng.cold_start(from_snapshot=True)
    return jeng, jbd, teng, tbd


def _prompt(seed):
    return np.random.default_rng(seed).integers(0, 512, (1, MAX_SEQ)).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_tokens_equal_the_jax_engine(engines, seed):
    jeng, _, teng, _ = engines
    want, _ = jeng.serve(_prompt(seed), decode_steps=STEPS)
    got, stats = teng.serve(_prompt(seed), decode_steps=STEPS)
    assert got.shape == (1, STEPS) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert stats.tokens == STEPS and stats.prefill_s > 0 and stats.decode_s > 0


def test_breakdown_has_the_jax_engine_phases(engines):
    _, jbd, _, tbd = engines
    want = {p.value for p in STARTUP_PHASES}
    assert {p.value for p in jbd.seconds} == want
    assert {p.value for p in tbd.seconds} == want
    assert all(s >= 0 for s in tbd.seconds.values())
    assert engines[2].key == engines[0].key


def test_shutdown_and_restore_give_the_same_tokens(engines):
    jeng, _, teng, _ = engines
    want, _ = jeng.serve(_prompt(3), decode_steps=STEPS)
    teng.shutdown()
    assert not teng.warm and teng.params is None
    with pytest.raises(RuntimeError, match="cold engine"):
        teng.serve(_prompt(3), decode_steps=STEPS)
    bd = teng.cold_start(from_snapshot=True)
    # the key was warmed in this process: the restore skips the warm-up
    assert teng.store.get_executable(teng.key) is not None
    assert bd.seconds.keys() == engines[3].seconds.keys()
    got, _ = teng.serve(_prompt(3), decode_steps=STEPS)
    np.testing.assert_array_equal(got, want)


def test_snapshot_roundtrip_keeps_weights_exactly(engines, tmp_path):
    _, _, teng, _ = engines
    store = SnapshotStore(str(tmp_path))
    state = teng.params.state_dict()
    assert store.save_params("k", state) > 0
    back = store.load_params("k", "cpu")
    assert back.keys() == state.keys()
    for name, t in state.items():
        assert torch.equal(back[name], t), name


def test_decode_past_max_seq_leaves_the_cache_unchanged(engines):
    """The JAX engine prefills max_seq tokens and decodes at pos >= max_seq:
    its one-hot cache write matches no slot, so the new key/value are
    dropped.  The port reproduces this (and never writes out of bounds)."""
    jeng, _, teng, _ = engines
    tokens = _prompt(4)
    jb, tb = jeng.bundle, teng.bundle
    jlogits, jcaches, pos = jb.prefill(jeng.params, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        tlogits, tcaches, tpos = tb.prefill(teng.params, {"tokens": torch.from_numpy(tokens)})
        assert tpos == int(pos) == MAX_SEQ
        tok = tlogits.argmax(-1)
        tlogits2, tcaches2 = tb.decode_step(teng.params, tcaches, tok, MAX_SEQ)
    jlogits2, jcaches2 = jb.decode_step(jeng.params, jcaches, jnp.asarray(tok.numpy(), jnp.int32),
                                        jnp.asarray(MAX_SEQ, jnp.int32))
    np.testing.assert_allclose(tlogits2.numpy(), np.asarray(jlogits2), atol=1e-4, rtol=1e-4)
    for layer, (before, after) in enumerate(zip(tcaches, tcaches2)):
        for kv in ("k", "v"):
            assert torch.equal(before[kv], after[kv]), (layer, kv)
            np.testing.assert_array_equal(np.asarray(jcaches2[0][kv][layer]),
                                          np.asarray(jcaches[0][kv][layer]))
            np.testing.assert_allclose(after[kv].numpy(), np.asarray(jcaches2[0][kv][layer]),
                                       atol=1e-4, rtol=1e-4)


def test_serve_takes_only_the_warmed_shape(engines):
    _, _, teng, _ = engines
    with pytest.raises(ValueError, match="tokens must be"):
        teng.serve(np.zeros((1, MAX_SEQ - 1), np.int32))
    with pytest.raises(ValueError, match="token ids"):
        teng.serve(np.full((1, MAX_SEQ), 512, np.int32))


def test_cold_start_from_the_seed_serves(tmp_path):
    e = InferenceEngine(ARCH, smoke=True, max_seq=MAX_SEQ, store=SnapshotStore(str(tmp_path)),
                        device="cpu")
    bd = e.cold_start()
    assert e.store.has_params(e.key) and e.package_bytes() > 0
    assert {p.value for p in bd.seconds} == {p.value for p in STARTUP_PHASES}
    out, _ = e.serve(_prompt(5), decode_steps=2)
    assert out.shape == (1, 2) and ((0 <= out) & (out < 512)).all()


def test_batch_two_greedy_tokens_equal_the_jax_engine(tmp_path):
    """An engine warmed for B 2 serves two different prompts in one request,
    each row's greedy tokens equal to the JAX engine's at B 2."""
    jeng = JaxEngine(ARCH, smoke=True, max_seq=MAX_SEQ, batch=2,
                     store=JaxStore(str(tmp_path / "jax")))
    jeng.cold_start()
    store = SnapshotStore(str(tmp_path / "torch"))
    teng = InferenceEngine(ARCH, smoke=True, max_seq=MAX_SEQ, batch=2, store=store,
                           device="cpu")
    store.save_params(teng.key, params_from_jax(jax.tree.map(np.asarray, jeng.params)))
    teng.cold_start(from_snapshot=True)
    prompts = np.concatenate([_prompt(6), _prompt(7)])
    want, _ = jeng.serve(prompts, decode_steps=STEPS)
    got, stats = teng.serve(prompts, decode_steps=STEPS)
    assert got.shape == (2, STEPS) and stats.tokens == STEPS
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got[0], got[1])
    with pytest.raises(ValueError, match="tokens must be"):
        teng.serve(_prompt(6), decode_steps=STEPS)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-1b"])
def test_batch_two_tokens_with_extras_equal_the_jax_engine(tmp_path, arch):
    """The encoder-decoder and vision engines warmed for B 2: two different
    prompts, each with its own frames or image embeds, in one request; each
    row's greedy tokens equal the JAX engine's at B 2 (whisper's decode
    steps past max_seq give 0 after the first token on both sides)."""
    jeng = JaxEngine(arch, smoke=True, max_seq=MAX_SEQ, batch=2,
                     store=JaxStore(str(tmp_path / "jax")))
    jeng.cold_start()
    store = SnapshotStore(str(tmp_path / "torch"))
    teng = InferenceEngine(arch, smoke=True, max_seq=MAX_SEQ, batch=2, store=store,
                           device="cpu")
    store.save_params(teng.key, params_from_jax(jax.tree.map(np.asarray, jeng.params)))
    teng.cold_start(from_snapshot=True)
    (key, (shape, _)), = ((k, v) for k, v in teng._prefill_batch_spec().items()
                          if k != "tokens")
    rng = np.random.default_rng(8)
    prompts = rng.integers(0, teng.bundle.cfg.vocab_size, (2, MAX_SEQ)).astype(np.int32)
    extras = {key: rng.standard_normal(shape).astype(np.float32)}
    want, _ = jeng.serve(prompts, decode_steps=STEPS, extras=extras)
    got, _ = teng.serve(prompts, decode_steps=STEPS, extras=extras)
    assert got.shape == (2, STEPS)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got[0], got[1])


# --------------------------------------------------------------------------- #
# jamba SMOKE: the hybrid family (attention + Mamba layers, MoE FFNs)
# --------------------------------------------------------------------------- #

HYBRID = "jamba-v0.1-52b"


@pytest.fixture(scope="module")
def hybrid_engines(tmp_path_factory):
    root = tmp_path_factory.mktemp("hybrid")
    jeng = JaxEngine(HYBRID, smoke=True, max_seq=MAX_SEQ, batch=1,
                     store=JaxStore(str(root / "jax")))
    jeng.cold_start()
    store = SnapshotStore(str(root / "torch"))
    teng = InferenceEngine(HYBRID, smoke=True, max_seq=MAX_SEQ, batch=1,
                           store=store, device="cpu")
    store.save_params(teng.key, params_from_jax(jax.tree.map(np.asarray, jeng.params)))
    teng.cold_start(from_snapshot=True)
    return jeng, teng


@pytest.mark.parametrize("seed", [0, 1])
def test_hybrid_greedy_tokens_equal_the_jax_engine(hybrid_engines, seed):
    jeng, teng = hybrid_engines
    want, _ = jeng.serve(_prompt(seed), decode_steps=STEPS)
    got, _ = teng.serve(_prompt(seed), decode_steps=STEPS)
    np.testing.assert_array_equal(got, want)


def test_hybrid_decode_past_max_seq_drops_attention_writes_and_advances_ssm(hybrid_engines):
    """Past max_seq the attention layer's cache is unchanged (as granite's),
    while the Mamba layer's conv inputs and state move on, as in JAX."""
    jeng, teng = hybrid_engines
    tokens = _prompt(6)
    jb, tb = jeng.bundle, teng.bundle
    _, jcaches, _ = jb.prefill(jeng.params, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        tlogits, tcaches, tpos = tb.prefill(teng.params, {"tokens": torch.from_numpy(tokens)})
        assert tpos == MAX_SEQ
        tok = tlogits.argmax(-1)
        tlogits2, tcaches2 = tb.decode_step(teng.params, tcaches, tok, MAX_SEQ)
    jlogits2, jcaches2 = jb.decode_step(jeng.params, jcaches, jnp.asarray(tok.numpy(), jnp.int32),
                                        jnp.asarray(MAX_SEQ, jnp.int32))
    np.testing.assert_allclose(tlogits2.numpy(), np.asarray(jlogits2), atol=1e-4, rtol=1e-4)
    kinds = teng.bundle.cfg.layer_pattern
    assert sorted(kinds) == ["A", "M"]
    for layer, kind in enumerate(kinds):
        before, after, want = tcaches[layer], tcaches2[layer], jcaches2[layer]
        for key in after:
            np.testing.assert_allclose(after[key].numpy(), np.asarray(want[key][0]),
                                       atol=1e-4, rtol=1e-4, err_msg=f"{kind} {key}")
            assert torch.equal(before[key], after[key]) == (kind == "A"), (kind, key)


# --------------------------------------------------------------------------- #
# fuse_chain: granite SMOKE -> h2o-danube-3 SMOKE, the reference test's pair
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def chain_engines(tmp_path_factory):
    root = tmp_path_factory.mktemp("chain")
    pairs = []
    for arch in ("granite-3-2b", "h2o-danube-3-4b"):
        jeng = JaxEngine(arch, smoke=True, max_seq=MAX_SEQ, batch=1,
                         store=JaxStore(str(root / "jax")))
        jeng.cold_start()
        store = SnapshotStore(str(root / "torch"))
        teng = InferenceEngine(arch, smoke=True, max_seq=MAX_SEQ, batch=1, store=store,
                               device="cpu")
        store.save_params(teng.key, params_from_jax(jax.tree.map(np.asarray, jeng.params)))
        teng.cold_start(from_snapshot=True)
        pairs.append((jeng, teng))
    return [j for j, _ in pairs], [t for _, t in pairs]


@pytest.mark.parametrize("steps", [2, 5])
def test_fuse_chain_tokens_equal_the_reference(chain_engines, steps):
    """The chain (tokens % vocab, prefill, greedy steps at S + i, the last S
    tokens kept, stage after stage) gives the reference ``fuse_chain``'s
    tokens; danube's ring cache takes the decode writes at pos % 16."""
    from repro.serving.engine import fuse_chain as jfuse
    from repro_torch.serving.engine import fuse_chain

    jengines, tengines = chain_engines
    jfn, jcompile_s = jfuse(jengines, decode_steps=steps)
    fn, compile_s = fuse_chain(tengines, decode_steps=steps)
    assert compile_s > 0 and jcompile_s > 0
    for seed in range(2):
        tokens = np.random.default_rng(seed).integers(0, 1000, (1, MAX_SEQ)).astype(np.int32)
        want = np.asarray(jfn({"tokens": jnp.asarray(tokens)}))
        got = fn({"tokens": tokens})
        assert got.dtype == torch.int32 and tuple(got.shape) == (1, MAX_SEQ)
        np.testing.assert_array_equal(got.numpy(), want)


def test_fuse_chain_equals_the_stages_one_after_another(chain_engines):
    """The chain equals each stage run through ``engine.serve`` in turn."""
    from repro_torch.serving.engine import fuse_chain

    _, tengines = chain_engines
    fn, _ = fuse_chain(tengines, decode_steps=3)
    tokens = np.random.default_rng(9).integers(0, 1000, (1, MAX_SEQ)).astype(np.int32)
    want = tokens
    for eng in tengines:
        want = want % eng.bundle.cfg.vocab_size
        gen, _ = eng.serve(want, decode_steps=3)
        want = np.concatenate([want, gen], axis=1)[:, -MAX_SEQ:]
    np.testing.assert_array_equal(fn({"tokens": tokens}).numpy(), want)
    with pytest.raises(ValueError, match="tokens must be"):
        fn({"tokens": tokens[:, 1:]})
