"""The port's training slice against the JAX package's, on the CPU.

Weights travel from JAX (``jax.random.key(0)`` inits) as numpy through
``convert.params_from_jax``; batches come from the port's
``data.pipeline``, which is held bit-equal to the reference's first.
Tolerances: the loss within 1e-5 and every gradient leaf within 1e-4
(abs and rel) of ``jax.value_and_grad(bundle.loss)``: both sides are fp32
arithmetic summed in another order (XLA's matmuls and chunked online
softmax against torch's), which moves a SMOKE model's gradients by ~1e-7,
while a wrong mask, a dropped term (z-loss, aux, the image-label shift) or
a missing path through a kernel moves them by 1e-3 or more.  Three AdamW
steps keep the losses within 1e-5 and the parameters within 1e-4 with
``eps`` 1e-3 on both sides: at the default 1e-8, Adam's first step divides
a gradient by its own magnitude, so the odd element whose gradient is near
zero (one in 131072 of a SMOKE FFN weight) turns a 1e-8 difference in
summation order into a tenth of a step (2e-4), on either side alike.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.data import pipeline as jpipeline
from repro.learn import dataset as jdataset
from repro.learn import forecaster as rfc
from repro.models import registry as jregistry
from repro.training import optimizer as jopt
from repro.training import train_loop as jtrain
from repro_torch import config as tconfig
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import train as tlaunch
from repro_torch.learn import dataset as tdataset
from repro_torch.learn import forecaster as tfc
from repro_torch.models import registry as tregistry
from repro_torch.models.convert import params_from_jax
from repro_torch.training import checkpoint
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as ttrain

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
ADAM_EPS = 1e-3
B, S = 2, 32


def _configs(arch):
    return (importlib.import_module(f"repro.configs.{arch}").SMOKE,
            importlib.import_module(f"repro_torch.configs.{arch}").SMOKE)


def _bundles(arch, max_seq=S):
    jcfg, tcfg = _configs(arch)
    jb = jregistry.build(jcfg, max_seq=max_seq)
    jparams = jb.init(jax.random.key(0))
    tb = tregistry.build(tcfg, max_seq=max_seq, device="cpu")
    model = tb.empty()
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)), assign=True)
    return jb, jparams, tb, model


def _batches(tcfg, n, seed=0):
    it = tpipeline.batches(tcfg, tconfig.InputShape("t", S, B, "train"), seed=seed)
    return [next(it) for _ in range(n)]


def _grads_by_name(jgrads):
    return params_from_jax(jax.tree.map(lambda g: np.asarray(g, np.float32), jgrads))


@pytest.mark.parametrize("arch", ["granite3_2b", "whisper_large_v3", "internvl2_1b"])
def test_batches_bit_equal_the_reference(arch):
    jcfg, tcfg = _configs(arch)
    for seed in (0, 3):
        shape = (jconfig.InputShape("t", S, B, "train"), tconfig.InputShape("t", S, B, "train"))
        jit, tit = jpipeline.batches(jcfg, shape[0], seed=seed), \
            tpipeline.batches(tcfg, shape[1], seed=seed)
        for _ in range(2):
            want, got = next(jit), next(tit)
            assert sorted(got) == sorted(want)
            for key in want:
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])
    want = jpipeline.prompt_batch(jcfg, batch=2, seq_len=16, seed=1)
    got = tpipeline.prompt_batch(tcfg, batch=2, seq_len=16, seed=1)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("arch", [
    "granite3_2b", "qwen3_moe_30b_a3b", "internvl2_1b", "whisper_large_v3",
    # every other family trains on the CPU too: Mamba + MoE (the plain scan),
    # xLSTM, a sliding window, MoE with a dense residual, QKV biases
    "jamba_v01_52b", "xlstm_125m", "h2o_danube3_4b", "arctic_480b", "qwen25_14b"])
def test_loss_and_every_gradient_match_jax(arch):
    jb, jparams, tb, model = _bundles(arch)
    batch = _batches(tb.cfg, 1)[0]
    (jloss, jmetrics), jgrads = jax.value_and_grad(jb.loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = ttrain.value_and_grad(tb, model, ttrain.to_device(batch, tb.device))
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    for key in ("loss", "aux", "zloss", "tokens"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), err_msg=key,
                                   **LOSS_TOL)
    if tb.cfg.moe is not None:
        assert float(metrics["aux"]) > 0
    if tb.cfg.vision is not None:      # the image positions carry no label
        assert float(metrics["tokens"]) == B * (S - tb.cfg.vision.num_image_tokens)
    want = _grads_by_name(jgrads)
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)
    # every parameter gets a gradient: the attention projections through the
    # flash backward above all
    for name in (n for n in grads if ".wq" in n or ".wk" in n or ".wv" in n):
        assert grads[name].abs().max() > 0, name
    assert all(not p.requires_grad for p in model.parameters())


def test_an_unreached_leaf_gets_jax_zero_gradient():
    """A vision config on a text-only batch: the projector is not used, and
    its gradient is the zero JAX gives it."""
    jb, jparams, tb, model = _bundles("internvl2_1b")
    batch = {k: v for k, v in _batches(tb.cfg, 1)[0].items() if k != "image_embeds"}
    _, jgrads = jax.value_and_grad(jb.loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, grads = ttrain.value_and_grad(tb, model, ttrain.to_device(batch, tb.device))
    assert torch.equal(grads["proj"], torch.zeros_like(model.proj))
    want = _grads_by_name(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("arch", ["granite3_2b", "whisper_large_v3", "internvl2_1b",
                                  "xlstm_125m"])
def test_three_train_steps_match_jax(arch):
    jb, jparams, tb, model = _bundles(arch)
    opt_cfg = dict(lr=3e-3, warmup_steps=1, total_steps=3, eps=ADAM_EPS)
    jstep = jax.jit(jtrain.make_train_step(jb, jopt.OptimizerConfig(**opt_cfg)))
    tstep = ttrain.make_train_step(tb, topt.OptimizerConfig(**opt_cfg))
    jstate = jopt.init_opt_state(jparams)
    tstate = topt.init_opt_state(ttrain.param_tree(model))
    for batch in _batches(tb.cfg, 3, seed=1):
        jparams, jstate, jm = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        model, tstate, tm = tstep(model, tstate, ttrain.to_device(batch, tb.device))
        for key in ("loss", "total_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), err_msg=key, **LOSS_TOL)
    assert int(tstate.step) == 3
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), err_msg=name, **PARAM_TOL)


@pytest.mark.parametrize("arch", ["granite3_2b", "whisper_large_v3"])
def test_remat_gives_the_same_loss_and_gradients(arch):
    """Activation checkpointing (``cfg.remat`` under ``train``: each period of
    the LM, each layer of the encoder-decoder) recomputes the forward in the
    backward; the numbers are the same bit for bit."""
    _, _, tb, model = _bundles(arch)
    batch = ttrain.to_device(_batches(tb.cfg, 1)[0], tb.device)
    remat = tregistry.build(dataclasses.replace(tb.cfg, remat=True), max_seq=S, device="cpu")
    assert not tb.cfg.remat
    loss, _, grads = ttrain.value_and_grad(tb, model, batch)
    loss_r, _, grads_r = ttrain.value_and_grad(remat, model, batch)
    assert torch.equal(loss, loss_r)
    for name, g in grads.items():
        assert torch.equal(g, grads_r[name]), name


def _forecaster_batches(feat, n, batch=32):
    traces = tdataset.training_traces(mix=tdataset.TRAIN_MIX[:2])
    examples = tdataset.build_examples(traces, feat)
    return list(tdataset.batches(examples, batch, steps=n))


def test_forecaster_train_steps_match_jax():
    cfg, feat = rfc.model_config(), rfc.FeatureConfig()
    tcfg, tfeat = tfc.model_config(), tfc.FeatureConfig()
    jb, tb = rfc.make_bundle(cfg, feat), tfc.make_bundle(tcfg, tfeat, device="cpu")
    jparams = jb.init(jax.random.key(0))
    model = tfc.forecaster_from_state(params_from_jax(jax.tree.map(np.asarray, jparams)),
                                      tcfg, tfeat, device="cpu")
    opt_cfg = dict(lr=3e-3, warmup_steps=2, total_steps=4, weight_decay=0.01, eps=ADAM_EPS)
    jstep = jax.jit(jtrain.make_train_step(jb, jopt.OptimizerConfig(**opt_cfg)))
    tstep = ttrain.make_train_step(tb, topt.OptimizerConfig(**opt_cfg))
    jstate = jopt.init_opt_state(jparams)
    tstate = topt.init_opt_state(ttrain.param_tree(model))
    for batch in _forecaster_batches(tfeat, 4):
        jparams, jstate, jm = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        model, tstate, tm = tstep(model, tstate, ttrain.to_device(batch, tb.device))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS_TOL)
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), err_msg=name, **PARAM_TOL)


def test_train_forecaster_learns_like_the_reference():
    """Both trainers from their own seed-0 weights (JAX's and torch's draws
    differ): the same schedule, and the pinball loss falls in each."""
    feat = tfc.FeatureConfig()
    data = _forecaster_batches(feat, 40)
    params, res, cfg, _ = tfc.train_forecaster(iter(data), steps=40, log_every=0,
                                               log_fn=None, device="cpu")
    _, jres, _, _ = rfc.train_forecaster(iter(data), steps=40, log_every=0, log_fn=None)
    assert isinstance(params, tfc.Forecaster) and res.steps == jres.steps == 40
    assert np.isfinite(res.losses).all()
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5])
    assert np.mean(jres.losses[-5:]) < np.mean(jres.losses[:5])
    x = torch.from_numpy(data[0]["x"])
    with torch.no_grad():
        q = tfc.apply_forecaster(params, x, cfg)
    assert (q[:, 1:] >= q[:, :-1]).all()


def test_training_learns():
    """``tests/test_training.py::test_training_learns`` on the port."""
    cfg = tconfig.reduced(tconfig.get_config("granite-3-2b"), d_model=128)
    bundle = tregistry.build(cfg, max_seq=64, device="cpu")
    it = tpipeline.batches(cfg, tconfig.InputShape("t", 64, 4, "train"))
    res = ttrain.train(bundle, it, steps=25,
                       opt_cfg=topt.OptimizerConfig(lr=1e-2, warmup_steps=5, total_steps=25),
                       log_every=0, log_fn=lambda s: None)
    assert res.losses[-1] < res.losses[0] - 1.0
    assert res.tokens_per_s > 0
    assert all(not p.requires_grad for p in res.final_params.parameters())


def test_launcher_trains_and_checkpoints(tmp_path, capsys):
    path = str(tmp_path / "model.npz")
    res = tlaunch.main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
                        "--steps", "3", "--batch", "2", "--seq", "32", "--checkpoint", path])
    out = capsys.readouterr().out
    assert "done: loss" in out and f"checkpoint: {path}" in out
    state, extra = checkpoint.restore(path)
    assert extra == {"arch": "granite-3-2b", "steps": 3}
    for name, p in res.final_params.state_dict().items():
        np.testing.assert_array_equal(state[name], p.numpy())


def test_launcher_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "granite-3-2b", "--smoke", "--steps", "1"])


def test_bf16_checkpoint_round_trip(tmp_path):
    bundle = tregistry.build(dataclasses.replace(_configs("granite3_2b")[1],
                                                 param_dtype="bfloat16", dtype="bfloat16"),
                             max_seq=16, device="cpu")
    model = bundle.init(torch.Generator().manual_seed(1))
    path = str(tmp_path / "bf16.npz")
    checkpoint.save(path, model.state_dict())
    state, _ = checkpoint.restore(path)
    for name, p in model.state_dict().items():
        assert state[name].dtype == torch.bfloat16 and torch.equal(state[name], p)


def test_train_checkpoint_serve_loop(tmp_path):
    """``tests/test_system.py::test_train_checkpoint_serve_loop`` on the port:
    train, checkpoint, and serve the checkpoint through the engine's
    ``SnapshotStore`` as its cold-start image."""
    from repro_torch.serving.engine import InferenceEngine, SnapshotStore, generate

    cfg = _configs("granite3_2b")[1]
    bundle = tregistry.build(cfg, max_seq=32, device="cpu")
    it = tpipeline.batches(cfg, tconfig.InputShape("t", 32, 2, "train"))
    res = ttrain.train(bundle, it, steps=8, log_every=0, log_fn=lambda s: None,
                       opt_cfg=topt.OptimizerConfig(lr=5e-3, warmup_steps=2, total_steps=8))
    ck = str(tmp_path / "model.npz")
    checkpoint.save(ck, res.final_params.state_dict())

    store = SnapshotStore(str(tmp_path / "snaps"))
    e = InferenceEngine("granite-3-2b", smoke=True, max_seq=32, batch=1, store=store,
                        device="cpu")
    trained, _ = checkpoint.restore(ck)
    store.save_params(e.key, {k: torch.from_numpy(v) for k, v in trained.items()})
    loaded = store.load_params(e.key, "cpu")
    assert all(np.array_equal(loaded[k].numpy(), trained[k]) for k in trained)
    e.cold_start(from_snapshot=True)
    for name, p in e.params.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), trained[name])
    tokens = np.ones((1, 32), np.int32)
    out, stats = e.serve(tokens, decode_steps=4)
    assert out.shape == (1, 4) and stats.decode_s > 0
    want, _ = generate(bundle, res.final_params, tokens, decode_steps=4)
    np.testing.assert_array_equal(out, want)


def test_launcher_checkpoint_serves_at_batch_two(tmp_path, capsys):
    """The launcher trains SMOKE whisper and writes ``--checkpoint``; an
    engine warmed for B 2, restored from that file through its
    ``SnapshotStore``, serves the tokens ``generate`` gives on the trained
    parameters read straight from the checkpoint."""
    from repro_torch.serving.engine import InferenceEngine, SnapshotStore, generate

    arch, seq = "whisper-large-v3", 32
    path = str(tmp_path / "model.npz")
    tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
                  "--batch", "2", "--seq", str(seq), "--checkpoint", path])
    assert f"checkpoint: {path}" in capsys.readouterr().out
    trained, _ = checkpoint.restore(path)
    store = SnapshotStore(str(tmp_path / "snaps"))
    eng = InferenceEngine(arch, smoke=True, max_seq=seq, batch=2, store=store, device="cpu")
    store.save_params(eng.key, {k: torch.from_numpy(v) for k, v in trained.items()})
    eng.cold_start(from_snapshot=True)
    for name, p in eng.params.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), trained[name])
    bundle = tregistry.build_arch(arch, smoke=True, max_seq=seq, device="cpu")
    model = bundle.empty()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in trained.items()}, assign=True)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, bundle.cfg.vocab_size, (2, seq)).astype(np.int32)
    frames = rng.standard_normal((2, bundle.cfg.encoder.num_frames,
                                  bundle.cfg.encoder.d_model)).astype(np.float32)
    out, _ = eng.serve(tokens, decode_steps=4, extras={"frames": frames})
    want, _ = generate(bundle, model, tokens, decode_steps=4, extras={"frames": frames})
    assert out.shape == (2, 4)
    np.testing.assert_array_equal(out, want)
