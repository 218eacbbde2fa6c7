"""The port's xLSTM blocks (mLSTM ``L``, sLSTM ``S``) against the JAX package's.

The mixers run on weights and inputs drawn from seeded numpy in fp32 and set
on both sides under the JAX tree's names.  Both walk time one step at a time
in fp32 (``lax.scan`` there, a Python loop here) and differ only in matmul
summation order, so outputs and every state leaf are held at 5e-5 abs/rel, the
scan's tolerance in ``tests/test_torch_ssm.py``; a wrong gate, a missed
stabiliser or a transposed recurrent weight moves them by 1e-2 or more.  The
SMOKE LM (``xlstm-125m``: one mLSTM and one sLSTM layer) is held at 1e-4 from
the JAX package's own init (``convert.params_from_jax``), as
``tests/test_torch_models.py`` does, and the engines' greedy tokens must be
equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import xlstm_125m as jxl
from repro.models import lm as jlm
from repro.models import registry as jregistry
from repro.models import xlstm as jxlstm
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.engine import SnapshotStore as JaxStore
from repro_torch.configs import xlstm_125m as txl
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttransformer
from repro_torch.models import xlstm as txlstm
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import InferenceEngine, SnapshotStore

TOL = dict(atol=5e-5, rtol=5e-5)
LM_TOL = dict(atol=1e-4, rtol=1e-4)
B = 2
CFG, TCFG = jxl.SMOKE, txl.SMOKE
MIXERS = {"mlstm": txlstm.MLSTM, "slstm": txlstm.SLSTM}


def _numpy_weights(kind, seed):
    """Seeded numpy weights for one mixer, under the port's (= JAX's) names,
    at the shapes and dtypes of the port's module."""
    rng = np.random.default_rng(seed)
    shapes = MIXERS[kind](TCFG, device="meta").state_dict()
    out = {}
    for name, t in shapes.items():
        shape = tuple(t.shape)
        fan_in = shape[-2] if len(shape) > 1 else 1
        out[name] = (rng.normal(size=shape) * fan_in ** -0.5).astype(np.float32)
    return out


def _to_jax_tree(flat):
    tree = {}
    for name, a in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(a)
    return tree


def _pair(kind, seed=0):
    w = _numpy_weights(kind, seed)
    layer = MIXERS[kind](TCFG, device="meta")
    layer.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in w.items()},
                          assign=True)
    return _to_jax_tree(w), layer


def _state(kind, seed):
    """A carried state: every leaf drawn, positive normalisers for sLSTM."""
    rng = np.random.default_rng(seed)
    init = (txlstm.init_mlstm_state if kind == "mlstm" else txlstm.init_slstm_state)(
        TCFG, B, device="cpu")
    st = {k: rng.normal(size=tuple(t.shape)).astype(np.float32) for k, t in init.items()}
    if kind == "slstm":
        st["n"] = np.abs(st["n"]) + 0.5
    return st


def _compare_state(got, want, what):
    assert set(got) == set(want), what
    for key, t in got.items():
        assert t.dtype == torch.float32, (what, key)
        assert tuple(t.shape) == tuple(np.shape(want[key])), (what, key)
        np.testing.assert_allclose(t.numpy(), np.asarray(want[key]),
                                   err_msg=f"{what} {key}", **TOL)


@pytest.mark.parametrize("carried", [False, True], ids=["zero_state", "carried_state"])
@pytest.mark.parametrize("t", [16, 64])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_forward_matches_jax(kind, t, carried):
    jp, layer = _pair(kind)
    x = np.random.default_rng(1).normal(size=(B, t, CFG.d_model)).astype(np.float32)
    st = _state(kind, 2) if carried else None
    jfwd = jxlstm.mlstm_forward if kind == "mlstm" else jxlstm.slstm_forward
    tfwd = txlstm.mlstm_forward if kind == "mlstm" else txlstm.slstm_forward
    jy, jstate = jfwd(jp, jnp.asarray(x), CFG,
                      state=None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    with torch.inference_mode():
        ty, tstate = tfwd(layer, torch.from_numpy(x), TCFG,
                          state=None if st is None else
                          {k: torch.from_numpy(v) for k, v in st.items()})
    assert ty.shape == (B, t, TCFG.d_model)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _compare_state(tstate, jstate, f"{kind} T={t}")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_step_matches_jax(kind):
    jp, layer = _pair(kind, seed=3)
    x = np.random.default_rng(4).normal(size=(B, CFG.d_model)).astype(np.float32)
    st = _state(kind, 5)
    jstep = jxlstm.mlstm_step if kind == "mlstm" else jxlstm.slstm_step
    tstep = txlstm.mlstm_step if kind == "mlstm" else txlstm.slstm_step
    jy, jstate = jstep(jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()}, CFG)
    with torch.inference_mode():
        ty, tstate = tstep(layer, torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in st.items()}, TCFG)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _compare_state(tstate, jstate, f"{kind} step")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_initial_state_matches_jax(kind):
    """fp32 leaves, m at -1e30, sLSTM's n at 1e-6, sLSTM leaves (B, d_in)."""
    jinit = jxlstm.init_mlstm_state if kind == "mlstm" else jxlstm.init_slstm_state
    tinit = txlstm.init_mlstm_state if kind == "mlstm" else txlstm.init_slstm_state
    _compare_state(tinit(TCFG, 3, device="cpu"), jinit(CFG, 3), f"{kind} init")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_parameters_carry_over_by_name(kind):
    """The port's names, shapes and dtypes are the JAX init's (fp32 gates,
    sLSTM's nested ``gi/gf/gz/go.{wx,wh,b}``), and the deterministic leaves
    (biases, ``skip``) take the reference's values."""
    jinit = jxlstm.init_mlstm if kind == "mlstm" else jxlstm.init_slstm
    jp = jinit(jax.random.key(0), jxl.CONFIG)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        flat[".".join(p.key for p in path)] = leaf
    fresh = MIXERS[kind](txl.CONFIG, device="meta").state_dict()
    assert set(fresh) == set(flat)
    for name, t in fresh.items():
        assert tuple(t.shape) == flat[name].shape, name
        assert str(t.dtype).split(".")[1] == str(flat[name].dtype), name
    small = MIXERS[kind](TCFG, device="cpu", gen=torch.Generator().manual_seed(0))
    jsmall = jinit(jax.random.key(0), CFG)
    if kind == "mlstm":
        for name in ("b_i", "b_f", "skip"):
            np.testing.assert_array_equal(getattr(small, name).numpy(), np.asarray(jsmall[name]))
    else:
        for gate in ("gi", "gf", "gz", "go"):
            np.testing.assert_array_equal(getattr(small, gate).b.numpy(),
                                          np.asarray(jsmall[gate]["b"]))


# --------------------------------------------------------------------------- #
# the SMOKE LM and the engine
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def smoke_models():
    jb = jregistry.build(CFG, max_seq=32)
    jparams = jb.init(jax.random.key(0))
    tb = tregistry.build(TCFG, max_seq=32, device="cpu")
    model = tb.empty()
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)), assign=True)
    return jb, jparams, tb, model


def test_smoke_state_dict_names_match(smoke_models):
    """``blocks.<i>.xl.{up,wq,...}`` and ``blocks.<i>.xl.{gi,...}.{wx,wh,b}``
    from the stacked JAX tree; no norm2 or FFN (d_ff = 0)."""
    jb, jparams, tb, _ = smoke_models
    carried = params_from_jax(jax.tree.map(np.asarray, jparams))
    fresh = tb.init(torch.Generator().manual_seed(0)).state_dict()
    assert set(carried) == set(fresh)
    for name, t in fresh.items():
        assert carried[name].shape == t.shape and carried[name].dtype == t.dtype, name
    assert "blocks.0.xl.wq" in fresh and "blocks.1.xl.gf.wh" in fresh
    assert not any(".norm2." in n or ".ffn." in n for n in fresh)


def test_smoke_prefill_and_decode_logits_match_jax(smoke_models):
    jb, jparams, tb, model = smoke_models
    rng = np.random.default_rng(0)
    prompt = 16
    tokens = rng.integers(0, CFG.vocab_size, (B, prompt)).astype(np.int32)
    steps = rng.integers(0, CFG.vocab_size, (4, B)).astype(np.int32)
    jlogits, jcaches, _ = jax.jit(jb.prefill)(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        tlogits, tcaches, tpos = tb.prefill(model, {"tokens": torch.from_numpy(tokens)})
    assert tpos == prompt
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **LM_TOL)
    jstep = jax.jit(jb.decode_step)
    for i, tok in enumerate(steps):
        jlogits, jcaches = jstep(jparams, jcaches, jnp.asarray(tok),
                                 jnp.asarray(prompt + i, jnp.int32))
        with torch.inference_mode():
            tlogits, tcaches = tb.decode_step(model, tcaches, torch.from_numpy(tok),
                                              prompt + i)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   err_msg=f"decode step {i}", **LM_TOL)
    # the recurrent states after the decode steps: the JAX caches carry the
    # n_rep axis first (layer l is period position l % 2, repeat l // 2)
    per = ttransformer.period_len(TCFG)
    for layer, c in enumerate(tcaches):
        want = jcaches[layer % per]
        assert set(c) == set(want)
        for key, t in c.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(want[key][layer // per]),
                                       err_msg=f"layer {layer} {key}", **LM_TOL)


def test_smoke_full_forward_matches_jax(smoke_models):
    jb, jparams, tb, model = smoke_models
    from repro_torch.models import lm as tlm
    tokens = np.random.default_rng(1).integers(0, CFG.vocab_size, (B, 24)).astype(np.int32)
    jlogits, _, _ = jlm.lm_forward(jparams, CFG, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        tlogits, _, _ = tlm.lm_forward(model, TCFG, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **LM_TOL)


def test_decode_state_layout_matches_jax():
    jc = jxlstm.init_mlstm_state(CFG, B), jxlstm.init_slstm_state(CFG, B)
    tc = ttransformer.init_decode_caches(TCFG, B, 32, device="cpu")
    assert len(tc) == TCFG.num_layers == 2
    _compare_state(tc[0], jc[0], "layer 0 (L)")
    _compare_state(tc[1], jc[1], "layer 1 (S)")


def test_engine_greedy_tokens_equal_the_jax_engine(tmp_path):
    max_seq, steps = 16, 6
    jeng = JaxEngine("xlstm-125m", smoke=True, max_seq=max_seq, batch=1,
                     store=JaxStore(str(tmp_path / "jax")))
    jeng.cold_start()
    store = SnapshotStore(str(tmp_path / "torch"))
    teng = InferenceEngine("xlstm-125m", smoke=True, max_seq=max_seq, batch=1,
                           store=store, device="cpu")
    store.save_params(teng.key, params_from_jax(jax.tree.map(np.asarray, jeng.params)))
    teng.cold_start(from_snapshot=True)
    for seed in range(2):
        prompt = np.random.default_rng(seed).integers(0, 512, (1, max_seq)).astype(np.int32)
        want, _ = jeng.serve(prompt, decode_steps=steps)
        got, stats = teng.serve(prompt, decode_steps=steps)
        assert got.shape == (1, steps) and stats.tokens == steps
        np.testing.assert_array_equal(got, want)


def test_full_width_parameter_count():
    """On the meta device: the JAX init's leaf count at full width (233.11 M).

    ``ModelConfig.param_count`` counts the xLSTM gates as blocked per head
    and leaves out q/k/v and the fp32 input-gate weights, so it gives 148.06 M
    for this config on both sides; the model itself is the reference's."""
    tb = tregistry.build_arch("xlstm-125m", max_seq=512, device="cpu")
    n = sum(t.numel() for t in tb.empty().state_dict().values())
    shapes = jax.eval_shape(lambda k: jlm.init_lm(k, jxl.CONFIG, max_seq=512),
                            jax.random.key(0))
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) == 233_110_320
    assert tb.cfg.param_count() == jxl.CONFIG.param_count() == 148_055_040
