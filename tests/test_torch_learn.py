"""The port's learned keep-alive stack (``repro_torch.learn``,
``repro_torch.training``) against the JAX package's, on the CPU.

The same numpy inputs and converted weights go through both packages; the
reference runs as its own tests run it here.  Tolerances: the optimizer
and the TD update within 1e-6 / 1e-5 (fp32 arithmetic in another order);
the cluster step's extras and the gym at the cluster step's own
``rtol=1e-4, atol=1e-2`` (``tests/test_batchsim.py``), rewards within
rtol 1e-4.  The committed ``checkpoints/forecaster.npz`` is never loaded
through the reference's ``load_forecaster``: its pickled treedef names a
jaxlib module that jax 0.9 no longer has.
"""
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.learn import agent as ragent
from repro.learn import forecaster as rfc
from repro.learn.gym import BatchSimGym as RGym
from repro.learn.gym import training_scenarios as r_scenarios
from repro.training import optimizer as ropt
from repro_torch.kernels import cluster_step as tcluster
from repro_torch.learn import agent as tagent
from repro_torch.learn import forecaster as tfc
from repro_torch.learn.gym import BatchSimGym as TGym
from repro_torch.learn.gym import training_scenarios as t_scenarios
from repro_torch.models import convert
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import optimizer as topt

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "checkpoints" / "forecaster.npz"
SCHEDULE = ROOT / "checkpoints" / "keepalive_schedule.json"
TOL = dict(rtol=1e-4, atol=1e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The gym's plain loop steps small tensors thousands of times: intra-op
    threads add only their wake-up to each op."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _leaf_paths(tree, prefix=""):
    """Dotted paths of a tree of dicts and lists, dict keys sorted."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [p for i, x in enumerate(tree) for p in _leaf_paths(x, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    return convert.nest(convert.params_from_jax(_np_tree(tree)))


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #
OPT_CONFIGS = {
    "warmup_decay": ropt.OptimizerConfig(lr=3e-2, warmup_steps=2, total_steps=6,
                                         weight_decay=0.1, clip_norm=0.5),
    "dqn": ropt.OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=40,
                                weight_decay=0.0),
    # bf16 parameters and gradients, every step's grad norm above clip_norm:
    # the reference's clip gives fp32 gradients (g * scale promotes)
    "bf16_clipped": ropt.OptimizerConfig(lr=3e-2, warmup_steps=2, total_steps=6,
                                         weight_decay=0.1, clip_norm=0.5),
}
OPT_DTYPES = {"bf16_clipped": "bfloat16"}


def _opt_tree(rng):
    tree = {"a": {"w": rng.normal(size=(4, 3)), "b": rng.normal(size=(3,))},
            "z": rng.normal(size=(2, 2, 2))}
    return jax.tree.map(lambda a: a.astype(np.float32), tree)


def _within_one_bf16_ulp(got, want, msg):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(want), np.float32(2.0 ** -126))
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert (np.abs(got - want) <= ulp).all(), msg


@pytest.mark.parametrize("name", list(OPT_CONFIGS))
def test_adamw_matches_reference(name):
    rcfg = OPT_CONFIGS[name]
    tcfg = topt.OptimizerConfig(**{f: getattr(rcfg, f) for f in rcfg.__dataclass_fields__})
    dtype = OPT_DTYPES.get(name, "float32")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(0)
    tree = _opt_tree(rng)
    rp = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)
    tp = topt.tree_map(lambda a: torch.from_numpy(a).to(tdt), tree)
    rs, ts = ropt.init_opt_state(rp), topt.init_opt_state(tp)
    for step in range(5):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * (step + 1)).astype(np.float32),
                         tree)
        rp, rs, rinfo = ropt.apply_updates(rcfg, rp, jax.tree.map(
            lambda a: jnp.asarray(a, jdt), g), rs)
        tp, ts, tinfo = topt.apply_updates(tcfg, tp, topt.tree_map(
            lambda a: torch.from_numpy(a).to(tdt), g), ts)
        np.testing.assert_allclose(float(tinfo["lr"]), float(rinfo["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(tinfo["grad_norm"]), float(rinfo["grad_norm"]),
                                   rtol=1e-6)
        if dtype == "bfloat16":
            assert float(rinfo["grad_norm"]) > rcfg.clip_norm
    assert int(ts.step) == int(rs.step) == 5
    for which, r, t in (("params", rp, tp), ("m", rs.m, ts.m), ("v", rs.v, ts.v)):
        for rl, tl in zip(jax.tree.leaves(r), topt.tree_leaves(t)):
            assert tl.dtype == (tdt if which == "params" else torch.float32), which
            if which == "params" and dtype == "bfloat16":
                _within_one_bf16_ulp(tl.float().numpy(), rl, which)
                continue
            np.testing.assert_allclose(tl.float().numpy(), np.asarray(rl, np.float32),
                                       rtol=1e-6, atol=1e-6, err_msg=which)


def test_clip_gives_fp32_gradients_like_the_reference():
    g = {"w": np.full((3,), 1.1, np.float32)}
    rg, _ = ropt.clip_by_global_norm(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g),
                                     1.0)
    tg, _ = topt.clip_by_global_norm({"w": torch.from_numpy(g["w"]).bfloat16()}, 1.0)
    assert rg["w"].dtype == jnp.float32 and tg["w"].dtype == torch.float32
    np.testing.assert_array_equal(tg["w"].numpy(), np.asarray(rg["w"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_in_place_update_is_bit_equal_and_in_place(dtype, monkeypatch):
    """apply_updates_ against apply_updates over three steps, one leaf
    larger than a slice (the slice cut to 7 elements), weight decay on the
    2+-dim leaves; every leaf of params, m and v stays where it was."""
    monkeypatch.setattr(topt, "SLICE", 7)
    tdt = getattr(torch, dtype)
    cfg = topt.OptimizerConfig(lr=3e-2, warmup_steps=2, total_steps=6, clip_norm=0.5)
    rng = np.random.default_rng(5)
    tree = {"a": {"w": rng.normal(size=(5, 6)), "b": rng.normal(size=(3,))},
            "z": rng.normal(size=(2, 2, 2))}
    ref = topt.tree_map(lambda a: torch.from_numpy(a.astype(np.float32)).to(tdt), tree)
    live = topt.tree_map(lambda t: t.clone(), ref)
    rs, ls = topt.init_opt_state(ref), topt.init_opt_state(live)
    ptrs = [t.data_ptr() for t in topt.tree_leaves(live) + topt.tree_leaves(ls.m)
            + topt.tree_leaves(ls.v)]
    for step in range(3):
        g = topt.tree_map(lambda a: torch.from_numpy(
            (rng.normal(size=a.shape) * (step + 1)).astype(np.float32)).to(tdt), tree)
        ref, rs, rinfo = topt.apply_updates(cfg, ref, g, rs)
        out, ls, linfo = topt.apply_updates_(cfg, live, g, ls)
        assert out is live
        assert torch.equal(rinfo["grad_norm"], linfo["grad_norm"])
        assert torch.equal(rinfo["lr"], linfo["lr"])
    assert int(ls.step) == int(rs.step) == 3
    for r, t in ((ref, live), (rs.m, ls.m), (rs.v, ls.v)):
        for a, b in zip(topt.tree_leaves(r), topt.tree_leaves(t)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert ptrs == [t.data_ptr() for t in topt.tree_leaves(live) + topt.tree_leaves(ls.m)
                    + topt.tree_leaves(ls.v)]


def test_dqn_update_leaves_the_target_network_unchanged():
    """The agent aliases its target network to the params it updates: the
    functional update must leave that tree as it was."""
    cfg = tagent.DQNConfig()
    opt_cfg = topt.OptimizerConfig(lr=cfg.lr, warmup_steps=0, total_steps=10,
                                   weight_decay=0.0)
    params = tagent.init_qnet(torch.Generator().manual_seed(0), cfg, device="cpu")
    target = params
    before = [t.clone() for t in topt.tree_leaves(target)]
    rng = np.random.default_rng(6)
    n = 32
    batch = (torch.from_numpy(rng.normal(size=(n, tagent.OBS_DIM)).astype(np.float32)),
             torch.from_numpy(rng.integers(0, cfg.n_actions, n).astype(np.int32)),
             torch.from_numpy(rng.normal(size=n).astype(np.float32)),
             torch.from_numpy(rng.normal(size=(n, tagent.OBS_DIM)).astype(np.float32)),
             torch.zeros(n))
    update = tagent._td_update_fn(cfg, opt_cfg)
    new, _, _ = update(params, target, topt.init_opt_state(params), batch)
    for t, b in zip(topt.tree_leaves(target), before):
        assert torch.equal(t, b)
    assert any(not torch.equal(a, b) for a, b in zip(topt.tree_leaves(new), before))


# --------------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------------- #
def test_committed_forecaster_checkpoint_reads_without_jax():
    leaves, extra = tckpt.read_reference(str(CKPT))
    with np.load(CKPT, allow_pickle=False) as z:
        raw = [z[f"a{i}"] for i in range(len(z.files) - 1)]
    assert len(leaves) == len(raw) == 14
    for a, b in zip(leaves, raw):
        assert np.array_equal(a, b)
    assert extra["version"] == 1
    assert extra["model"] == {"num_layers": 2, "d_model": 32, "num_heads": 4, "d_ff": 64}
    assert extra["features"]["window"] == 16
    # the leaf order the port rebuilds the tree in is JAX's own flatten order
    cfg = rfc.model_config(**extra["model"])
    feat = rfc.FeatureConfig.from_dict(extra["features"])
    flat, _ = jax.tree_util.tree_flatten_with_path(
        rfc.init_forecaster(jax.random.key(0), cfg, feat))
    want = [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in flat]
    tcfg = tfc.model_config(**extra["model"])
    like = convert.params_to_jax(
        tfc.Forecaster(tcfg, feat, device="meta").state_dict(), 1)
    assert _leaf_paths(like) == want
    assert [tuple(a.shape) for _, a in flat] == [tuple(a.shape) for a in leaves]
    placed = tckpt.tree_from_leaves(like, leaves)
    assert _leaf_paths(placed) == want


def test_reference_unpickler_refuses_other_globals(tmp_path):
    import pickle

    path = tmp_path / "evil.npz"
    meta = pickle.dumps({"treedef": print, "extra": {}})
    np.savez(path, __meta__=np.frombuffer(meta, np.uint8), a0=np.zeros(2, np.float32))
    with pytest.raises(pickle.UnpicklingError, match="builtins.print"):
        tckpt.read_reference(str(path))


def test_port_checkpoint_round_trip(tmp_path):
    p, cfg, feat, extra = tfc.load_forecaster(str(CKPT), device="cpu")
    path = str(tmp_path / "fc.npz")
    tfc.save_forecaster(path, p, cfg, feat, metrics={"note": "round trip"})
    assert not tckpt.is_reference(path)
    with np.load(path, allow_pickle=False) as z:
        assert "__meta__" not in z.files          # nothing pickled
    q, cfg2, feat2, extra2 = tfc.load_forecaster(path, device="cpu")
    assert cfg2 == cfg and feat2 == feat and extra2["metrics"] == {"note": "round trip"}
    for (k, a), (k2, b) in zip(p.state_dict().items(), q.state_dict().items()):
        assert k == k2 and torch.equal(a, b)


def test_reference_written_checkpoint_is_read_by_the_port(tmp_path):
    cfg = rfc.model_config(num_layers=2, d_model=16, num_heads=2, d_ff=32)
    feat = rfc.FeatureConfig(window=8)
    params = rfc.init_forecaster(jax.random.key(3), cfg, feat)
    path = str(tmp_path / "ref.npz")
    rfc.save_forecaster(path, params, cfg, feat, metrics={"steps": 0})
    assert tckpt.is_reference(path)
    p, tcfg, tfeat, extra = tfc.load_forecaster(path, device="cpu")
    assert (tcfg.d_model, tcfg.num_heads, tfeat.window) == (16, 2, 8)
    assert extra["metrics"] == {"steps": 0}
    x = np.random.default_rng(1).normal(size=(5, 8, feat.n_features)).astype(np.float32)
    want = np.asarray(rfc.apply_forecaster(params, jnp.asarray(x), cfg))
    got = tfc.apply_forecaster(p, torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_tree_equal_agrees_with_the_reference_on_saved_checkpoints(tmp_path):
    """The port's tree_equal and the reference's on one tree each package
    saved and restored: equal after the round trip, unequal after one
    element of one leaf moves, or when a leaf is missing."""
    from repro.training import checkpoint as rckpt

    cfg = rfc.model_config(num_layers=2, d_model=16, num_heads=2, d_ff=32)
    jtree = jax.tree.map(np.asarray, rfc.init_forecaster(jax.random.key(4), cfg,
                                                         rfc.FeatureConfig(window=8)))
    ttree = convert.params_from_jax(jtree)
    rckpt.save(str(tmp_path / "ref.npz"), params=jtree)
    tckpt.save(str(tmp_path / "port.npz"), params=ttree)
    rback, _ = rckpt.restore(str(tmp_path / "ref.npz"))
    tback, _ = tckpt.restore(str(tmp_path / "port.npz"))
    assert rckpt.tree_equal(jtree, rback) and tckpt.tree_equal(ttree, tback)
    assert tckpt.tree_equal(tback, ttree) and tckpt.tree_equal(convert.nest(ttree),
                                                               convert.nest(dict(tback)))
    name = sorted(ttree)[3]
    moved = dict(tback)
    moved[name] = moved[name].copy()
    moved[name].flat[0] += 1.0
    rmoved = jax.tree.map(np.copy, rback)
    flat, treedef = jax.tree.flatten(rmoved)
    flat[3] = flat[3].copy()
    flat[3].flat[0] += 1.0
    assert not rckpt.tree_equal(jtree, jax.tree.unflatten(treedef, flat))
    assert not tckpt.tree_equal(ttree, moved)
    assert not tckpt.tree_equal(ttree, {k: v for k, v in tback.items() if k != name})
    assert tckpt.tree_equal({"w": torch.ones(3, dtype=torch.bfloat16)},
                            {"w": np.ones(3, np.float32)})


def test_reference_parameter_names_are_accepted(tmp_path):
    """norm_apply takes the reference's eps (and ignores it, as there);
    checkpoint.save and SnapshotStore.save_params take params= by keyword."""
    from repro_torch.models import layers
    from repro_torch.serving.engine import SnapshotStore

    norm = layers.Norm(8, "rmsnorm", "float32", device="cpu")
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 8)).astype(np.float32))
    assert torch.equal(layers.norm_apply(norm, x, "rmsnorm", eps=1e-3),
                       layers.norm_apply(norm, x, "rmsnorm"))
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    assert tckpt.save(str(tmp_path / "a.npz"), params=state) > 0
    assert tckpt.tree_equal(tckpt.restore(str(tmp_path / "a.npz"))[0], state)
    store = SnapshotStore(str(tmp_path / "snaps"))
    assert store.save_params("k", params=state) > 0
    assert torch.equal(store.load_params("k", torch.device("cpu"))["w"], state["w"])


# --------------------------------------------------------------------------- #
# features + dataset: pure-Python copies, held equal
# --------------------------------------------------------------------------- #
def test_features_and_dataset_equal_reference():
    from repro.learn import dataset as rds
    from repro.learn import features as rfeat
    from repro_torch.learn import dataset as tds
    from repro_torch.learn import features as tfeat

    rcfg, tcfg = rfeat.FeatureConfig(window=6), tfeat.FeatureConfig(window=6)
    gaps, ends = [3.0, 250.0, 0.5, 60.0], [10.0, 260.0, 260.5, 320.5]
    assert np.array_equal(rfeat.encode_window(gaps, ends, rcfg),
                          tfeat.encode_window(gaps, ends, tcfg))
    times = np.cumsum(np.random.default_rng(2).exponential(40.0, size=30))
    for a, b in zip(rfeat.function_examples(times, rcfg),
                    tfeat.function_examples(times, tcfg)):
        assert np.array_equal(a, b)
    mix = [m for m in rds.TRAIN_MIX if m[0] in ("cron_fast", "rare_a")]
    rex = rds.build_examples(rds.training_traces(7, mix), rcfg, master_seed=7)
    tex = tds.build_examples(tds.training_traces(7, mix), tcfg, master_seed=7)
    assert np.array_equal(rex["x"], tex["x"]) and np.array_equal(rex["y"], tex["y"])
    for a, b in zip(rds.batches(rex, 16, steps=4), tds.batches(tex, 16, steps=4)):
        assert np.array_equal(a["x"], b["x"]) and np.array_equal(a["y"], b["y"])


# --------------------------------------------------------------------------- #
# the cluster step's extras and step offset (the gym's launch)
# --------------------------------------------------------------------------- #
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_JAX_STEP = jax.jit(jax.vmap(rref.cluster_step_full,
                             in_axes=(0, 0, 0, 0, 0, None, 0, 0, 0, 0, 0, 0)))

EXTRAS_CASES = [
    dict(seed=0, t_begin=0), dict(seed=1, t_begin=3), dict(seed=2, t_begin=9),
    dict(seed=3, t_begin=20, C=4, F=16, W=8, K=6, T=40, worker_mb=16384.0),
]


@pytest.mark.parametrize("case", EXTRAS_CASES, ids=lambda c: f"seed{c['seed']}")
def test_cluster_extras_match_reference_loop(case):
    kw = dict(case)
    seed, t_begin = kw.pop("seed"), kw.pop("t_begin")
    tables = _chip_smoke().random_tables(np.random.default_rng(seed), **kw)
    nw, fs, free, arrivals, conc, promote, dwell, ntier, frac, scal, fparam = tables
    static = (fparam, promote, dwell, ntier, frac, scal)
    state = (jnp.asarray(nw), jnp.asarray(fs), jnp.asarray(free))
    C, T, F = arrivals.shape
    agg = np.zeros((C, rref.AG_N), np.float32)
    cold = np.zeros((C, F), np.float32)
    idle = np.zeros((C, F), np.float32)
    for t in range(T):
        now = np.float32(t_begin + t) * np.float32(0.5)
        *state, d, (c, g) = _JAX_STEP(*state, arrivals[:, t], conc[:, t], now, *static)
        agg, cold, idle = agg + np.asarray(d), cold + np.asarray(c), idle + np.asarray(g)
    args = [torch.from_numpy(a) for a in _chip_smoke().kernel_order(tables)]
    before = tcluster.launches
    got = tcluster.cluster_sim_hopper(*args, t_begin=t_begin, extras=True)
    assert tcluster.launches == before            # CPU tensors: the plain version
    assert len(got) == 5 and tuple(got[4].shape) == (C, 2, F)
    want = (*state, agg, np.stack([cold, idle], axis=1))
    for name, g, w in zip(("nw", "fs", "free", "agg", "extras"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)
    # without extras the same call gives the same four results
    four = tcluster.cluster_sim_hopper(*args, t_begin=t_begin)
    assert len(four) == 4
    for a, b in zip(four, got):
        assert torch.equal(a, b)


def test_cluster_wrapper_refuses_a_bad_step_offset():
    tables = _chip_smoke().kernel_order(_chip_smoke().random_tables(np.random.default_rng(0)))
    args = [torch.from_numpy(a) for a in tables]
    for bad in (-1, 2 ** 24):
        with pytest.raises(ValueError, match="t_begin"):
            tcluster.cluster_sim_hopper(*args, t_begin=bad)


# --------------------------------------------------------------------------- #
# the gym
# --------------------------------------------------------------------------- #
GYM_KW = dict(seeds=(1, 2), horizon=120.0)


@pytest.fixture(scope="module")
def gyms():
    return RGym(r_scenarios(**GYM_KW)), TGym(t_scenarios(**GYM_KW), device="cpu")


def test_gym_reset_and_steps_match_reference(gyms):
    rg, tg = gyms
    assert (tg.C, tg.F, tg.num_epochs) == (rg.C, rg.F, rg.num_epochs)
    assert np.array_equal(tg.valid_mask, rg.valid_mask)
    assert tg.function_names == rg.function_names
    rs, ro = rg.reset()
    ts, to = tg.reset()
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(4)
    actions = np.asarray(rg.actions, np.float32)
    for fixed in (30.0, None, 600.0):
        w = (np.full((rg.C, rg.F), fixed, np.float32) if fixed is not None
             else actions[rng.integers(0, len(actions), (rg.C, rg.F))])
        rs, ro, rr, (rc, ri) = rg.step(rs, w)
        ts, to, tr, (tc, ti) = tg.step(ts, w)
        np.testing.assert_allclose(tr.numpy(), np.asarray(rr), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tc.numpy(), np.asarray(rc), atol=1e-2)
        np.testing.assert_allclose(ti.numpy(), np.asarray(ri), **TOL)
        np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=1e-4, atol=1e-4)
        for name in ("nw", "fs", "free", "last_arr", "ema_gap"):
            np.testing.assert_allclose(getattr(ts, name).numpy(),
                                       np.asarray(getattr(rs, name)), **TOL, err_msg=name)
        assert int(ts.epoch) == int(rs.epoch)
    assert tg.done(ts) == rg.done(rs) is False


def _same_eval(got, want):
    np.testing.assert_allclose(got["reward"], want["reward"], rtol=1e-4)
    np.testing.assert_allclose(got["cold_starts"], want["cold_starts"], atol=1e-2)
    np.testing.assert_allclose(got["idle_gb_s"], want["idle_gb_s"], **TOL)


def test_gym_baseline_rewards_and_schedule_match_reference(gyms):
    rg, tg = gyms
    rb, tb = rg.baseline_rewards(), tg.baseline_rewards()
    assert list(tb) == list(rb)
    for a in rb:
        _same_eval(tb[a], rb[a])
    sched = json.loads(SCHEDULE.read_text())["warm_s"]
    _same_eval(tagent.evaluate_schedule(tg, sched), ragent.evaluate_schedule(rg, sched))


# --------------------------------------------------------------------------- #
# the DQN agent
# --------------------------------------------------------------------------- #
def _batch(rng, n):
    from repro.learn.gym import OBS_DIM
    return (rng.normal(size=(n, OBS_DIM)).astype(np.float32),
            rng.integers(0, 5, n).astype(np.int32),
            (rng.normal(size=n) * 3).astype(np.float32),
            rng.normal(size=(n, OBS_DIM)).astype(np.float32),
            (rng.random(n) < 0.2).astype(np.float32))


def test_qnet_and_td_update_match_reference():
    cfg = ragent.DQNConfig(hidden=16, batch_size=32)
    tcfg = tagent.DQNConfig(hidden=16, batch_size=32)
    rp = ragent.init_qnet(jax.random.key(0), cfg)
    rt = ragent.init_qnet(jax.random.key(1), cfg)
    tp, tt = _torch_tree(rp), _torch_tree(rt)
    batch = _batch(np.random.default_rng(5), 32)
    np.testing.assert_allclose(tagent.apply_qnet(tp, torch.from_numpy(batch[0])).numpy(),
                               np.asarray(ragent.apply_qnet(rp, jnp.asarray(batch[0]))),
                               rtol=1e-5, atol=1e-5)
    ropt_cfg = ropt.OptimizerConfig(lr=cfg.lr, warmup_steps=0, total_steps=100,
                                    weight_decay=0.0)
    topt_cfg = topt.OptimizerConfig(lr=cfg.lr, warmup_steps=0, total_steps=100,
                                    weight_decay=0.0)
    r_upd = ragent._td_update_fn(cfg, ropt_cfg)
    t_upd = tagent._td_update_fn(tcfg, topt_cfg)
    rs, ts = ropt.init_opt_state(rp), topt.init_opt_state(tp)
    for _ in range(2):
        rp, rs, rloss = r_upd(rp, rt, rs, tuple(jnp.asarray(a) for a in batch))
        tp, ts, tloss = t_upd(tp, tt, ts, tuple(torch.from_numpy(a) for a in batch))
        np.testing.assert_allclose(float(tloss), float(rloss), rtol=1e-5)
    for rl, tl in zip(jax.tree.leaves(rp), topt.tree_leaves(tp)):
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), rtol=1e-5, atol=1e-5)


def test_greedy_and_mean_q_schedules_match_reference(gyms):
    rg, tg = gyms
    rp = ragent.init_qnet(jax.random.key(7), ragent.DQNConfig(hidden=16))
    tp = _torch_tree(rp)
    assert tagent.greedy_schedule(tg, tp) == ragent.greedy_schedule(rg, rp)
    assert tagent.mean_q_schedule(tg, tp) == ragent.mean_q_schedule(rg, rp)


def test_train_agent_and_export_on_the_cpu(gyms, tmp_path):
    _, tg = gyms
    cfg = tagent.DQNConfig(hidden=16, batch_size=32, updates_per_epoch=2)
    params, hist = tagent.train_agent(tg, episodes=2, cfg=cfg, log_fn=None)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    warm_s, metrics, method = tagent.export_schedule(tg, params)
    assert method in ("modal_vote", "mean_q")
    assert set(warm_s) == {n for names in tg.function_names for n in names}
    assert set(warm_s.values()) <= set(tg.actions)
    path = tmp_path / "sched.json"
    tagent.save_schedule(str(path), warm_s, meta={"method": method})
    got = json.loads(path.read_text())
    assert set(got) == set(json.loads(SCHEDULE.read_text()))
    from repro_torch.core.policies.lifetime import load_keepalive_schedule
    assert load_keepalive_schedule(str(path))["warm_s"] == warm_s


def test_learned_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch.core.predictors.lstm import LSTMPredictor
    from repro_torch.core.predictors.transformer import TransformerPredictor
    for make in (lambda: TGym(t_scenarios(**GYM_KW)),
                 lambda: tagent.init_qnet(torch.Generator(), tagent.DQNConfig()),
                 lambda: tfc.load_forecaster(str(CKPT)),
                 lambda: TransformerPredictor(str(CKPT)),
                 LSTMPredictor,
                 lambda: tfc.train_forecaster(iter(()), steps=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
