"""The port's learned predictors (``repro_torch.core.predictors.{transformer,
lstm}``, ``repro_torch.learn.forecaster``) and the policy catalog they
complete, against the JAX package's, on the CPU.

Weights travel as numpy: the committed forecaster checkpoint's leaves, and
the LSTM's initial params converted from the reference's ``_init_lstm``.
Tolerances: forecaster quantiles within 1e-5 (fp32, two attention layers
summed in another order); the LSTM's prediction after one online training
round (40 Adam steps) within 1e-4.  The reference never loads
``checkpoints/forecaster.npz`` through ``load_forecaster`` (its pickled
treedef fails under jax 0.9): its predictor reads a copy of the same
leaves that its own ``save_forecaster`` wrote.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.predictors import lstm as rlstm
from repro.core.predictors import transformer as rtp
from repro.core.workload import cron_spikes
from repro.learn import forecaster as rfc
from repro.learn.features import FeatureConfig as RFeat
from repro_torch.core.predictors import lstm as tlstm
from repro_torch.core.predictors import transformer as ttp
from repro_torch.learn import forecaster as tfc
from repro_torch.models import convert
from repro_torch.training import checkpoint as tckpt

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "checkpoints" / "forecaster.npz"
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def _reference_params():
    """The committed checkpoint's leaves in the reference's own tree."""
    leaves, extra = tckpt.read_reference(str(CKPT))
    cfg = rfc.model_config(**extra["model"])
    feat = RFeat.from_dict(extra["features"])
    _, treedef = jax.tree.flatten(rfc.init_forecaster(jax.random.key(0), cfg, feat))
    return jax.tree.unflatten(treedef, [jnp.asarray(a) for a in leaves]), cfg, feat


def _windows():
    """chip_smoke.py's 64 seeded windows (its card-vs-CPU check uses them)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._forecaster_windows()


def test_forecaster_matches_reference_on_the_committed_checkpoint():
    rparams, cfg, _ = _reference_params()
    x = _windows()
    want = np.asarray(rfc.apply_forecaster(rparams, jnp.asarray(x), cfg))
    p, tcfg, _, _ = tfc.load_forecaster(str(CKPT), device="cpu")
    got = tfc.apply_forecaster(p, torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (np.diff(got, axis=1) >= 0).all()          # q05 <= q50 <= q95
    # the same weights through the converter (the path tests use for parity)
    state = convert.params_from_jax(jax.tree.map(np.asarray, rparams))
    assert sorted(state) == sorted(p.state_dict())
    for k, v in p.state_dict().items():
        assert torch.equal(state[k], v), k


def test_pinball_loss_matches_reference():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(9, 3)).astype(np.float32)
    y = rng.normal(size=(9,)).astype(np.float32)
    want = float(rfc.pinball_loss(jnp.asarray(q), jnp.asarray(y), (0.05, 0.5, 0.95)))
    got = float(tfc.pinball_loss(torch.from_numpy(q), torch.from_numpy(y),
                                 (0.05, 0.5, 0.95)))
    assert got == pytest.approx(want, rel=1e-6)


def test_transformer_predictor_matches_reference(tmp_path):
    rparams, cfg, feat = _reference_params()
    path = str(tmp_path / "forecaster.npz")
    rfc.save_forecaster(path, rparams, cfg, feat)      # the reference's format
    rp = rtp.TransformerPredictor(checkpoint=path)
    tp = ttp.TransformerPredictor(checkpoint=path, device="cpu")
    assert rp.predict_next() is None and tp.predict_next() is None
    assert tp.uncertainty() == float("inf")
    tr = cron_spikes(7200.0, num_functions=1, base_gap_s=240.0, spike_gap_s=75.0,
                     spike_period_s=3600.0, jitter=0.05, seed=5)
    for t in tr.times_for("fn0")[:24]:
        rp.observe(t)
        tp.observe(t)
        if rp.predict_next() is None:
            assert tp.predict_next() is None
            continue
        np.testing.assert_allclose(tp.window(), rp.window(), rtol=1e-5)
        np.testing.assert_allclose(tp.predict_next(), rp.predict_next(), rtol=1e-5)
        np.testing.assert_allclose(tp.uncertainty(), rp.uncertainty(), rtol=1e-4, atol=1e-3)
    # one model per (checkpoint, device), shared by every predictor
    assert ttp.TransformerPredictor(checkpoint=path, device="cpu")._params is tp._params


def test_transformer_or_fallback_without_checkpoint(tmp_path, monkeypatch):
    from repro_torch.core.predictors.histogram import HistogramPredictor

    monkeypatch.chdir(tmp_path)     # hide checkpoints/forecaster.npz
    monkeypatch.delenv("REPRO_FORECASTER_CKPT", raising=False)
    monkeypatch.setattr(ttp, "_WARNED_FALLBACK", False)
    with pytest.warns(UserWarning, match="fall back"):
        factory = ttp.transformer_or_fallback(device="cpu")
    assert factory is HistogramPredictor


def _periodic(n, gap, jitter, seed):
    rng = np.random.default_rng(seed)
    return list(np.cumsum(gap + rng.normal(0.0, jitter, n)))


def test_lstm_predict_next_after_one_training_round_matches_reference():
    rp = rlstm.LSTMPredictor(train_every=24, epochs=40, seed=0)
    tp = tlstm.LSTMPredictor(train_every=24, epochs=40, device="cpu")
    tp.params = dict(convert.params_from_jax(jax.tree.map(np.asarray, rp.params)))
    times = _periodic(n=30, gap=8.0, jitter=0.5, seed=1)
    for i, t in enumerate(times):
        rp.observe(t)
        tp.observe(t)
        if i == 15:                         # before training: the initial params
            np.testing.assert_allclose(tp.predict_next(), rp.predict_next(), rtol=1e-5)
    assert len(rp.losses) == len(tp.losses) == 1
    np.testing.assert_allclose(tp.losses, rp.losses, rtol=1e-4)
    for name in rp.params:
        np.testing.assert_allclose(tp.params[name].numpy(), np.asarray(rp.params[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    gap_r = rp.predict_next() - rp.last_t
    gap_t = tp.predict_next() - tp.last_t
    np.testing.assert_allclose(gap_t, gap_r, rtol=1e-4)
    assert tp.uncertainty() == pytest.approx(rp.uncertainty(), rel=1e-5)


def test_lstm_trains_and_loss_falls():
    pred = tlstm.LSTMPredictor(train_every=24, epochs=30, device="cpu")
    for t in _periodic(n=120, gap=8.0, jitter=0.2, seed=1):
        pred.observe(t)
    assert len(pred.losses) >= 2
    assert pred.losses[-1] < pred.losses[0]
    nxt = pred.predict_next()
    assert nxt is not None and abs(nxt - (pred.last_t + 8.0)) < 6.0


_CATALOG = """
import json, sys
from repro_torch.core.policies import CATALOG, suite
from repro_torch.core.simulator import simulate
from repro_torch.core.workload import poisson
from repro_torch.experiments import runner
tr = poisson(rate=0.5, horizon=60.0, num_functions=4, seed=0)
out = {}
for name in CATALOG:
    s = simulate(tr, suite(name, device="cpu")).summary()
    out[name] = s["requests"]
sc = runner.registry.get("learn")
s = runner.run(sc, "sim", device="cpu").summary()
foreign = sorted(m for m in sys.modules
                 if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(json.dumps({"requests": out, "learn": s["requests"], "foreign": foreign}))
"""


def test_every_catalog_suite_runs_under_the_port_without_jax():
    proc = subprocess.run([sys.executable, "-c", _CATALOG], env=ENV, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["foreign"] == []
    from repro_torch.core.policies import CATALOG
    assert set(got["requests"]) == set(CATALOG)
    assert {"prewarm_lstm", "prewarm_transformer", "tiered_transformer"} <= set(CATALOG)
    assert all(n > 0 for n in got["requests"].values()), got["requests"]
    assert got["learn"] > 0


def test_learned_suites_put_their_predictors_on_the_asked_device():
    from repro_torch.core.policies import suite

    s = suite("prewarm_transformer", device="cpu")
    pred = s.prewarm.factory()
    assert isinstance(pred, ttp.TransformerPredictor) and pred.device.type == "cpu"
    s = suite("prewarm_lstm", device="cpu")
    assert s.prewarm.factory().device.type == "cpu"
    s = suite("tiered_transformer", device="cpu")
    assert s.lifetime.predictor_factory().device.type == "cpu"
    if torch.cuda.is_available():
        return
    for name, part in (("prewarm_transformer", "prewarm"), ("prewarm_lstm", "prewarm")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(suite(name), part).factory()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        suite("tiered_transformer").lifetime.predictor_factory()
