"""The port's batch driver (``repro_torch.core.batchsim`` and the cluster
step) against the JAX package's, on the CPU.

The same numpy inputs go through both packages.  On the CPU the port runs
the hand kernel's plain version, a loop over time of the batched torch step.
The tolerance is the reference's own for its Pallas twin against the oracle
(``tests/test_batchsim.py``): ``rtol=1e-4, atol=1e-2``.  Copies of pure
Python modules (tables, schedules, the scalar simulator, the registry) are
held to exact equality.
"""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batchsim as rbatch
from repro.experiments import cli as rcli
from repro.experiments import registry as rreg
from repro.experiments import runner as rrun
from repro.experiments.spec import WorkloadSpec
from repro.kernels import ref as rref
from repro_torch.core import batchsim as tbatch
from repro_torch.experiments import cli as tcli
from repro_torch.experiments import registry as treg
from repro_torch.experiments import runner as trun
from repro_torch.experiments.spec import Scenario as TScenario
from repro_torch.kernels import ref as tref
from test_batchsim import _cell, _random_tables

TOL = dict(rtol=1e-4, atol=1e-2)
ROOT = Path(__file__).resolve().parents[1]
TABLE_FIELDS = ("nw", "fs", "free", "arrivals", "conc", "fparam", "promote",
                "dwell", "ntier", "frac", "scal")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain loop steps tensors of a few thousand entries, ~100k small
    ops a grid: intra-op threads add only their wake-up to each (on a busy
    host, milliseconds per floor or ceil)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _chip_smoke():
    """chip_smoke.py as a module: it holds the numpy copy of the fixtures
    that the card runs (no JAX there)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(sc):
    """The same scenario as a port Scenario (through its JSON dict)."""
    return TScenario.from_dict(sc.to_dict())


def _same_summary(a, b, **tol):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], float) and math.isnan(a[k]):
            assert math.isnan(b[k]), k
        elif tol:
            np.testing.assert_allclose(b[k], a[k], err_msg=k, **tol)
        else:
            assert a[k] == b[k], (k, a[k], b[k])


# --------------------------------------------------------------------------- #
# the cluster step, step by step, extras included
# --------------------------------------------------------------------------- #
FIXTURES = {
    "seed0": dict(seed=0), "seed1": dict(seed=1), "seed2": dict(seed=2),
    # wider: more workers than a row of 4, a longer schedule, workers large
    # enough that 16 functions keep free memory
    "wide": dict(seed=3, C=4, F=16, W=8, K=6, T=64, worker_mb=16384.0),
}


# one jitted reference step for every fixture (the three seeds share a trace)
_JAX_STEP = jax.jit(jax.vmap(rref.cluster_step_full,
                             in_axes=(0, 0, 0, 0, 0, None, 0, 0, 0, 0, 0, 0)))


@pytest.mark.parametrize("name", list(FIXTURES))
def test_cluster_step_full_matches_jax(name):
    kw = dict(FIXTURES[name])
    seed = kw.pop("seed")
    tables = _chip_smoke().random_tables(np.random.default_rng(seed), **kw)
    if not kw:       # the card's copy of the fixture is the reference's fixture
        for a, b in zip(tables, _random_tables(np.random.default_rng(seed))):
            assert np.array_equal(a, b)
    nw, fs, free, arrivals, conc, promote, dwell, ntier, frac, scal, fparam = tables
    static = (fparam, promote, dwell, ntier, frac, scal)
    js = (jnp.asarray(nw), jnp.asarray(fs), jnp.asarray(free))
    ts = tuple(torch.from_numpy(x) for x in (nw, fs, free))
    tstatic = tuple(torch.from_numpy(x) for x in static)
    jagg = np.zeros((nw.shape[0], rref.AG_N), np.float32)
    tagg = torch.zeros((nw.shape[0], tref.AG_N))
    for t in range(arrivals.shape[1]):
        now = np.float32(t * 0.5)
        *js, jd, (jcold, jidle) = _JAX_STEP(*js, arrivals[:, t], conc[:, t], now, *static)
        *ts, td, (tcold, tidle) = tref.cluster_step_full(
            *ts, torch.from_numpy(arrivals[:, t]), torch.from_numpy(conc[:, t]),
            now, *tstatic)
        jagg, tagg = jagg + np.asarray(jd), tagg + td
        for what, a, b in (("cold", jcold, tcold), ("idle_gb", jidle, tidle)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL,
                                       err_msg=f"{what} at step {t}")
    for what, a, b in zip(("nw", "fs", "free", "agg"), (*js, jagg), (*ts, tagg)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL, err_msg=what)


def test_plain_sim_matches_stepping_the_oracle():
    tables = _random_tables(np.random.default_rng(5))
    nw, fs, free, arrivals, conc, promote, dwell, ntier, frac, scal, fparam = (
        torch.from_numpy(x) for x in tables)
    from repro_torch.kernels import cluster_step as kc
    before = kc.launches
    got = kc.cluster_sim_hopper(nw, fs, free, arrivals, conc, fparam, promote,
                                dwell, ntier, frac, scal)
    assert kc.launches == before          # a CPU tensor runs the plain version
    state, agg = (nw, fs, free), torch.zeros((nw.shape[0], tref.AG_N))
    for t in range(arrivals.shape[1]):
        *state, d = tref.cluster_step_ref(*state, arrivals[:, t], conc[:, t],
                                          np.float32(t * 0.5), fparam, promote,
                                          dwell, ntier, frac, scal)
        agg = agg + d
    for a, b in zip((*state, agg), got):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# whole registered grids: tables, run and ledgers
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def grids():
    out = {}
    for name in ("batch_dense64", "batch_grid64"):
        rt = rbatch.build_tables(rreg.get_sweep(name).scenarios(),
                                 trace_fn=rrun.build_trace)
        tt = tbatch.build_tables(treg.get_sweep(name).scenarios(),
                                 trace_fn=trun.build_trace)
        out[name] = (rt, tt)
    return out


@pytest.mark.parametrize("grid", ["batch_dense64", "batch_grid64"])
def test_build_tables_bit_equal(grids, grid):
    rt, tt = grids[grid]
    for field in TABLE_FIELDS:
        assert np.array_equal(getattr(rt, field), getattr(tt, field)), field
    assert (rt.horizons, rt.invocations, rt.dt) == (tt.horizons, tt.invocations, tt.dt)
    assert rt.arrivals.shape[1] % 128 == 0
    if grid == "batch_grid64":      # the tiered_fixed ladder reaches PAUSED / SNAPSHOT
        assert {rref.T_PAUSED, rref.T_SNAP} <= set(np.unique(tt.ntier).tolist())


@pytest.mark.parametrize("grid", ["batch_dense64", "batch_grid64"])
def test_run_tables_matches_reference_on_whole_grid(grids, grid):
    rt, tt = grids[grid]
    ref = rbatch.run_tables(rt, kernel="ref")
    got = tbatch.run_tables(tt, device="cpu")
    for what, a, b in zip(("nw", "fs", "agg"), ref, got):
        np.testing.assert_allclose(b, a, **TOL, err_msg=what)
    for rl, tl in zip(rbatch.ledgers_from_agg(rt, *ref),
                      tbatch.ledgers_from_agg(tt, *got)):
        _same_summary(rl.summary(), tl.summary(), **TOL)


def test_run_tables_kernel_names():
    tables = tbatch.build_tables([_port(_cell())])
    with pytest.raises(ValueError, match="unknown batch kernel"):
        tbatch.run_tables(tables, kernel="tpu", device="cpu")
    with pytest.raises(ValueError, match="unknown batch kernel"):
        tbatch.run_tables(tables, kernel="pallas", device="cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tbatch.run_tables(tables, kernel="cuda", device="cpu")


# --------------------------------------------------------------------------- #
# the scalar side: spot check, simulator, unsupported policies, registry
# --------------------------------------------------------------------------- #
def test_spot_check_agrees_with_reference():
    cells = [_cell(seed=1, ttl=30.0, rate=16.0, horizon=180.0, fns=8,
                   workers=4),
             _cell(seed=2, policy="tiered_fixed", rate=16.0, horizon=180.0,
                   fns=8, workers=4)]
    ref = rbatch.spot_check(cells)
    got = tbatch.spot_check([_port(sc) for sc in cells], device="cpu")
    for r, g in zip(ref, got):
        assert g.ok
        assert (g.name, g.cold_rate_sim, g.idle_gb_s_sim) == \
            (r.name, r.cold_rate_sim, r.idle_gb_s_sim)
        np.testing.assert_allclose([g.cold_rate_batch, g.idle_gb_s_batch],
                                   [r.cold_rate_batch, r.idle_gb_s_batch],
                                   rtol=1e-4)


@pytest.mark.parametrize("name", ["calib/tiered_spes", "calib/pause_pool", "csf"])
def test_simulate_summary_equals_reference(name):
    _same_summary(rrun.run(name, "sim").summary(),
                  trun.run(name, "sim").summary())


UNSUPPORTED = {
    "prewarm": _cell(policy="prewarm_ewma"),
    "stream": _cell().with_overrides({"workload": WorkloadSpec(
        "azure_full", {"horizon": 60.0, "num_functions": 4}, seed=3)}),
    "chain": _cell().with_overrides({"workload": WorkloadSpec(
        "chains", {"rate": 2.0, "horizon": 60.0}, seed=3)}),
}


@pytest.mark.parametrize("kind", list(UNSUPPORTED))
def test_unsupported_policy_messages_equal(kind):
    sc = UNSUPPORTED[kind]
    with pytest.raises(rbatch.BatchUnsupportedPolicy) as ref:
        rbatch.simulate_batch([sc])
    with pytest.raises(tbatch.BatchUnsupportedPolicy) as got:
        tbatch.simulate_batch([_port(sc)], device="cpu")
    assert str(got.value) == str(ref.value)


def test_registry_equals_reference():
    assert treg.names() == rreg.names()
    assert treg.sweep_names() == rreg.sweep_names()
    for name in rreg.names():
        assert treg.get(name).to_dict() == rreg.get(name).to_dict()
    for name in rreg.sweep_names():
        assert [sc.to_dict() for sc in treg.get_sweep(name).scenarios()] == \
            [sc.to_dict() for sc in rreg.get_sweep(name).scenarios()]


def test_sweep_cli_batch_matches_reference(tmp_path):
    import json

    argv = ["sweep", "calib/tiered_fixed", "--axis",
            "policy=provider_short,tiered_fixed", "--driver", "batch"]
    assert rcli.main(argv + ["--json", str(tmp_path / "ref.json")]) == 0
    assert tcli.main(argv + ["--device", "cpu",
                             "--json", str(tmp_path / "port.json")]) == 0
    ref = json.loads((tmp_path / "ref.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert [r["scenario"] for r in got] == [r["scenario"] for r in ref]
    for r, g in zip(ref, got):
        _same_summary(r["summary"], g["summary"], **TOL)


def test_unported_drivers_and_suites_raise():
    with pytest.raises(ValueError, match="topology"):
        trun.run("calib/topo_basic", "batch", device="cpu")
    # the learned suites are ported: the batch driver refuses the prewarm
    # ones, as the reference's does (online predictors, no static
    # schedule), and freezes tiered_transformer's ladder into a schedule
    # with the forecaster on the asked device (the reference cannot load
    # its committed checkpoint under jax 0.9: ROADMAP C)
    from repro_torch.core.policies import suite
    for name in ("prewarm_lstm", "prewarm_transformer", "tiered_transformer"):
        assert suite(name, device="cpu").name == name
    for name in ("prewarm_lstm", "prewarm_transformer"):
        sc = rreg.get("learn").with_overrides({"policy": name})
        with pytest.raises(rbatch.BatchUnsupportedPolicy) as want:
            rbatch.simulate_batch([sc])
        with pytest.raises(tbatch.BatchUnsupportedPolicy) as got:
            tbatch.simulate_batch([_port(sc)], device="cpu")
        assert str(got.value) == str(want.value)
    sc = _port(rreg.get("calib/tiered_spes").with_overrides(
        {"policy": "tiered_transformer"}))
    led, = tbatch.simulate_batch([sc], device="cpu")
    assert led.summary()["requests"] > 0
