"""The port's router / fleet facade against the JAX package's.

The fleet, topology and analyze modules are pure Python copies, so their
ledgers must equal the reference's bit for bit (NaN == NaN), and the port's
own sim-vs-fleet identity gate (ledgers and event streams) must hold on
every ``calib/*`` cell without a topology.  The engine paths run SMOKE
``xlstm-125m`` on the CPU (``device="cpu"``); their checks are structural
(cold then warm, a restore with no warm-up, every invocation served), never
a wall-clock comparison.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.experiments import runner as jrun
from repro.fleet.pool import EngineBackend as JaxEngineBackend
from repro_torch.analyze.calibrate import (fidelity_report, measured_costs,
                                           write_calibration)
from repro_torch.core.costmodel import CostModel
from repro_torch.core.events import EventLog, validate_events
from repro_torch.core.lifecycle import Phase
from repro_torch.experiments import registry
from repro_torch.experiments import runner as trun
from repro_torch.fleet.pool import EngineBackend, EngineProfile
from repro_torch.serving.engine import InferenceEngine, SnapshotStore
from repro_torch.serving.router import FunctionDef, ServerlessRouter

ROOT = Path(__file__).resolve().parents[1]
CALIB = [n for n in registry.names()
         if n.startswith("calib/") and registry.get(n).topology is None]
TOPO = [n for n in registry.names()
        if n.startswith("calib/") and registry.get(n).topology is not None]
ARCH = "xlstm-125m"


def test_calib_cells_are_listed():
    assert len(CALIB) >= 8 and "calib/tiered_spes" in CALIB
    assert TOPO == ["calib/topo_basic"]


@pytest.mark.parametrize("name", CALIB)
def test_sim_and_fleet_ledgers_and_events_identical(name):
    ev_sim, ev_fleet = EventLog(), EventLog()
    a = trun.run(name, "sim", events=ev_sim)
    b = trun.run(name, "fleet", events=ev_fleet)
    diff = trun.compare(a, b, events_a=ev_sim, events_b=ev_fleet)
    assert diff.identical, str(diff)
    assert len(ev_fleet) > 0 and validate_events(ev_fleet) == []


@pytest.mark.parametrize("name", CALIB + TOPO)
def test_fleet_summary_equals_the_reference(name):
    got = trun.run(name, "fleet").summary()
    want = jrun.run(name, "fleet").summary()
    diff = trun.compare(got, want)
    assert diff.identical, str(diff)


@pytest.mark.parametrize("driver", ["sim", "fleet"])
def test_topology_summary_equals_the_reference(driver):
    """The TopologyLedger's merged summary with its per-node and per-class
    keys, and the sim-vs-fleet identity under the port's driver."""
    got = trun.run("calib/topo_basic", driver)
    want = jrun.run("calib/topo_basic", driver)
    assert type(got).__name__ == type(want).__name__ == "TopologyLedger"
    diff = trun.compare(got.summary(), want.summary())
    assert diff.identical, str(diff)
    assert got.summary()["offloaded_fraction"] > 0.0


def _probe_events(name):
    ev = EventLog()
    trun.run(name, "fleet", cost_model=CostModel(), events=ev)
    return ev.events, dict(trun.build_trace(registry.get(name)).functions)


def test_measured_costs_recover_model_defaults(tmp_path):
    base = CostModel()
    events, functions = [], {}
    for cell in ("calib/engine_paused", "calib/engine_snapshot"):
        ev, fns = _probe_events(cell)
        events.extend(ev)
        functions.update(fns)
    calib = measured_costs(events, functions, base)
    for key in ("provision_base_s", "compile_base_s", "load_bandwidth_gbps",
                "resume_paused_s", "snapshot_restore_frac"):
        assert calib[key] == pytest.approx(getattr(base, key)), key
    path = str(tmp_path / "calibration.json")
    write_calibration(path, calib)
    rows = fidelity_report(events, functions, CostModel.from_calibration(path))
    assert rows
    for r in rows:
        assert abs(r["rel_err"]) < 1e-6, r


# --------------------------------------------------------------------------- #
# the real-engine facade on the CPU
# --------------------------------------------------------------------------- #


def _router(ttl, store):
    router = ServerlessRouter(ttl_s=ttl, store=store, device="cpu")
    router.register(FunctionDef("f", ARCH, max_seq=16, decode_steps=2))
    return router


@pytest.fixture
def warm_ups(monkeypatch):
    """Counts the engines' warm-ups (code_init's work): a restore of a key
    warmed in this process runs none."""
    calls = []
    warm_up = InferenceEngine._warm_up
    monkeypatch.setattr(InferenceEngine, "_warm_up",
                        lambda self: calls.append(self.key) or warm_up(self))
    return calls


def test_router_cold_then_warm_then_restore(tmp_path, warm_ups):
    store = SnapshotStore(str(tmp_path / "snap"))
    router = _router(300.0, store)
    tokens = np.random.default_rng(0).integers(0, 512, (1, 16)).astype(np.int32)
    out1, r1 = router.invoke("f", tokens)
    out2, r2 = router.invoke("f", tokens)
    assert r1.cold and r1.startup.seconds[Phase.CODE_INIT] > 0
    assert not r2.cold and r2.startup is None
    assert len(warm_ups) == 1
    np.testing.assert_array_equal(out1, out2)
    assert out1.shape == (1, 2)
    assert router.summary()["requests"] == 2
    # scale to zero at ttl 0 on the same store: every call is cold, and the
    # key is warmed in this process, so each restore skips the warm-up
    zero = _router(0.0, store)
    outs, recs = zip(*(zero.invoke("f", tokens) for _ in range(2)))
    assert all(r.cold for r in recs)
    assert len(warm_ups) == 1
    assert all(set(r.startup.seconds) == set(r1.startup.seconds) for r in recs)
    np.testing.assert_array_equal(outs[0], out1)
    np.testing.assert_array_equal(outs[1], out1)


def test_router_restore_in_a_new_store_reads_the_file(tmp_path, warm_ups):
    """A store without the in-process copies (a new process) restores from
    the snapshot file and warms the key up once."""
    root = str(tmp_path / "snap")
    first = _router(0.0, SnapshotStore(root))
    tokens = np.ones((1, 16), np.int32)
    want, _ = first.invoke("f", tokens)
    fresh = SnapshotStore(root)
    assert fresh.has_params(f"{ARCH}_s16_b1_True") and not fresh.host
    got, rec = _router(0.0, fresh).invoke("f", tokens)
    assert rec.cold and len(warm_ups) == 2
    np.testing.assert_array_equal(got, want)


def test_engine_serve_takes_the_reference_call_shape(tmp_path):
    """C1: the reference's own ``EngineBackend.serve`` (and the router's
    ``extras=`` keyword) against the port's engine."""
    eng = InferenceEngine(ARCH, smoke=True, max_seq=16, store=None, device="cpu",
                          runtime="python-jit")
    assert eng.runtime == "python-jit"
    eng.cold_start()
    tokens = np.ones((1, 16), np.int32)
    want, _ = eng.serve(tokens, decode_steps=3)
    replica = types.SimpleNamespace(engine=eng)
    got, secs = JaxEngineBackend().serve(replica, tokens, decode_steps=3, extras=None)
    np.testing.assert_array_equal(got, want)
    assert secs > 0
    got, _ = EngineBackend(device="cpu").serve(replica, tokens, decode_steps=3, extras={})
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="frames"):
        eng.serve(tokens, decode_steps=1, extras={"frames": np.zeros((1, 4, 8), np.float32)})
    with pytest.raises(ValueError, match="pixels"):
        eng.serve(tokens, decode_steps=1, extras={"pixels": np.zeros(3)})
    # a vision config takes image_embeds, of its batch spec's shape only
    from repro_torch.config import VisionConfig
    eng.bundle = dataclasses.replace(
        eng.bundle, cfg=dataclasses.replace(eng.bundle.cfg, vision=VisionConfig()))
    with pytest.raises(ValueError, match=r"'image_embeds' must be \(1, 256, 896\)"):
        eng.serve(tokens, decode_steps=1, extras={"image_embeds": np.zeros(3)})


@pytest.mark.parametrize("arch,key", [("whisper-large-v3", "frames"),
                                      ("internvl2-1b", "image_embeds")])
def test_router_serves_extras_to_the_encoder_and_vision_families(tmp_path, arch, key):
    """``ServerlessRouter.invoke(..., extras=...)`` carries ``frames`` /
    ``image_embeds`` through the fleet pool to the engine: COLD then warm,
    with the tokens the engine gives when called directly."""
    router = ServerlessRouter(ttl_s=300.0, store=SnapshotStore(str(tmp_path)), device="cpu")
    router.register(FunctionDef("g", arch, max_seq=16, decode_steps=3))
    eng = InferenceEngine(arch, smoke=True, max_seq=16, store=None, device="cpu")
    eng.cold_start()
    shape = eng._prefill_batch_spec()[key][0]
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, eng.bundle.cfg.vocab_size, (1, 16)).astype(np.int32)
    extras = {key: rng.standard_normal(shape).astype(np.float32)}
    out1, r1 = router.invoke("g", tokens, extras=extras)
    out2, r2 = router.invoke("g", tokens, extras=extras)
    assert r1.cold and not r2.cold and out1.shape == (1, 3)
    np.testing.assert_array_equal(out1, out2)
    want, _ = eng.serve(tokens, decode_steps=3, extras=extras)
    np.testing.assert_array_equal(out1, want)


def test_engine_driver_serves_every_invocation(tmp_path, monkeypatch):
    """``calib/engine_paused`` on real SMOKE engines (CPU), 120x wall clock."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    sc = registry.get("calib/engine_paused")
    n = len(list(trun.build_trace(sc)))
    ev = EventLog()
    led = trun.run(sc, "engine", events=ev, device="cpu")
    assert len(led.records) == n > 0
    s = led.summary()
    assert s["requests"] == n and s["dropped"] == 0
    assert any(r.cold for r in led.records)
    assert validate_events(ev) == []
    assert os.path.isdir(tmp_path / "coldtorch_snapshots")


def test_engine_paths_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServerlessRouter(ttl_s=1.0, use_snapshots=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.run("engine_smoke", "engine")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineBackend(profiles={"f": EngineProfile(arch=ARCH)})


def test_serve_launcher_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "TMPDIR": str(tmp_path)}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--requests", "3", "--ttl", "0", "--gap", "0.1", "--seq", "16",
         "--decode-steps", "2", "--device", "cpu"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert sum(" COLD " in ln for ln in lines) == 3
    assert lines[-1].startswith("summary") and "cold%=100.00" in lines[-1]
    # the 2nd and 3rd requests restore: code_init is skipped
    assert all("code_init=0.0ms" in ln for ln in lines[1:3])
