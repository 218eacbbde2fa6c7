"""The port's own spans: the ``span`` kind of ``core/events.py``, emitted by
the router, the pool and the engine into one ``EventLog``.

SMOKE ``xlstm-125m`` on the CPU.  A cold invoke emits the named spans, each
inside its parent, the phase spans being the ``Breakdown``'s own readings; a
warm invoke emits none of the cold start's; the request loop emits one
``engine.decode_step`` and one ``engine.readback`` a step; the log passes
``validate_events``; ``normalize`` drops spans, so the sim-vs-fleet gate is
unchanged; and with no log the tokens are the same and nothing is kept.
The build check runs only on a card (``engine.build_check``,
``tests/test_torch_gpu.py``).
"""
import json

import numpy as np
import pytest

from repro_torch.analyze.reader import read_events
from repro_torch.core.events import (NO_SPAN, EventLog, diff_events, normalize, span,
                                     validate_events)
from repro_torch.core.lifecycle import STARTUP_PHASES
from repro_torch.experiments import cli
from repro_torch.serving.router import FunctionDef, ServerlessRouter

ARCH, SEQ, STEPS = "xlstm-125m", 16, 3
# each span of a cold invoke on the CPU, and the span it lies in
PARENT = {
    "router.place": "router.invoke",
    "pool.start_replica": "router.invoke",
    "engine.cold_start": "pool.start_replica",
    "engine.provision": "engine.cold_start",
    "engine.runtime_init": "engine.cold_start",
    "engine.deps_load": "engine.cold_start",
    "engine.code_init": "engine.cold_start",
    "engine.libraries": "engine.code_init",
    "engine.warmup": "engine.code_init",
    "router.serve": "router.invoke",
    "engine.h2d": "router.serve",
    "engine.prefill": "router.serve",
    "engine.readback": "router.serve",
    "engine.decode_step": "router.serve",
}
COLD_ONLY = {"pool.start_replica", "engine.cold_start", "engine.provision",
             "engine.runtime_init", "engine.deps_load", "engine.code_init",
             "engine.libraries", "engine.warmup"}


def _router(events, *, steps=STEPS, memory_gb=8.0, functions=("f",)):
    router = ServerlessRouter(ttl_s=300.0, use_snapshots=False, device="cpu",
                              memory_budget_gb=memory_gb, events=events)
    for name in functions:
        router.register(FunctionDef(name, ARCH, max_seq=SEQ, decode_steps=steps))
    return router


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 512, (1, SEQ)).astype(np.int32)


def _spans(events):
    return [e for e in events if e["kind"] == "span"]


@pytest.fixture(scope="module")
def served():
    """One log over a cold invoke then a warm one: (log, spans of each
    invoke, records, tokens)."""
    log = EventLog()
    router = _router(log)
    n0 = 0
    parts, recs, outs = [], [], []
    for _ in range(2):
        out, rec = router.invoke("f", _tokens())
        parts.append(_spans(log.events[n0:]))
        n0 = len(log)
        recs.append(rec)
        outs.append(out)
    return log, parts, recs, outs


def test_a_cold_invoke_emits_the_named_spans_each_inside_its_parent(served):
    _, (cold, _), _, _ = served
    names = {s["name"] for s in cold}
    assert names == set(PARENT) | {"router.invoke"}
    assert not names & {"request", "cold_start", "prefill", "decode"}
    by_name = {}
    for s in cold:
        by_name.setdefault(s["name"], []).append(s)
    for name, parent in PARENT.items():
        (p,) = by_name[parent]
        for s in by_name[name]:
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"], name
    place = by_name["router.place"][0]
    assert place["n"] == {"expired": 0, "evicted": 0}
    assert by_name["engine.deps_load"][0]["n"]["bytes"] > 0
    # siblings do not overlap: the phases follow each other
    phases = [by_name[f"engine.{p.value}"][0] for p in STARTUP_PHASES]
    for a, b in zip(phases, phases[1:]):
        assert a["end_ns"] <= b["start_ns"]


def test_the_phase_spans_are_the_breakdowns_readings(served):
    _, (cold, _), (rec, _), _ = served
    spans = {s["name"]: s for s in cold}
    assert {p.value for p in rec.startup.seconds} == {p.value for p in STARTUP_PHASES}
    for phase, seconds in rec.startup.seconds.items():
        s = spans[f"engine.{phase.value}"]
        assert (s["end_ns"] - s["start_ns"]) / 1e9 == seconds
    # the router's share and the engine's cold start make the record's wait
    router_s = (spans["router.serve"]["start_ns"] - spans["router.invoke"]["start_ns"]
                - (spans["engine.cold_start"]["end_ns"] - spans["engine.cold_start"]["start_ns"])
                ) / 1e9
    assert 0 <= router_s
    assert abs(router_s + (spans["engine.cold_start"]["end_ns"]
                           - spans["engine.cold_start"]["start_ns"]) / 1e9
               - (rec.start - rec.arrival)) < 1e-3


def test_a_warm_invoke_emits_no_cold_start_span(served):
    _, (_, warm), (_, rec), _ = served
    names = {s["name"] for s in warm}
    assert not rec.cold
    assert names == set(PARENT) - COLD_ONLY | {"router.invoke"}


@pytest.mark.parametrize("steps", [1, 4])
def test_one_decode_step_and_one_readback_a_step(steps):
    log = EventLog()
    out, _ = _router(log, steps=steps).invoke("f", _tokens())
    names = [s["name"] for s in _spans(log)]
    assert out.shape == (1, steps)
    assert names.count("engine.decode_step") == steps
    assert names.count("engine.readback") == steps
    assert names.count("engine.prefill") == 1 and names.count("engine.h2d") == 1


def test_the_log_is_valid_and_normalize_drops_the_spans(served):
    log = served[0]
    assert validate_events(log) == []
    kernel = [e for e in log if e["kind"] != "span"]
    assert {"spawn", "slot_bind", "exec_start", "exec_end", "idle"} <= {e["kind"] for e in kernel}
    assert [e["kind"] for e in normalize(log)] == [e["kind"] for e in normalize(kernel)]
    assert all(e["kind"] != "span" for e in normalize(log))
    assert diff_events(log, kernel).identical


def test_without_a_log_the_tokens_are_the_same_and_nothing_is_kept(served):
    _, _, _, (cold_out, warm_out) = served
    router = _router(None)
    got = [router.invoke("f", _tokens())[0] for _ in range(2)]
    np.testing.assert_array_equal(got[0], cold_out)
    np.testing.assert_array_equal(got[1], warm_out)
    assert router.events is None and router.pool.events is None
    assert router.backend.events is None
    assert router.pool.replica_for(0).engine.events is None
    assert span(None, "router.invoke") is NO_SPAN
    with span(None, "router.place", evicted=1) as sp:
        sp.count(expired=2)


def test_serve_stats_take_the_prefill_spans_reading():
    log = EventLog()
    router = _router(log)
    router.invoke("f", _tokens())
    engine = router.pool.replica_for(0).engine
    n0 = len(log)
    _, stats = engine.serve(_tokens(1), decode_steps=2)
    (prefill,) = [s for s in _spans(log.events[n0:]) if s["name"] == "engine.prefill"]
    assert stats.prefill_s == (prefill["end_ns"] - prefill["start_ns"]) / 1e9
    steps = [s for s in _spans(log.events[n0:]) if s["name"] in ("engine.readback",
                                                                 "engine.decode_step")]
    assert len(steps) == 4
    assert stats.decode_s >= sum(s["end_ns"] - s["start_ns"] for s in steps) / 1e9


def test_memory_pressure_logs_an_eviction():
    """A budget of one replica and two functions: the second function's
    cold start evicts the first, logged as ``evict`` and counted by
    ``router.place``; a TTL death stays ``expire``."""
    log = EventLog()
    router = _router(log, memory_gb=0.75, functions=("f", "g"))
    router.invoke("f", _tokens())
    _, rec = router.invoke("g", _tokens())
    assert rec.cold
    expires = [e for e in log if e["kind"] == "expire"]
    assert [(e["function"], e["reason"]) for e in expires] == [("f", "evict")]
    places = [s for s in _spans(log) if s["name"] == "router.place"]
    assert [p["n"] for p in places] == [{"expired": 0, "evicted": 0},
                                        {"expired": 0, "evicted": 1}]
    assert validate_events(log) == []
    # at ttl 0 the next invoke finds the replica's keep-alive over: expired
    log = EventLog()
    router = ServerlessRouter(ttl_s=0.0, use_snapshots=False, device="cpu", events=log)
    router.register(FunctionDef("f", ARCH, max_seq=SEQ, decode_steps=1))
    for _ in range(2):
        router.invoke("f", _tokens())
    assert [e["reason"] for e in log if e["kind"] == "expire"] == ["expire"]
    places = [s for s in _spans(log) if s["name"] == "router.place"]
    assert places[-1]["n"] == {"expired": 1, "evicted": 0}


@pytest.mark.parametrize("bad,problem", [
    ({"start_ns": 1.5}, "start_ns is not int"),
    ({"end_ns": True}, "end_ns is not int"),
    ({"start_ns": 10, "end_ns": 9}, "before start_ns"),
    ({"n": {"bytes": 1.0}}, "non-integer counter"),
    ({"n": [1]}, "n is not a dict"),
    ({"extra": 1}, "unexpected fields"),
])
def test_validate_refuses_a_malformed_span(bad, problem):
    ev = {"t": 0.0, "kind": "span", "name": "engine.prefill", "start_ns": 1, "end_ns": 2}
    assert validate_events([ev, {**ev, "n": {"bytes": 3}}]) == []
    problems = validate_events([{**ev, **bad}])
    assert len(problems) == 1 and problem in problems[0]


def test_a_span_takes_the_logs_last_t():
    log = EventLog()
    log.span("a", 1, 2)
    log.arrival(3.5, "f")
    with span(log, "b", k=1) as sp:
        sp.count(j=2)
    assert [e["t"] for e in log] == [0.0, 3.5, 3.5]
    assert log.events[-1]["n"] == {"k": 1, "j": 2}
    assert validate_events(log) == []


def test_an_engine_driver_run_writes_its_spans_to_the_events_file(tmp_path, monkeypatch):
    """``python -m repro_torch.experiments run engine_smoke --driver engine
    --events PATH``: the file carries the pool's and engines' spans and
    passes the analyze reader's validation."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    path = tmp_path / "events.jsonl"
    assert cli.main(["run", "engine_smoke", "--driver", "engine", "--device", "cpu",
                     "--events", str(path)]) == 0
    log = read_events(str(path))
    assert json.loads(path.read_text().splitlines()[0])["version"] == 3
    names = {e["name"] for e in log if e["kind"] == "span"}
    assert {"pool.start_replica", "engine.cold_start", "engine.deps_load",
            "engine.prefill", "engine.decode_step", "engine.readback"} <= names
    assert sum(e.get("name") == "engine.cold_start" for e in log) >= 1
