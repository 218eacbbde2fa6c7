"""The rest of a run with the timed path broken underneath: ``correct``
comes out false for every fault a served cell can have.  A token altered
where it is produced (each row's last served token), and, where a batch
holds several rows, half of the batch left out (its rows given the first
half's tokens).  A step that returns its state unchanged cannot be planted
here: the engine's decode already drops the state it would write, as its
cache holds the prompt alone.  No cell exchanges anything between chips."""
import numpy as np
import pytest

from _harness import CELLS, run_smoke


def _altered(out, vocab):
    out = out.copy()
    out[:, -1] = (out[:, -1] + 1) % vocab
    return out


def _half_left_out(out, vocab):
    out = out.copy()
    half = out.shape[0] // 2
    out[half:] = out[:half][: out.shape[0] - half]
    return out


FAULTS = {"altered_token": _altered, "half_batch_left_out": _half_left_out}


def _cases():
    from benchlib import spec

    for cell in CELLS:
        batch = spec.load_cell(cell, smoke=True).traffic["batch"]
        for fault in FAULTS:
            if fault == "half_batch_left_out" and batch < 2:
                continue
            yield cell, fault


@pytest.mark.parametrize("cell,fault", list(_cases()))
def test_fault_makes_the_run_incorrect(capsys, monkeypatch, cell, fault):
    from repro_torch.serving import engine

    generate = engine.generate

    def broken(bundle, params, tokens, **kw):
        out, stats = generate(bundle, params, tokens, **kw)
        return FAULTS[fault](np.asarray(out), bundle.cfg.vocab_size), stats

    monkeypatch.setattr(engine, "generate", broken)
    line = run_smoke(capsys, monkeypatch, cell)
    assert line["correct"] is False
    gap = line["checks"]["logit_gap"]
    assert gap["value"] > gap["limit"]
