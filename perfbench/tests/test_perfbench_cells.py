"""Every cell of ``BENCHMARK.json`` runs for a second at SMOKE size on the
CPU (the kernels' plain versions) and prints a last line that meets the
benchmark's contract; a traced run carries its device keys and breakdown;
without a card the harness refuses to run and prints nothing."""
import subprocess
import sys

import pytest

from _harness import CELLS, PERFBENCH, ROOT, run_smoke

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_prints_a_contract_line(capsys, monkeypatch, cell):
    from benchlib import spec

    line = run_smoke(capsys, monkeypatch, cell)
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    want = {m.name for m in spec.load_cell(cell).end_to_end}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert line["checks"]["logit_gap"]["value"] <= line["checks"]["logit_gap"]["limit"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


def test_traced_run_reports_device_and_breakdown(capsys, monkeypatch):
    """The stretch closes in the wait before the second burst, whose cold
    start is read untraced."""
    line = run_smoke(capsys, monkeypatch, "starcoder2-15b.cold-bursts", trace=1, seconds=2.5)
    assert line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"]) and line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # a CPU run has no device: no device metric is read from it
    assert set(line["metrics"]) == {"code_init_ms.cold"}
    assert list(line)[-1] == "checks"


def test_without_a_card_it_refuses_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(PERFBENCH / "run.py"), "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
