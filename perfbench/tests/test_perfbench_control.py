"""The control: the reference in fp8 put in the program's place must come
out as not correct.  At SMOKE size on the CPU the program's tokens read a
gap of 0 and the control's read above the cell's limit; on a card the same
readings at the cell's own size, over three seeds (``tools/readings.py``)."""
import json
import os
import subprocess
import sys

import pytest

from _harness import CELLS, PERFBENCH, ROOT, cuda  # noqa: F401


def _readings(cell, seeds, seconds, *extra):
    proc = subprocess.run(
        [sys.executable, str(PERFBENCH / "tools" / "readings.py"), "--workload", cell,
         "--seeds", ",".join(map(str, seeds)), "--seconds", str(seconds), *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=3000,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    return [json.loads(ln) for ln in proc.stdout.strip().splitlines() if ln.startswith("{")]


def test_control_fails_at_smoke_size():
    from benchlib import spec

    cell = "granite-3-2b.docs-b80"
    limit = spec.load_cell(cell, smoke=True).traffic["check"]["logit_gap_limit"]
    for r in _readings(cell, [2**31 + 5, 17], 0.5, "--device", "cpu", "--smoke"):
        assert r["program_gap"] <= limit < r["control_gap"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cuda, cell):
    from benchlib import spec

    limit = spec.load_cell(cell).traffic["check"]["logit_gap_limit"]
    for r in _readings(cell, [2**31 + 21, 2**31 + 22, 2**31 + 23], 12):
        assert r["program_gap"] <= limit < r["control_gap"]
