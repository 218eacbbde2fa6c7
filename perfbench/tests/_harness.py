"""Shared by the benchmark's tests: run the harness in this process on the
CPU at SMOKE size and return its result line."""
import json
import sys
import time
from pathlib import Path

import pytest
import torch

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent
for p in (str(PERFBENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def run_smoke(capsys, monkeypatch, cell: str, *, seed: int = 2**31 + 11,
              seconds: float = 1.0, trace: int = 0) -> dict:
    """The harness's last line.  A test process may hold JAX already (other
    test files import it): the run's check for foreign modules is held to
    what the run itself loads."""
    from benchlib import run

    real = run.foreign_modules
    preloaded = set(real())
    monkeypatch.setattr(run, "foreign_modules",
                        lambda: [m for m in real() if m not in preloaded])
    threads = torch.get_num_threads()
    try:
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace), "--device", "cpu", "--smoke"],
                      t_start=time.perf_counter())
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run the hand kernels at full width")
    return torch.device("cuda")
