"""The port stands alone: importing all of ``repro_torch`` loads neither
``jax`` nor any ``repro`` module, and its entry points refuse to run on a
missing card unless the caller asks for the CPU.

The import check runs in a subprocess because this test process has JAX
loaded already (other test files import it).
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
foreign = sorted(m for m in sys.modules
                 if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(json.dumps({"modules": names, "foreign": foreign}))
"""


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=ENV, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["foreign"] == []
    for name in ("repro_torch.config", "repro_torch.configs.granite3_2b",
                 "repro_torch.core.lifecycle", "repro_torch.kernels.ops",
                 "repro_torch.kernels._build", "repro_torch.models.convert",
                 "repro_torch.models.registry", "repro_torch.serving.engine",
                 # the batch sweep driver's slice
                 "repro_torch.kernels.ref", "repro_torch.kernels.cluster_step",
                 "repro_torch.core.batchsim", "repro_torch.core.simulator",
                 "repro_torch.core.cluster", "repro_torch.core.workload",
                 "repro_torch.core.metrics", "repro_torch.core.costmodel",
                 "repro_torch.core.events", "repro_torch.core.predictors.rl",
                 "repro_torch.core.policies.fusion",
                 "repro_torch.core.policies.scheduling",
                 "repro_torch.experiments.catalog", "repro_torch.experiments.cli",
                 "repro_torch.experiments.__main__", "repro_torch.topology.spec"):
        assert name in got["modules"]


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch.models import registry
    from repro_torch.serving.engine import InferenceEngine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine("granite-3-2b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.build_arch("granite-3-2b", smoke=True)


def test_batch_driver_raises_without_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch.core.batchsim import simulate_batch
    from repro_torch.experiments import cli, registry, runner
    cells = registry.get_sweep("batch_grid64").scenarios()[:2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_batch(cells)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        list(runner.run_sweep("batch_grid64", driver="batch"))
    argv = ["sweep", "calib/tiered_fixed", "--axis", "keepalive_ttl=30",
            "--driver", "batch"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    assert len(simulate_batch(cells, device="cpu")) == 2
    assert cli.main(argv + ["--device", "cpu", "--json", str(tmp_path / "o.json")]) == 0


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=ENV,
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
