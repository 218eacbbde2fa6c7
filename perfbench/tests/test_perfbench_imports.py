"""The benchmark stands alone: importing every module of ``perfbench`` and
the program's modules it drives loads neither ``jax`` nor any ``repro``
module (top-level names compared whole: ``repro_torch`` passes), and a new
cell is added as files and entries alone."""
import json
import os
import shutil
import subprocess
import sys

from _harness import PERFBENCH, ROOT

_IMPORT_ALL = r"""
import importlib, importlib.util, json, pathlib, sys
here = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(here), str(here.parent / "src")]
names = []
for path in sorted((here / "benchlib").glob("*.py")):
    names.append("benchlib." + path.stem if path.stem != "__init__" else "benchlib")
    importlib.import_module(names[-1])
for path in sorted((here / "metrics").glob("*.py")) + [here / "run.py",
                                                      here / "tools" / "readings.py"]:
    spec = importlib.util.spec_from_file_location("m_" + path.stem.replace(".", "_"), path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names.append(str(path.relative_to(here)))
for name in ("repro_torch.serving.router", "repro_torch.serving.engine",
             "repro_torch.fleet.pool", "repro_torch.models.registry"):
    importlib.import_module(name)
foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro"))
print(json.dumps({"modules": names, "foreign": foreign,
                  "port": "repro_torch" in sys.modules}))
"""


def test_importing_every_benchmark_module_loads_no_jax_and_no_repro():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL, str(PERFBENCH)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["foreign"] == [] and got["port"]
    assert "run.py" in got["modules"] and "benchlib.run" in got["modules"]


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A copy of the benchmark gains a traffic mix, a cell and a per-layer
    metric as new files and new entries, and the tenants-zipf cell, whose
    mix and readers are kept, by entries alone; the copy's harness runs
    both."""
    shutil.copytree(PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((PERFBENCH / "traffic" / "docs-b80.json").read_text())
    mix["smoke"]["prompt_len"] = 16
    (tmp_path / "perfbench" / "traffic" / "extra.json").write_text(json.dumps(mix))
    (tmp_path / "perfbench" / "metrics" / "invokes.extra.py").write_text(
        "def read(run):\n    return float(len(run.served))\n")
    bench["workloads"].append({"name": "granite-3-2b.extra", "config": "granite-3-2b",
                               "traffic": "extra", "chips": 1, "why": "a test's extra mix"})
    bench["per_layer"].append({"name": "invokes.extra", "unit": "invokes", "better": "higher",
                               "source": "host_clock", "layer": "router and fleet",
                               "moves": "tokens_per_s", "workloads": ["granite-3-2b.extra"]})
    tenants = "granite-3-2b.tenants-zipf"
    for m in bench["end_to_end"]:
        if m["name"] == "tokens_per_s":
            m["workloads"].append("granite-3-2b.extra")
        if m["name"] == "cold_start_ms":
            m["workloads"].append(tenants)
    bench["end_to_end"].append({"name": "latency_p90_ms", "unit": "ms", "better": "lower",
                                "bound": 0.25, "source": "host_clock", "workloads": [tenants]})
    bench["workloads"].append({"name": tenants, "config": "granite-3-2b",
                               "traffic": "tenants-zipf", "chips": 1, "why": "kept mix"})
    for name in ("cold_share.tenants", "restore_gbps.tenants"):
        bench["per_layer"].append({"name": name, "unit": "%", "better": "lower",
                                   "source": "program_counter", "layer": "router and fleet",
                                   "moves": "cold_start_ms", "workloads": [tenants]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    lines = {}
    for cell, trace in (("granite-3-2b.extra", "0"), ("granite-3-2b.extra", "1"),
                        (tenants, "0"), (tenants, "1")):
        proc = subprocess.run(
            [sys.executable, str(tmp_path / "perfbench" / "run.py"), "--workload", cell,
             "--seed", "9", "--seconds", "1", "--trace", trace, "--device", "cpu", "--smoke"],
            cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        lines[cell, trace] = json.loads(proc.stdout.strip().splitlines()[-1])
    assert all(line["correct"] is True for line in lines.values())
    assert set(lines["granite-3-2b.extra", "0"]["metrics"]) == {"tokens_per_s", "setup_s"}
    assert lines["granite-3-2b.extra", "1"]["metrics"]["invokes.extra"]["value"] >= 1
    assert set(lines[tenants, "0"]["metrics"]) == {"cold_start_ms", "latency_p90_ms", "setup_s"}
    # the restores' rate is read from cold starts after the stretch, which a
    # second's window on the CPU may not hold
    assert "cold_share.tenants" in lines[tenants, "1"]["metrics"]
    assert set(lines[tenants, "1"]["metrics"]) <= {"cold_share.tenants", "restore_gbps.tenants"}
