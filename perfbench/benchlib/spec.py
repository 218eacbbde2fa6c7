"""``BENCHMARK.json`` and the files it names, each found by name.

A cell (an entry of ``workloads``) names a configuration, whose file is given
in ``configs``, and a traffic mix, read from ``traffic/<mix>.json`` beside
this package.  Every metric, end to end or per layer, is a reader in
``metrics/<name>.py`` (or in the file its name's first part names) with a
``read(run)`` function: a later cell, configuration or metric is added as
files and entries, without an edit.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parents[1]        # the benchmark's folder
ROOT = HERE.parent                                 # the checkout's root


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable[[Any], Optional[float]]


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]        # the configuration file, as it is run
    traffic: Dict[str, Any]       # the traffic mix's parameters
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


def _overlay(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    """``base`` with ``over``'s keys put in; a dict value is overlaid one
    level deep (``arrivals``, ``router``, ...)."""
    out = dict(base)
    for key, value in over.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = {**out[key], **value}
        else:
            out[key] = value
    return out


def _reader(name: str) -> Callable[[Any], Optional[float]]:
    """The reader ``metrics/<name>.py``, or else the one its name's first
    part names (``idle_share.py`` for ``idle_share.warm``), so that the
    cells' shares of one quantity share a reader."""
    paths = [HERE / "metrics" / f"{name}.py", HERE / "metrics" / f"{name.split('.')[0]}.py"]
    path = next((p for p in paths if p.is_file()), None)
    if path is None:
        raise FileNotFoundError(f"metric {name!r} has no reader at {paths[0]} or {paths[1]}")
    module_name = "perfbench_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _metrics(entries, cell: str) -> List[Metric]:
    return [Metric(m["name"], m["unit"], _reader(m["name"]))
            for m in entries if cell in m.get("workloads", [cell])]


def load_cell(name: str, *, smoke: bool = False) -> Cell:
    """The cell ``name`` with its configuration, traffic and metric readers.
    ``smoke`` overlays each file's ``smoke`` block: the program's SMOKE
    configuration and a CPU-sized mix, for the tests."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    work = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[work["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{work['traffic']}.json").read_text())
    if smoke:
        config = _overlay(config, config.get("smoke", {}))
        traffic = _overlay(traffic, traffic.get("smoke", {}))
    return Cell(name=name, chips=work["chips"], config=config, traffic=traffic,
                end_to_end=_metrics(bench["end_to_end"], name),
                per_layer=_metrics(bench["per_layer"], name))
