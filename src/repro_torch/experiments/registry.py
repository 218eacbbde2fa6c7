"""Named Scenario / Sweep registry with did-you-mean lookup errors.

The registry is the single vocabulary shared by benchmarks, examples, the
CLI, and CI: a benchmark that needs a taxonomy cell looks it up here
instead of hand-assembling trace + suite + config, so two call sites can
never drift apart on seeds or cluster shape.
"""
from __future__ import annotations

import difflib
from typing import Dict, Iterable, List, Union

from repro_torch.experiments.spec import Scenario
from repro_torch.experiments.sweep import Sweep

_SCENARIOS: Dict[str, Scenario] = {}
_SWEEPS: Dict[str, Sweep] = {}


class UnknownScenarioError(LookupError):
    """Raised for unregistered names; carries a did-you-mean suggestion."""


def _lookup(table: Dict[str, object], name: str, kind: str):
    try:
        return table[name]
    except KeyError:
        close = difflib.get_close_matches(name, table, n=3, cutoff=0.4)
        hint = f"; did you mean {', '.join(repr(c) for c in close)}?" \
            if close else ""
        raise UnknownScenarioError(
            f"unknown {kind} {name!r}{hint} "
            f"(see `python -m repro.experiments list`)") from None


def register(scenario: Scenario) -> Scenario:
    """Register (or replace) a named scenario; returns it for chaining."""
    _SCENARIOS[scenario.name] = scenario
    return scenario


def register_sweep(sweep: Sweep) -> Sweep:
    _SWEEPS[sweep.name] = sweep
    return sweep


def get(name: str) -> Scenario:
    return _lookup(_SCENARIOS, name, "scenario")


def get_sweep(name: str) -> Sweep:
    return _lookup(_SWEEPS, name, "sweep")


def names() -> List[str]:
    return sorted(_SCENARIOS)


def sweep_names() -> List[str]:
    return sorted(_SWEEPS)


def resolve(spec: Union[str, Scenario]) -> Scenario:
    return get(spec) if isinstance(spec, str) else spec


def resolve_sweep(spec: Union[str, Sweep]) -> Sweep:
    return get_sweep(spec) if isinstance(spec, str) else spec
