"""Sweep grids — cartesian products over any Scenario axis.

A :class:`Sweep` is a base :class:`~repro.experiments.spec.Scenario` plus
ordered axes; ``scenarios()`` expands the full cartesian product, naming
each cell ``base/axis1-label/axis2-label/...``.  Axis values are either

  * a plain value for the axis' dotted field path
    (``{"policy": ("lcs", "faascache")}``), or a
    :class:`~repro.experiments.spec.WorkloadSpec` for the ``workload``
    axis, or
  * an :class:`AxisValue` — a label plus a multi-field override, for
    cells that move several fields together (e.g. a policy name *and* a
    keep-alive TTL).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.experiments.spec import Scenario, WorkloadSpec


@dataclass(frozen=True)
class AxisValue:
    """One labelled grid point that may override several scenario fields."""

    label: str
    overrides: Mapping[str, Any]


def _label(value) -> str:
    if isinstance(value, AxisValue):
        return value.label
    if isinstance(value, WorkloadSpec):
        return value.label
    return str(value)


@dataclass(frozen=True)
class Sweep:
    """Cartesian product over scenario axes (dict insertion order)."""

    name: str
    base: Scenario
    axes: Mapping[str, Sequence[Any]]
    driver: str = "sim"
    description: str = ""

    def scenarios(self) -> List[Scenario]:
        keys = list(self.axes)
        out: List[Scenario] = []
        for combo in itertools.product(*(self.axes[k] for k in keys)):
            sc = self.base
            labels = []
            for key, value in zip(keys, combo):
                if isinstance(value, AxisValue):
                    sc = sc.with_overrides(value.overrides)
                else:
                    sc = sc.with_overrides({key: value})
                labels.append(_label(value))
            out.append(sc.with_overrides(
                {"name": "/".join([self.base.name, *labels])}))
        return out

    def __len__(self) -> int:
        n = 1
        for vals in self.axes.values():
            n *= len(vals)
        return n
