"""Declarative Scenario spec — one taxonomy cell as data.

A :class:`Scenario` names everything a run needs — workload generator,
cluster shape, platform/cost-model profile, policy suite, SLO, seed — and
nothing about *how* to run it: the same spec replays through the
discrete-event simulator, the concurrent fleet, or the real-engine backend
(``repro.experiments.runner.run(scenario, driver=...)``) and yields
comparable :class:`~repro.core.metrics.QoSLedger`\\ s.

Every field is plain data (``to_dict``/``from_dict`` round-trip through
JSON), so scenarios can be registered, swept, diffed, and shipped to the
CLI without benchmark-local glue.

Seeds flow from ONE place: ``Scenario.seed`` is the master seed, and
``seed_for(component)`` derives stable per-component streams (trace
generation, load-generator jitter, policy RNG), so two runs of the same
scenario are bit-identical and no benchmark hand-picks divergent seeds.
A :class:`WorkloadSpec` may still pin an explicit trace seed — that is how
ported benchmarks keep their historical traces (and tuned acceptance
gates) stable.
"""
from __future__ import annotations

import dataclasses
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union


def derive_seed(master: int, component: str) -> int:
    """Stable per-component seed from one master seed.

    CRC32 over ``"master:component"`` — deterministic across processes,
    platforms, and Python hash randomization (unlike ``hash()``).
    """
    return zlib.crc32(f"{master}:{component}".encode()) & 0x7FFFFFFF


# --------------------------------------------------------------------------- #
# workload
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class WorkloadSpec:
    """One trace-generator call as data: ``generator(**params, seed=...)``.

    ``seed=None`` (the default) derives the trace seed from the scenario's
    master seed; an explicit value pins the historical trace.
    """

    generator: str
    params: Mapping[str, Any] = field(default_factory=dict)
    seed: Optional[int] = None
    name: Optional[str] = None          # display label (defaults to generator)
    # QoS classes as arrival weights (faas-offloading-sim idiom): each
    # invocation is assigned a class with probability proportional to its
    # weight — deterministically, via repro.topology.qos.assign_class on
    # the scenario's derived "qos_class" seed.  Empty = single "default"
    # class.  Only topology runs route on classes, but per-class ledger
    # breakdowns work for any scenario that declares them.
    qos_classes: Mapping[str, float] = field(default_factory=dict)

    @property
    def label(self) -> str:
        return self.name or self.generator

    def build(self, master_seed: int):
        from repro_torch.core.workload import ALL_GENERATORS
        if self.generator not in ALL_GENERATORS:
            raise ValueError(
                f"unknown workload generator {self.generator!r}; "
                f"known: {', '.join(sorted(ALL_GENERATORS))}")
        seed = self.seed if self.seed is not None \
            else derive_seed(master_seed, f"trace:{self.label}")
        return ALL_GENERATORS[self.generator](**dict(self.params), seed=seed)

    def to_dict(self) -> Dict[str, Any]:
        return {"generator": self.generator, "params": dict(self.params),
                "seed": self.seed, "name": self.name,
                "qos_classes": dict(self.qos_classes)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "WorkloadSpec":
        return cls(generator=d["generator"], params=dict(d.get("params", {})),
                   seed=d.get("seed"), name=d.get("name"),
                   qos_classes=dict(d.get("qos_classes", {})))


# --------------------------------------------------------------------------- #
# cluster shape
# --------------------------------------------------------------------------- #
def _maybe_tuple(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


@dataclass(frozen=True)
class ClusterSpec:
    """Cluster shape shared by ``SimConfig`` and ``FleetConfig``; the
    fleet-only levers (slots, batching, admission SLO) are ignored by the
    simulator driver."""

    num_workers: int = 4
    # scalar = homogeneous; tuple = per-worker (heterogeneous cluster)
    worker_memory_mb: Union[float, Tuple[float, ...]] = 16_384.0
    worker_speed: Union[float, Tuple[float, ...]] = 1.0
    slots_per_replica: int = 1          # fleet: concurrent executions/replica
    max_batch: int = 1                  # fleet: micro-batch size cap
    admission_slo_s: Optional[float] = None   # fleet: admission-control SLO

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ClusterSpec":
        d = dict(d)
        for k in ("worker_memory_mb", "worker_speed"):
            if k in d:
                d[k] = _maybe_tuple(d[k])
        return cls(**d)


# --------------------------------------------------------------------------- #
# real-engine profile (driver="engine")
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class EngineSpec:
    """How the real-engine driver materialises each function: one reduced
    JAX model endpoint per function, on a scaled wall clock."""

    arch: str = "xlstm-125m"
    max_seq: int = 16
    batch: int = 1
    decode_steps: int = 2
    clock_speed: float = 60.0           # wall-clock scale factor
    snapshots: bool = True              # SnapshotStore-backed restores

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "EngineSpec":
        return cls(**dict(d))


# --------------------------------------------------------------------------- #
# the scenario
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class Scenario:
    """One cell of the taxonomy grid: trace x policy x platform x shape."""

    name: str
    workload: WorkloadSpec
    policy: str = "provider_default"    # PolicySuite name from the catalog,
                                        # or "platform_default" (FixedTTL at
                                        # the platform's keep-alive)
    keepalive_ttl: Optional[float] = None   # override: FixedTTL(ttl) slot-in
    platform: Optional[str] = None      # costmodel.PLATFORM_PROFILES key
    cluster: ClusterSpec = field(default_factory=ClusterSpec)
    engine: EngineSpec = field(default_factory=EngineSpec)
    slo_latency_s: Optional[float] = None   # summary() SLA threshold
    calibrated: bool = False            # pick up ./calibration.json if present
    seed: int = 0
    description: str = ""
    # edge–cloud topology axis (repro.topology): node tiers + network +
    # offloading policy.  None = the flat single-cluster scenario every
    # driver supports; set = sim/fleet route each arrival through the
    # offloading decision to one cluster kernel per node.  Typed as Any
    # to keep this module import-light (the real type is
    # repro.topology.spec.TopologySpec, which imports ClusterSpec from
    # here — serialization imports it lazily).
    topology: Optional[Any] = None

    # ---- seeds -------------------------------------------------------- #
    def seed_for(self, component: str) -> int:
        return derive_seed(self.seed, component)

    # ---- builders (the plumbing benchmarks used to hand-assemble) ----- #
    def trace(self):
        return self.workload.build(self.seed)

    def suite(self):
        from repro_torch.core.policies import suite as make_suite
        from repro_torch.core.policies.base import PolicySuite
        from repro_torch.core.policies.keepalive import FixedTTL
        if self.policy == "platform_default":
            if not self.platform:
                raise ValueError(
                    f"scenario {self.name!r}: policy 'platform_default' "
                    "needs a platform")
            from repro_torch.core.costmodel import platform_keep_alive
            s = PolicySuite(
                name=self.platform,
                keepalive=FixedTTL(platform_keep_alive(self.platform)))
        else:
            s = make_suite(self.policy)
        if self.keepalive_ttl is not None:
            s.keepalive = FixedTTL(self.keepalive_ttl)
        return s

    def cost_model(self):
        import os

        from repro_torch.core.costmodel import CostModel, platform_cost_model
        if self.platform:
            return platform_cost_model(self.platform)
        if self.calibrated and os.path.exists("calibration.json"):
            return CostModel.from_calibration("calibration.json")
        return CostModel()

    def sim_config(self):
        from repro_torch.core.simulator import SimConfig
        return SimConfig(num_workers=self.cluster.num_workers,
                         worker_memory_mb=self.cluster.worker_memory_mb,
                         worker_speed=self.cluster.worker_speed)

    def fleet_config(self):
        from repro_torch.experiments.runner import not_ported
        raise NotImplementedError(not_ported("fleet"))

    # ---- overrides (sweep machinery) ---------------------------------- #
    def with_overrides(self, overrides: Mapping[str, Any]) -> "Scenario":
        """Copy with dotted-path field overrides, e.g.
        ``{"policy": "lcs", "cluster.num_workers": 8,
        "workload.params.num_functions": 50}``."""
        sc = self
        for path, value in overrides.items():
            sc = _replace_path(sc, path.split("."), value)
        return sc

    # ---- serialization ------------------------------------------------- #
    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "workload": self.workload.to_dict(),
            "policy": self.policy,
            "keepalive_ttl": self.keepalive_ttl,
            "platform": self.platform,
            "cluster": self.cluster.to_dict(),
            "engine": self.engine.to_dict(),
            "slo_latency_s": self.slo_latency_s,
            "calibrated": self.calibrated,
            "seed": self.seed,
            "description": self.description,
            "topology": (None if self.topology is None
                         else self.topology.to_dict()),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Scenario":
        d = dict(d)
        d["workload"] = WorkloadSpec.from_dict(d["workload"])
        d["cluster"] = ClusterSpec.from_dict(d.get("cluster", {}))
        d["engine"] = EngineSpec.from_dict(d.get("engine", {}))
        if d.get("topology") is not None:
            from repro_torch.topology.spec import TopologySpec
            d["topology"] = TopologySpec.from_dict(d["topology"])
        return cls(**d)


def _replace_path(obj, parts: Sequence[str], value):
    """Functional deep-replace along a dotted path through frozen
    dataclasses, plain dicts, and tuples/lists (numeric index), e.g.
    ``topology.nodes.0.cluster.num_workers`` or
    ``topology.network.rtt_s.cloud|edge``."""
    head = parts[0]
    if dataclasses.is_dataclass(obj):
        names = {f.name for f in dataclasses.fields(obj)}
        if head not in names:
            raise AttributeError(
                f"{type(obj).__name__} has no field {head!r} "
                f"(known: {', '.join(sorted(names))})")
        new = value if len(parts) == 1 \
            else _replace_path(getattr(obj, head), parts[1:], value)
        return dataclasses.replace(obj, **{head: new})
    if isinstance(obj, Mapping):
        d = dict(obj)
        d[head] = value if len(parts) == 1 \
            else _replace_path(d[head], parts[1:], value)
        return d
    if isinstance(obj, (tuple, list)) and head.lstrip("-").isdigit():
        idx = int(head)
        items = list(obj)
        items[idx] = value if len(parts) == 1 \
            else _replace_path(items[idx], parts[1:], value)
        return tuple(items) if isinstance(obj, tuple) else items
    raise TypeError(f"cannot descend into {type(obj).__name__} at {head!r}")
