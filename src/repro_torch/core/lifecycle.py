"""Cold-start anatomy (paper Fig. 10) — phases, container FSM.

The paper decomposes a cold start into: provisioning → runtime init →
dependency load → code deploy/init → execute, with a keep-warm window τ and
scale-to-zero afterwards.  In the PyTorch port (a copy of
``repro.core.lifecycle``) the phases map to: CUDA context creation, model
construction, weight materialisation or snapshot load onto the device,
kernel-library load + warm-up calls, and the request itself.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Dict, Optional


class Phase(str, enum.Enum):
    PROVISION = "provision"          # container / device-slice allocation
    RUNTIME_INIT = "runtime_init"    # language runtime / JAX import + trace
    DEPS_LOAD = "deps_load"          # package / weights -> device
    CODE_INIT = "code_init"          # function init / XLA compile
    EXECUTE = "execute"


STARTUP_PHASES = (Phase.PROVISION, Phase.RUNTIME_INIT, Phase.DEPS_LOAD,
                  Phase.CODE_INIT)


class ContainerState(str, enum.Enum):
    PROVISIONING = "provisioning"
    WARM_IDLE = "warm_idle"          # ready; clock to scale-to-zero running
    ACTIVE = "active"                # executing a request
    PAUSED = "paused"                # cgroup-frozen: everything resident, no CPU
    SNAPSHOT_READY = "snapshot_ready"  # memory image written; tiny RAM residue
    DEAD = "dead"


class WarmthTier(enum.IntEnum):
    """The graded container-warmth ladder (§5's CSL spectrum as one axis).

    Ordering is meaningful: a higher tier is warmer — cheaper to promote to
    serving, more expensive to keep resident.  ``DEAD`` and ``IMG_CACHED``
    are *function-level* spawn tiers (no container object backs them: the
    image cache / snapshot file lives on the cluster, not in a cgroup);
    ``SNAPSHOT_READY``, ``PAUSED``, and ``WARM_IDLE`` are container-resident
    tiers, mirrored 1:1 by :class:`ContainerState` values.
    """

    DEAD = 0              # nothing resident: full cold start
    IMG_CACHED = 1        # container image pulled: provisioning shortened
    SNAPSHOT_READY = 2    # memory image on local disk: restore, not rebuild
    PAUSED = 3            # frozen cgroup: runtime+weights+code resident
    WARM_IDLE = 4         # live container: promote cost zero


# resident idle tiers and their ContainerState twins, warmest first
RESIDENT_TIERS = (WarmthTier.WARM_IDLE, WarmthTier.PAUSED,
                  WarmthTier.SNAPSHOT_READY)
TIER_TO_STATE = {
    WarmthTier.WARM_IDLE: ContainerState.WARM_IDLE,
    WarmthTier.PAUSED: ContainerState.PAUSED,
    WarmthTier.SNAPSHOT_READY: ContainerState.SNAPSHOT_READY,
}
STATE_TO_TIER = {v: k for k, v in TIER_TO_STATE.items()}
RESIDENT_IDLE_STATES = tuple(TIER_TO_STATE.values())


@dataclass
class Breakdown:
    """Per-phase seconds of one startup."""

    seconds: Dict[Phase, float] = field(default_factory=dict)

    @property
    def total(self) -> float:
        return sum(self.seconds.values())

    def scaled(self, factors: Dict[Phase, float]) -> "Breakdown":
        return Breakdown({p: s * factors.get(p, 1.0)
                          for p, s in self.seconds.items()})

    def drop(self, *phases: Phase) -> "Breakdown":
        return Breakdown({p: s for p, s in self.seconds.items()
                          if p not in phases})

    def replace(self, phase: Phase, seconds: float) -> "Breakdown":
        d = dict(self.seconds)
        d[phase] = seconds
        return Breakdown(d)

    def __repr__(self):
        parts = ", ".join(f"{p.value}={s * 1e3:.1f}ms"
                          for p, s in self.seconds.items())
        return f"Breakdown({parts}, total={self.total * 1e3:.1f}ms)"


@dataclass
class FunctionSpec:
    """A deployable 'serverless function' = one model endpoint."""

    name: str
    package_mb: float                 # weights + code bytes (RQ2 factor)
    memory_mb: float                  # container RAM allocation (RQ2 factor)
    runtime: str = "python-jit"       # python-eager | python-jit | aot (RQ2)
    exec_time_s: float = 0.05         # mean warm execution time
    arch: Optional[str] = None        # backing model architecture id
    compile_cost: float = 1.0         # relative XLA compile complexity
    chain: Optional[tuple] = None     # names of chained successor functions
    sla_latency_s: Optional[float] = None
    container_concurrency: int = 1    # Knative-style in-flight cap per
                                      # container (1 = Lambda semantics)


@dataclass
class Container:
    id: int
    function: Optional[str]           # None while in a generic pause-pool
    state: ContainerState
    worker: int
    memory_mb: float
    created_at: float
    warm_since: float = 0.0           # start of the current idle-tier dwell
    last_used: float = 0.0
    uses: int = 0
    expiry: float = float("inf")      # next armed tier transition (policy-set)
    has_snapshot: bool = False
    sanitized: bool = True            # paper §6.6: state cleared on reuse
    concurrency: int = 1              # simultaneous executions admitted
    inflight: int = 0                 # executions currently on this container
    resident_mb: float = 0.0          # billed footprint at the current tier
                                      # (kernel-maintained; == memory_mb
                                      # outside the demoted idle tiers)

    @property
    def tier(self) -> Optional[WarmthTier]:
        """The warmth tier while idle-resident, else None (busy/dead)."""
        return STATE_TO_TIER.get(self.state)

    def is_reusable(self, function: str) -> bool:
        return (self.state == ContainerState.WARM_IDLE
                and self.function == function)
