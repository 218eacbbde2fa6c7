"""Calibrated cold-start cost model — RQ2 factors in, per-phase seconds out.

The survey's RQ2 identifies the factors that move cold-start latency:
platform/runtime, deployment-package size, resource (RAM/CPU) allocation,
dependencies, programming language, and concurrency.  This model makes each
an explicit input:

  provision      base + per-MB-of-RAM term (container/slice allocation)
  runtime_init   per-runtime constant (eager python > jit trace > AOT stub)
  deps_load      package_mb / effective_bandwidth(memory_mb)   [RQ2: RAM ↑ ⇒
                 cold start ↓ — CPU/bw scales with RAM on real platforms]
  code_init      compile_base * compile_cost / cpu_scale(memory_mb)
  concurrency    multiplicative contention on provision+code_init when many
                 simultaneous cold starts land on one worker (RQ2: Mohan/
                 Ustiugov observed cold starts grow with concurrency)

Defaults are calibrated from (a) this repo's *measured* XLA compile/load
times for the reduced models (benchmarks/bench_factors.py writes
``calibration.json``) and (b) the survey's cited magnitudes (100ms-1s range
container starts, ~3.7x snapshot-restore speedups).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

from repro_torch.core.lifecycle import (Breakdown, FunctionSpec, Phase, WarmthTier)

RUNTIME_INIT_S = {
    "python-eager": 0.45,   # import numpy/jax, no trace
    "python-jit": 0.25,     # lighter user code; trace happens in code_init
    "node": 0.15,
    "go": 0.05,
    "aot": 0.05,            # restored process image
}

# Fraction of the container's RAM allocation billed while it sits in each
# warmth tier.  A frozen cgroup keeps its pages but can be swapped/compressed
# (PCPM/SPES magnitudes); a written snapshot leaves only metadata + page
# cache residue; a cached image and a dead function bill nothing.
TIER_FOOTPRINT_FRAC = {
    WarmthTier.WARM_IDLE: 1.0,
    WarmthTier.PAUSED: 0.125,
    WarmthTier.SNAPSHOT_READY: 0.02,
    WarmthTier.IMG_CACHED: 0.0,
    WarmthTier.DEAD: 0.0,
}


@dataclass(frozen=True)
class CostModel:
    provision_base_s: float = 0.080
    provision_per_gb_s: float = 0.020
    runtime_init_s: Dict[str, float] = field(
        default_factory=lambda: dict(RUNTIME_INIT_S))
    load_bandwidth_gbps: float = 1.2      # package load at base memory
    base_memory_mb: float = 1024.0
    cpu_mem_exponent: float = 0.6         # cpu ∝ mem^e (linear-ish per RQ2)
    compile_base_s: float = 0.9           # XLA compile of a unit-cost model
    snapshot_restore_frac: float = 0.27   # vHive: ~3.7x faster than full cold
    pause_pool_skip: tuple = (Phase.PROVISION, Phase.RUNTIME_INIT)
    contention_alpha: float = 0.35        # cold-start inflation per extra
                                          # concurrent cold start on a worker
    # ---- warmth-tier ladder (graded container lifetimes) --------------- #
    resume_paused_s: float = 0.015        # cgroup thaw (PCPM: O(10ms))
    snapshot_write_s: float = 0.050       # demote cost: write the mem image
    img_cached_provision_frac: float = 0.4  # image already pulled: only the
                                            # sandbox/cgroup setup remains
    tier_footprint_frac: Dict[WarmthTier, float] = field(
        default_factory=lambda: dict(TIER_FOOTPRINT_FRAC))

    # ------------------------------------------------------------------ #
    def _cpu_scale(self, memory_mb: float) -> float:
        return (max(memory_mb, 64.0) / self.base_memory_mb) ** self.cpu_mem_exponent

    def breakdown(self, fn: FunctionSpec, *, concurrent_colds: int = 0,
                  from_snapshot: bool = False, from_pause_pool: bool = False,
                  deps_fraction: float = 1.0) -> Breakdown:
        """Full cold-start phase costs for one container start.

        deps_fraction < 1 models FaaSLight-style partial loading.
        """
        cpu = self._cpu_scale(fn.memory_mb)
        bw = self.load_bandwidth_gbps * cpu
        b = Breakdown({
            Phase.PROVISION: self.provision_base_s
            + self.provision_per_gb_s * fn.memory_mb / 1024.0,
            Phase.RUNTIME_INIT: self.runtime_init_s.get(fn.runtime, 0.25),
            Phase.DEPS_LOAD: (fn.package_mb * deps_fraction / 1024.0) / bw,
            Phase.CODE_INIT: (0.0 if fn.runtime == "python-eager"
                              else self.compile_base_s * fn.compile_cost / cpu),
        })
        if from_pause_pool:
            b = b.drop(*self.pause_pool_skip)
        if from_snapshot:
            # restore replaces runtime+deps+compile with one restore phase:
            # the snapshot IS the guest memory image with runtime, weights,
            # and compiled code resident (vHive/Catalyzer semantics)
            restore = (b.seconds[Phase.DEPS_LOAD]
                       + b.seconds[Phase.CODE_INIT]) * self.snapshot_restore_frac
            b = b.drop(Phase.DEPS_LOAD, Phase.CODE_INIT)
            b = b.replace(Phase.RUNTIME_INIT, self.runtime_init_s["aot"])
            b = b.replace(Phase.CODE_INIT, restore)
        if concurrent_colds > 0:
            mult = 1.0 + self.contention_alpha * math.log1p(concurrent_colds)
            b = b.scaled({Phase.PROVISION: mult, Phase.CODE_INIT: mult,
                          Phase.DEPS_LOAD: mult})
        return b

    def exec_time(self, fn: FunctionSpec, *, first_run_penalty: float = 0.0) -> float:
        """Warm execution time; CPU scales with the RAM allocation."""
        return fn.exec_time_s / self._cpu_scale(fn.memory_mb) + first_run_penalty

    # ------------------------------------------------------------------ #
    # warmth-tier ladder: footprints + the tier-transition cost matrix
    # ------------------------------------------------------------------ #
    def tier_footprint_mb(self, fn: FunctionSpec, tier: WarmthTier) -> float:
        """RAM billed while ``fn``'s container sits in ``tier``."""
        return fn.memory_mb * self.tier_footprint_frac.get(tier, 1.0)

    def promote_breakdown(self, fn: FunctionSpec, tier: WarmthTier, *,
                          concurrent_colds: int = 0,
                          deps_fraction: float = 1.0,
                          from_pause_pool: bool = False) -> Breakdown:
        """Phase costs to bring a container *from* ``tier`` to serving.

        This is the single entry point for every startup path — the old
        ``from_snapshot=`` / bare-``breakdown()`` call sites are the
        ``SNAPSHOT_READY`` / ``DEAD`` rows of this matrix.  Promote cost is
        exactly the Breakdown phases the tier has *not* already completed:

          WARM_IDLE       nothing — the container is live
          PAUSED          cgroup thaw only (everything resident)
          SNAPSHOT_READY  restore the memory image (vHive semantics)
          IMG_CACHED      full start minus the image pull
          DEAD            the full cold-start anatomy

        ``from_pause_pool`` layers the legacy *generic* pool on top (a
        pooled container has a runtime but not the function, so it still
        pays deps+code — distinct from the function-specific PAUSED tier).
        """
        if tier == WarmthTier.WARM_IDLE:
            return Breakdown({})
        if tier == WarmthTier.PAUSED:
            return Breakdown({Phase.PROVISION: self.resume_paused_s})
        if tier == WarmthTier.SNAPSHOT_READY:
            return self.breakdown(fn, concurrent_colds=concurrent_colds,
                                  from_snapshot=True,
                                  from_pause_pool=from_pause_pool)
        b = self.breakdown(fn, concurrent_colds=concurrent_colds,
                           deps_fraction=deps_fraction,
                           from_pause_pool=from_pause_pool)
        if tier == WarmthTier.IMG_CACHED and Phase.PROVISION in b.seconds:
            b = b.replace(Phase.PROVISION,
                          b.seconds[Phase.PROVISION]
                          * self.img_cached_provision_frac)
        return b

    def demote_cost_s(self, from_tier: WarmthTier,
                      to_tier: WarmthTier) -> float:
        """Seconds of work to move *down* the ladder (≈0 everywhere except
        the snapshot write)."""
        if (to_tier == WarmthTier.SNAPSHOT_READY
                and from_tier > WarmthTier.SNAPSHOT_READY):
            return self.snapshot_write_s
        return 0.0

    def transition_matrix(self, fn: FunctionSpec) \
            -> Dict[Tuple[WarmthTier, WarmthTier], float]:
        """(from, to) → seconds for every ladder edge: promote edges cost
        the remaining startup phases, demote edges ≈0 or the snapshot
        write.  Reporting/benchmark view of the ladder."""
        tiers = sorted(WarmthTier)
        out: Dict[Tuple[WarmthTier, WarmthTier], float] = {}
        for a in tiers:
            for b in tiers:
                if a == b:
                    continue
                if b == WarmthTier.WARM_IDLE:        # promote to serving
                    out[(a, b)] = self.promote_breakdown(fn, a).total
                elif b < a:                           # demotion
                    out[(a, b)] = self.demote_cost_s(a, b)
        return out

    # ------------------------------------------------------------------ #
    @classmethod
    def from_calibration(cls, path: str) -> "CostModel":
        """Build from measured values written by benchmarks/bench_factors.py
        or the closed loop in scripts/recalibrate.py (which inverts them
        from a real-engine event log via ``repro.analyze.calibrate``).

        Expected keys: compile_base_s, load_bandwidth_gbps, runtime_init_s
        (optional overrides); missing keys keep defaults.  Unknown keys
        (e.g. a ``_meta`` provenance block) are ignored.
        """
        with open(path) as f:
            data = json.load(f)
        kw = {}
        for k in ("compile_base_s", "load_bandwidth_gbps",
                  "snapshot_restore_frac", "provision_base_s",
                  "provision_per_gb_s", "resume_paused_s",
                  "snapshot_write_s", "img_cached_provision_frac",
                  "contention_alpha"):
            if k in data:
                kw[k] = float(data[k])
        cm = cls(**kw)
        if "runtime_init_s" in data:
            merged = dict(cm.runtime_init_s)
            merged.update({k: float(v) for k, v in data["runtime_init_s"].items()})
            cm = replace(cm, runtime_init_s=merged)
        return cm


# --------------------------------------------------------------------------- #
# Platform profiles (RQ4 / §5.4): each platform's architecture gives it a
# different cold-start fingerprint.  Relative magnitudes follow the paper's
# cited measurements (Wang et al. ATC'18, Lee et al., Manner et al.: AWS
# fastest for Python/Node; Azure slower cold starts but aggressive reuse;
# OpenWhisk/Knative pause-pools; Firecracker microVM fast provision).
# --------------------------------------------------------------------------- #

PLATFORM_PROFILES = {
    "aws_lambda": dict(
        provision_base_s=0.060, provision_per_gb_s=0.015,
        runtime_init_s={**RUNTIME_INIT_S, "python-jit": 0.20, "node": 0.10},
        load_bandwidth_gbps=1.6, keep_alive_default_s=600.0),
    "gcf": dict(
        provision_base_s=0.090, provision_per_gb_s=0.020,
        runtime_init_s={**RUNTIME_INIT_S, "python-jit": 0.25, "node": 0.16},
        load_bandwidth_gbps=1.2, keep_alive_default_s=900.0),
    "azure": dict(
        provision_base_s=0.180, provision_per_gb_s=0.030,
        runtime_init_s={**RUNTIME_INIT_S, "python-jit": 0.35, "node": 0.22},
        load_bandwidth_gbps=1.0, keep_alive_default_s=1200.0),
    "openwhisk": dict(
        provision_base_s=0.120, provision_per_gb_s=0.025,
        runtime_init_s={**RUNTIME_INIT_S, "python-jit": 0.30},
        load_bandwidth_gbps=1.1, keep_alive_default_s=600.0),
    "firecracker": dict(          # microVM: ~125ms boot, strong isolation
        provision_base_s=0.125, provision_per_gb_s=0.005,
        runtime_init_s={**RUNTIME_INIT_S, "python-jit": 0.22},
        load_bandwidth_gbps=1.3, keep_alive_default_s=600.0),
}


def platform_cost_model(platform: str) -> "CostModel":
    """CostModel preset for a named platform (RQ4)."""
    prof = dict(PLATFORM_PROFILES[platform])
    prof.pop("keep_alive_default_s")
    return CostModel(**prof)


def platform_keep_alive(platform: str) -> float:
    return PLATFORM_PROFILES[platform]["keep_alive_default_s"]
