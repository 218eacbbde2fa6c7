"""Graded container-lifetime policies — demotion schedules down the
warmth-tier ladder (DEAD < IMG_CACHED < SNAPSHOT_READY < PAUSED <
WARM_IDLE).

The binary keep-alive of the surveyed platforms ("stay warm τ seconds,
then die") is the degenerate one-edge schedule; these policies return the
full ladder:

* :class:`KeepAliveLadder` — any :class:`~repro.core.policies.base.KeepAlive`
  reinterpreted as a Lifetime (its TTL becomes the single warm→DEAD edge);
  the explicit form of "KeepAlive is a special case".
* :class:`FixedLadder` — provider-default graded cooling: fixed dwell per
  tier (AWS SnapStart / PCPM-flavoured static configuration).
* :class:`PredictiveLadder` — SPES-style (arXiv:2403.17574) per-function
  tier chooser: an inter-arrival predictor from :mod:`repro.core.predictors`
  estimates when the function returns; the policy keeps the container in
  the *cheapest* tier whose promote cost still meets the latency budget,
  and schedules death just past the predicted window.
* :class:`RLLadder` — gives the off-policy RL keep-alive a graded action
  space: the agent's chosen TTL becomes the warm dwell, after which the
  container *demotes* instead of dying (kill/keep becomes
  kill/keep/demote); tombstone feedback reaches the agent weighted by the
  tier the container actually waited in (see ``PolicyDriver``).
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

from repro_torch.core.lifecycle import Container, WarmthTier
from repro_torch.core.policies.base import KeepAlive, Lifetime, TierEdge
from repro_torch.core.predictors import HistogramPredictor


KEEPALIVE_SCHEDULE_ENV = "REPRO_KEEPALIVE_SCHEDULE"
DEFAULT_KEEPALIVE_SCHEDULE = os.path.join("checkpoints",
                                          "keepalive_schedule.json")


def load_keepalive_schedule(path: Optional[str] = None) -> Optional[dict]:
    """Load an exported learned keep-alive schedule (explicit path >
    ``$REPRO_KEEPALIVE_SCHEDULE`` > ``checkpoints/keepalive_schedule.json``).

    Returns ``{"warm_s": {fn: dwell_s}, "default_s": float, ...}`` or
    ``None`` when no file resolves."""
    for cand in (path, os.environ.get(KEEPALIVE_SCHEDULE_ENV),
                 DEFAULT_KEEPALIVE_SCHEDULE):
        if cand and os.path.exists(cand):
            with open(cand) as fh:
                data = json.load(fh)
            if "warm_s" not in data:
                raise ValueError(f"{cand}: schedule missing 'warm_s' map")
            data["warm_s"] = {k: float(v) for k, v in data["warm_s"].items()}
            return data
    return None


class KeepAliveLadder(Lifetime):
    """A binary keep-alive lifted into the Lifetime family unchanged."""

    def __init__(self, keepalive: KeepAlive):
        self.keepalive = keepalive
        self.name = f"ladder({keepalive.name})"

    def schedule(self, container: Container, ctx) -> List[TierEdge]:
        ttl = self.keepalive.ttl(container, ctx)
        if ttl == float("inf"):
            return []
        return [(ttl, WarmthTier.DEAD)]


class FixedLadder(Lifetime):
    """Static graded cooling: warm ``warm_s``, frozen ``paused_s``,
    snapshot-resident ``snapshot_s``, then dead.  A dwell of 0 skips the
    tier instantly; ``inf`` parks the container in that tier forever."""

    def __init__(self, warm_s: float = 60.0, paused_s: float = 540.0,
                 snapshot_s: float = 1800.0):
        self.warm_s = warm_s
        self.paused_s = paused_s
        self.snapshot_s = snapshot_s
        self.name = (f"fixed_ladder({warm_s:g}/{paused_s:g}/"
                     f"{snapshot_s:g}s)")

    def schedule(self, container: Container, ctx) -> List[TierEdge]:
        return [(self.warm_s, WarmthTier.PAUSED),
                (self.paused_s, WarmthTier.SNAPSHOT_READY),
                (self.snapshot_s, WarmthTier.DEAD)]


class PredictiveLadder(Lifetime):
    """SPES-style predictive tier selection, per function.

    With enough history, the per-function inter-arrival histogram gives a
    (p_low, p_high) window for the next invocation.  The policy:

    * stays WARM through the early-return mass (up to ``max_warm_s``);
    * then demotes to the cheapest tier whose promote cost still fits
      ``latency_budget_s`` (PAUSED at ~10 ms, else SNAPSHOT_READY);
    * keeps that tier until ``death_factor ×`` the p_high gap has passed
      (the function is presumed gone), steps through SNAPSHOT_READY so a
      snapshot is on disk for the eventual return, and dies.

    Functions without history get the conservative ``fallback`` ladder.
    """

    def __init__(self, latency_budget_s: float = 0.20,
                 max_warm_s: float = 60.0, min_warm_s: float = 2.0,
                 death_factor: float = 1.5,
                 snapshot_linger_s: float = 1800.0,
                 fallback: Optional[FixedLadder] = None,
                 predictor_factory: Optional[Callable[[], object]] = None):
        self.latency_budget_s = latency_budget_s
        self.max_warm_s = max_warm_s
        self.min_warm_s = min_warm_s
        self.death_factor = death_factor
        self.snapshot_linger_s = snapshot_linger_s
        self.fallback = fallback or FixedLadder()
        # any predictor speaking the histogram protocol (observe/window)
        # drops in — e.g. the trained TransformerPredictor
        self.predictor_factory = predictor_factory or HistogramPredictor
        self.predictors: Dict[str, object] = {}
        tag = getattr(self.predictor_factory, "name", None)
        suffix = "" if self.predictor_factory is HistogramPredictor else \
            f",{tag or 'learned'}"
        self.name = f"spes({latency_budget_s * 1e3:g}ms{suffix})"

    def observe(self, function: str, t: float) -> None:
        if function not in self.predictors:
            self.predictors[function] = self.predictor_factory()
        self.predictors[function].observe(t)

    def schedule(self, container: Container, ctx) -> List[TierEdge]:
        pred = self.predictors.get(container.function)
        window = pred.window() if pred is not None else None
        if window is None:
            return self.fallback.schedule(container, ctx)
        lo, hi = window
        gap_lo = max(lo - ctx.now, 0.0)
        gap_hi = max(hi - ctx.now, gap_lo)
        # cheapest tier that still meets the latency budget on promote
        target = WarmthTier.WARM_IDLE
        for tier in (WarmthTier.SNAPSHOT_READY, WarmthTier.PAUSED):
            if ctx.promote_estimate(container.function,
                                    tier) <= self.latency_budget_s:
                target = tier
                break
        # stay warm through the early-return mass only: if even the p_low
        # gap is beyond the warm cap, the function won't be back soon —
        # demote almost immediately and let the cheap tier absorb the wait
        if gap_lo <= self.max_warm_s:
            warm_s = max(gap_lo, self.min_warm_s)
        else:
            warm_s = self.min_warm_s
        deadline = max(gap_hi * self.death_factor, warm_s + 1.0)
        if target == WarmthTier.WARM_IDLE:
            # nothing cheaper is fast enough: binary behaviour, die late
            return [(deadline, WarmthTier.DEAD)]
        edges: List[TierEdge] = [(warm_s, target)]
        if target == WarmthTier.PAUSED:
            edges.append((max(deadline - warm_s, 0.0),
                          WarmthTier.SNAPSHOT_READY))
            edges.append((self.snapshot_linger_s, WarmthTier.DEAD))
        else:
            edges.append((max(deadline - warm_s, self.snapshot_linger_s),
                          WarmthTier.DEAD))
        return edges


class RLLadder(Lifetime):
    """Demote-not-die action space for the RL keep-alive: the agent's TTL
    decision governs the warm dwell, after which the container slides to
    PAUSED and then SNAPSHOT_READY instead of dying — so a mispredicted
    TTL costs a ~10 ms resume, not a full cold start, and the reward the
    agent sees (tier-weighted idle seconds) reflects the cheaper parking.

    A trained off-policy agent (``repro.learn.agent``) exports its greedy
    policy as a static per-function warm-dwell map; once attached via
    :meth:`attach_schedule`, ``schedule`` *replays* that map instead of
    consulting the online keepalive — deterministically, in every driver.
    The batch driver only supports RLLadder in this exported-schedule
    form (``batchsim.check_supported``); without one it raises instead of
    silently pinning a midpoint dwell.
    """

    def __init__(self, keepalive: KeepAlive, *, paused_s: float = 540.0,
                 snapshot_s: float = 1800.0,
                 learned_warm_s: Optional[Dict[str, float]] = None,
                 learned_default_s: Optional[float] = None):
        self.keepalive = keepalive
        self.paused_s = paused_s
        self.snapshot_s = snapshot_s
        self.learned_warm_s = learned_warm_s
        self.learned_default_s = learned_default_s
        self.name = f"rl_ladder({keepalive.name})"
        if learned_warm_s is not None:
            self.name = f"rl_ladder(learned,{len(learned_warm_s)}fns)"

    def attach_schedule(self, warm_s: Dict[str, float],
                        *, default_s: Optional[float] = None) -> None:
        """Replay an exported learned schedule: per-function warm dwell in
        seconds; unknown functions get ``default_s`` (median of the map
        when omitted)."""
        self.learned_warm_s = dict(warm_s)
        if default_s is None and warm_s:
            vals = sorted(warm_s.values())
            default_s = vals[len(vals) // 2]
        self.learned_default_s = default_s
        self.name = f"rl_ladder(learned,{len(warm_s)}fns)"

    def schedule(self, container: Container, ctx) -> List[TierEdge]:
        if self.learned_warm_s is not None:
            ttl = self.learned_warm_s.get(
                container.function,
                self.learned_default_s if self.learned_default_s is not None
                else 120.0)
        else:
            ttl = self.keepalive.ttl(container, ctx)
        if ttl == float("inf"):
            return []
        return [(ttl, WarmthTier.PAUSED),
                (self.paused_s, WarmthTier.SNAPSHOT_READY),
                (self.snapshot_s, WarmthTier.DEAD)]
