"""Policy catalog: named PolicySuites covering the paper's taxonomy.

``suite(name)`` returns a fresh PolicySuite; ``CATALOG`` lists everything
(benchmarks iterate it for the Table-5 comparison).  ``device`` is where
the learned predictors of ``prewarm_lstm``, ``prewarm_transformer`` and
``tiered_transformer`` run ("cuda" unless the caller asks for "cpu"; they
raise without a card); every other suite takes no device.
"""
from __future__ import annotations

from repro_torch.core.policies.base import (Lifetime, Placement, PolicySuite,
                                            Startup)
from repro_torch.core.policies.keepalive import FixedTTL, GreedyDualKeepAlive, LCS
from repro_torch.core.policies.lifetime import (FixedLadder, KeepAliveLadder,
                                                PredictiveLadder, RLLadder,
                                                load_keepalive_schedule)
from repro_torch.core.policies.prewarm import (HybridPrewarm, PeriodicPing,
                                               RLKeepAlive, ewma_prewarm,
                                               histogram_prewarm, holt_prewarm,
                                               lstm_prewarm, markov_prewarm,
                                               transformer_prewarm)
from repro_torch.core.policies.scheduling import CASPlacement, ENSUREScaling


def suite(name: str, *, device="cuda", **kw) -> PolicySuite:
    return _FACTORIES[name](device=device, **kw)


class _OnDevice:
    """A suite field built on the suite's device (a learned predictor's)."""

    def __init__(self, fn):
        self.fn = fn


def _mk(name, **fields):
    def factory(*, device="cuda", **kw):
        f = {k: (v.fn(device=device) if isinstance(v, _OnDevice)
                 else v() if callable(v) else v)
             for k, v in fields.items()}
        f.update(kw)
        return PolicySuite(name=name, **f)
    return factory


def _transformer_ladder(device="cuda") -> PredictiveLadder:
    from repro_torch.core.predictors.transformer import transformer_or_fallback
    return PredictiveLadder(predictor_factory=transformer_or_fallback(device=device))


_FACTORIES = {
    # --- baselines ------------------------------------------------------ #
    "cold_always": _mk("cold_always", keepalive=lambda: FixedTTL(0.0)),
    "provider_default": _mk("provider_default",
                            keepalive=lambda: FixedTTL(600.0)),
    "provider_short": _mk("provider_short", keepalive=lambda: FixedTTL(60.0)),
    # --- CSL: startup-path reductions (Table 4 families) ----------------- #
    "snapshot_restore": _mk("snapshot_restore",
                            keepalive=lambda: FixedTTL(600.0),
                            startup=Startup(snapshot=True)),
    "pause_pool": _mk("pause_pool", keepalive=lambda: FixedTTL(600.0),
                      startup=Startup(pause_pool_size=8)),
    "faaslight": _mk("faaslight", keepalive=lambda: FixedTTL(600.0),
                     startup=Startup(deps_fraction=0.35,
                                     first_run_penalty_frac=0.4)),
    "csl_combined": _mk("csl_combined", keepalive=lambda: FixedTTL(600.0),
                        startup=Startup(snapshot=True, pause_pool_size=8)),
    # --- CSF: keep-alive / pools / scheduling (Table 5 families) --------- #
    "faascache": _mk("faascache", keepalive=GreedyDualKeepAlive),
    "lcs": _mk("lcs", keepalive=LCS),
    "periodic_ping": _mk("periodic_ping", keepalive=lambda: FixedTTL(600.0),
                         prewarm=PeriodicPing),
    "prewarm_ewma": _mk("prewarm_ewma", keepalive=lambda: FixedTTL(60.0),
                        prewarm=ewma_prewarm),
    "prewarm_holt": _mk("prewarm_holt", keepalive=lambda: FixedTTL(60.0),
                        prewarm=holt_prewarm),
    "prewarm_markov": _mk("prewarm_markov", keepalive=lambda: FixedTTL(60.0),
                          prewarm=markov_prewarm),
    "prewarm_histogram": _mk("prewarm_histogram",
                             keepalive=lambda: FixedTTL(60.0),
                             prewarm=histogram_prewarm),
    "prewarm_lstm": _mk("prewarm_lstm", keepalive=lambda: FixedTTL(60.0),
                        prewarm=_OnDevice(lstm_prewarm)),
    "prewarm_transformer": _mk("prewarm_transformer",
                               keepalive=lambda: FixedTTL(60.0),
                               prewarm=_OnDevice(transformer_prewarm)),
    "rl_keepalive": _mk("rl_keepalive", keepalive=RLKeepAlive),
    "cas": _mk("cas", keepalive=lambda: FixedTTL(600.0),
               placement=lambda: CASPlacement()),
    "ensure": _mk("ensure", keepalive=lambda: FixedTTL(600.0),
                  prewarm=ENSUREScaling),
    # --- graded warmth-tier ladders (Lifetime family) --------------------- #
    # the binary fixed-TTL comparator for these is provider_short/default
    "tiered_fixed": _mk("tiered_fixed", keepalive=lambda: FixedTTL(600.0),
                        lifetime=lambda: FixedLadder(
                            warm_s=45.0, paused_s=555.0, snapshot_s=1800.0),
                        startup=Startup(img_cache=True)),
    "tiered_spes": _mk("tiered_spes", keepalive=lambda: FixedTTL(600.0),
                       lifetime=lambda: PredictiveLadder(),
                       startup=Startup(img_cache=True)),
    "tiered_transformer": _mk("tiered_transformer",
                              keepalive=lambda: FixedTTL(600.0),
                              lifetime=_OnDevice(_transformer_ladder),
                              startup=Startup(img_cache=True)),
    # --- beyond-paper hybrids -------------------------------------------- #
    "hybrid_prewarm": _mk("hybrid_prewarm", keepalive=lambda: FixedTTL(60.0),
                          prewarm=HybridPrewarm),
    "beyond_combo": _mk("beyond_combo", keepalive=GreedyDualKeepAlive,
                        prewarm=HybridPrewarm,
                        placement=lambda: CASPlacement(),
                        startup=Startup(snapshot=True, pause_pool_size=4)),
}


def _tiered_rl(device="cuda", **kw) -> PolicySuite:
    """RL keep-alive with the demote-not-die action space: one agent
    instance serves both the keepalive slot (pressure eviction + reuse
    feedback) and the ladder's warm-dwell decision."""
    ka = RLKeepAlive()
    f = dict(keepalive=ka, lifetime=RLLadder(ka),
             startup=Startup(img_cache=True))
    f.update(kw)
    return PolicySuite(name="tiered_rl", **f)


def _tiered_rl_learned(schedule_path=None, device="cuda", **kw) -> PolicySuite:
    """RLLadder replaying a trained agent's exported per-function schedule
    (``scripts/train_predictors.py`` -> ``checkpoints/keepalive_schedule
    .json`` or ``$REPRO_KEEPALIVE_SCHEDULE``).  Fully deterministic — no
    online agent — so the batch driver supports it.  Without an exported
    schedule it degrades to the online ``tiered_rl`` suite with a warning
    so CATALOG stays iterable on untrained machines."""
    sched = load_keepalive_schedule(schedule_path)
    if sched is None:
        import warnings
        warnings.warn(
            "no exported keep-alive schedule found; tiered_rl_learned "
            "falls back to the online tiered_rl agent (train one with "
            "scripts/train_predictors.py)")
        return _tiered_rl(**kw)
    lt = RLLadder(FixedTTL(600.0))
    lt.attach_schedule(sched["warm_s"], default_s=sched.get("default_s"))
    f = dict(keepalive=FixedTTL(600.0), lifetime=lt,
             startup=Startup(img_cache=True))
    f.update(kw)
    return PolicySuite(name="tiered_rl_learned", **f)


_FACTORIES["tiered_rl"] = _tiered_rl
_FACTORIES["tiered_rl_learned"] = _tiered_rl_learned

CATALOG = tuple(_FACTORIES)

__all__ = ["suite", "CATALOG", "PolicySuite", "Startup", "Lifetime",
           "FixedLadder", "KeepAliveLadder", "PredictiveLadder", "RLLadder",
           "load_keepalive_schedule"]
