"""Prewarming policies (CSF reduction): periodic ping, predictor-driven
container preparation (Fifer/FaaStest/ATOM/MASTER/AWU lineage), and the RL
keep-alive agent.

A prewarm policy answers, every ``tick_interval`` seconds: "which functions
should have a warm container *right now*?"  The simulator starts containers
(paying the startup cost asynchronously) for any listed function without
one, so a correct prediction hides the cold start entirely and a wrong one
burns idle GB-s — exactly the paper's §6.1 energy/accuracy trade-off.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.core.lifecycle import Container
from repro_torch.core.policies.base import KeepAlive, Prewarm
from repro_torch.core.predictors import (EWMAPredictor, ExpSmoothingPredictor,
                                         HistogramPredictor, MarkovPredictor)
from repro_torch.core.predictors.rl import QKeepAliveAgent


class PeriodicPing(Prewarm):
    """The classic 'ping every N seconds' hack: every function that has ever
    been invoked is kept warm by synthetic traffic (maximal waste)."""

    name = "periodic_ping"

    def __init__(self, tick_interval: float = 30.0):
        self.tick_interval = tick_interval
        self.seen: Dict[str, float] = {}

    def observe(self, function: str, t: float) -> None:
        self.seen[function] = t

    def decisions(self, t: float, ctx) -> List[str]:
        return list(self.seen)


class PredictivePrewarm(Prewarm):
    """Predictor-driven prewarming: prepare a container just before the
    forecast next invocation (lead = estimated cold-start time + margin)."""

    def __init__(self, predictor_factory: Callable, *, name: str,
                 tick_interval: float = 0.5, margin_s: float = 0.5):
        self.factory = predictor_factory
        self.name = f"prewarm_{name}"
        self.tick_interval = tick_interval
        self.margin_s = margin_s
        self.predictors: Dict[str, object] = {}

    def observe(self, function: str, t: float) -> None:
        if function not in self.predictors:
            self.predictors[function] = self.factory()
        self.predictors[function].observe(t)

    def decisions(self, t: float, ctx) -> List[str]:
        out = []
        for fn, pred in self.predictors.items():
            nxt = pred.predict_next()
            if nxt is None:
                continue
            lead = ctx.cold_start_estimate(fn) + self.margin_s
            unc = getattr(pred, "uncertainty", lambda: 0.0)() or 0.0
            lo, hi = nxt - lead - 0.5 * unc, nxt + 2 * unc + lead
            if lo <= t <= hi:
                out.append(fn)
        return out


def ewma_prewarm(**kw) -> PredictivePrewarm:
    return PredictivePrewarm(EWMAPredictor, name="ewma", **kw)


def holt_prewarm(**kw) -> PredictivePrewarm:
    return PredictivePrewarm(ExpSmoothingPredictor, name="holt", **kw)


def markov_prewarm(**kw) -> PredictivePrewarm:
    return PredictivePrewarm(MarkovPredictor, name="markov", **kw)


def histogram_prewarm(**kw) -> PredictivePrewarm:
    return PredictivePrewarm(HistogramPredictor, name="histogram", **kw)


def lstm_prewarm(device="cuda", **kw) -> PredictivePrewarm:
    """An online-trained LSTM per function on ``device``."""
    from functools import partial

    from repro_torch.core.predictors.lstm import LSTMPredictor
    return PredictivePrewarm(partial(LSTMPredictor, device=device), name="lstm", **kw)


def transformer_prewarm(checkpoint=None, device="cuda", **kw) -> PredictivePrewarm:
    """The trained forecaster (on ``device``) behind the exact same
    prewarm policy as ``histogram_prewarm`` — only the predictor differs,
    which is what makes the Pareto comparison apples-to-apples.  Falls back
    to the histogram when no checkpoint resolves."""
    from repro_torch.core.predictors.transformer import transformer_or_fallback
    return PredictivePrewarm(transformer_or_fallback(checkpoint, device=device),
                             name="transformer", **kw)


class HybridPrewarm(Prewarm):
    """Beyond-paper: histogram window for regular functions, falling back to
    Markov for irregular ones (chosen per function by dispersion)."""

    name = "prewarm_hybrid"
    tick_interval = 0.5

    def __init__(self, cv_threshold: float = 0.8):
        self.cv_threshold = cv_threshold
        self.hist: Dict[str, HistogramPredictor] = {}
        self.markov: Dict[str, MarkovPredictor] = {}

    def observe(self, function: str, t: float) -> None:
        self.hist.setdefault(function, HistogramPredictor()).observe(t)
        self.markov.setdefault(function, MarkovPredictor()).observe(t)

    def decisions(self, t: float, ctx) -> List[str]:
        import numpy as np
        out = []
        for fn, h in self.hist.items():
            gaps = h.gaps
            if len(gaps) >= 3:
                cv = float(np.std(gaps) / max(np.mean(gaps), 1e-9))
                pred = h if cv <= self.cv_threshold else self.markov[fn]
            else:
                pred = h
            nxt = pred.predict_next()
            if nxt is None:
                continue
            lead = ctx.cold_start_estimate(fn) + 0.5
            unc = pred.uncertainty()
            unc = 0.0 if unc == float("inf") else unc
            if nxt - lead - 0.5 * unc <= t <= nxt + 2 * unc + lead:
                out.append(fn)
        return out


class RLKeepAlive(KeepAlive):
    """Q-learning keep-alive: TTL per container chosen by the agent; the
    simulator reports outcomes back via ``resolve``."""

    name = "rl_keepalive"

    def __init__(self, **agent_kw):
        self.agent = QKeepAliveAgent(**agent_kw)
        self.mean_gap: Dict[str, Optional[float]] = {}
        self.last_seen: Dict[str, float] = {}
        self.pending: Dict[int, tuple] = {}   # container id -> (key, t_idle)

    def note_arrival(self, function: str, t: float) -> None:
        if function in self.last_seen:
            gap = t - self.last_seen[function]
            prev = self.mean_gap.get(function)
            self.mean_gap[function] = gap if prev is None else 0.7 * prev + 0.3 * gap
        self.last_seen[function] = t

    def ttl(self, container: Container, ctx) -> float:
        ttl, key = self.agent.choose_ttl(self.mean_gap.get(container.function))
        self.pending[container.id] = (key, ctx.now)
        return ttl

    def resolve(self, container_id: int, *, idle_s: float, missed: bool) -> None:
        item = self.pending.pop(container_id, None)
        if item is not None:
            self.agent.update(item[0], idle_s=idle_s, missed=missed)
