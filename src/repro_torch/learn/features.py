"""Trace windows -> model features for the gap forecaster.

One example is the sliding history of a single function: its last
``window`` inter-arrival gaps, right-aligned and zero-padded, each
position carrying

* ``log1p(gap)`` (clipped — gaps span milliseconds to hours),
* a valid-mask channel (1 real observation, 0 padding), and
* sin/cos phase of the gap-ending arrival at several fixed periods
  (the "time-of-day/diurnal" channels: cron-style workloads re-fire at
  wall-clock phases that per-function marginal statistics cannot see).

The target is the *next* gap, in the same log1p space.  The exact same
encoder runs at training time (:mod:`repro_torch.learn.dataset`) and at
inference time inside ``core/predictors/transformer.py`` — one code
path, so a trained checkpoint is valid wherever the predictor protocol
is consumed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

# fixed phase vocabularies: 15 min / hourly / bi-hourly / 4-hourly cycles
DEFAULT_PERIODS = (900.0, 3600.0, 7200.0, 14_400.0)


@dataclass(frozen=True)
class FeatureConfig:
    """Window geometry shared by the dataset, the model, and the
    serving-side predictor (persisted into the checkpoint's ``extra``)."""

    window: int = 16
    periods: Tuple[float, ...] = DEFAULT_PERIODS
    quantiles: Tuple[float, ...] = (0.05, 0.5, 0.95)
    log_clip: float = 12.0          # caps log1p(gap): e^12 s ~ 45 h

    @property
    def n_features(self) -> int:
        return 2 + 2 * len(self.periods)

    def to_dict(self) -> dict:
        return {"window": self.window, "periods": list(self.periods),
                "quantiles": list(self.quantiles), "log_clip": self.log_clip}

    @classmethod
    def from_dict(cls, d: dict) -> "FeatureConfig":
        return cls(window=int(d["window"]), periods=tuple(d["periods"]),
                   quantiles=tuple(d["quantiles"]),
                   log_clip=float(d["log_clip"]))


def encode_gap(gap: float, cfg: FeatureConfig) -> float:
    return float(np.clip(np.log1p(max(gap, 0.0)), 0.0, cfg.log_clip))


def decode_gap(y: float) -> float:
    return float(np.expm1(y))


def encode_window(gaps: Sequence[float], ends: Sequence[float],
                  cfg: FeatureConfig) -> np.ndarray:
    """One (window, n_features) array from a function's gap history.

    ``gaps[i]`` ended at arrival time ``ends[i]``; only the most recent
    ``cfg.window`` entries are used, right-aligned (the last row is the
    latest observation — the readout position).
    """
    W = cfg.window
    g = np.asarray(gaps[-W:], dtype=np.float64)
    e = np.asarray(ends[-W:], dtype=np.float64)
    n = len(g)
    x = np.zeros((W, cfg.n_features), dtype=np.float32)
    if n:
        x[W - n:, 0] = np.clip(np.log1p(np.maximum(g, 0.0)), 0.0,
                               cfg.log_clip)
        x[W - n:, 1] = 1.0
        for i, period in enumerate(cfg.periods):
            ph = 2.0 * np.pi * e / period
            x[W - n:, 2 + 2 * i] = np.sin(ph)
            x[W - n:, 3 + 2 * i] = np.cos(ph)
    return x


def function_examples(times: np.ndarray,
                      cfg: FeatureConfig) -> Tuple[np.ndarray, np.ndarray]:
    """All (window, target) examples from one function's arrival times.

    Example ``j`` (j >= 1) predicts gap ``g_j`` from the history
    ``g_0..g_{j-1}`` — so the model learns to act from a *single*
    observed gap, which is exactly when the histogram baselines are
    still uncertainty-blind.  Returns ``(X[N, W, F], y[N])``; ``N = 0``
    for functions with fewer than 3 arrivals.
    """
    times = np.asarray(times, dtype=np.float64)
    if times.size < 3:
        return (np.zeros((0, cfg.window, cfg.n_features), np.float32),
                np.zeros((0,), np.float32))
    gaps = np.diff(times)
    ends = times[1:]
    X = np.stack([encode_window(gaps[:j], ends[:j], cfg)
                  for j in range(1, len(gaps))])
    y = np.clip(np.log1p(np.maximum(gaps[1:], 0.0)), 0.0,
                cfg.log_clip).astype(np.float32)
    return X, y
