"""EWMA / double-exponential-smoothing inter-arrival predictors (HotC uses
exponential smoothing; Fifer/FaaStest use time-series forecasts)."""
from __future__ import annotations

from typing import Optional


class EWMAPredictor:
    """Exponentially weighted moving average of inter-arrival gaps."""

    name = "ewma"

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.last_t: Optional[float] = None

    def observe(self, t: float) -> None:
        if self.last_t is not None:
            gap = t - self.last_t
            if self.mean is None:
                self.mean = gap
            else:
                err = gap - self.mean
                self.mean += self.alpha * err
                self.var = (1 - self.alpha) * (self.var + self.alpha * err * err)
        self.last_t = t

    def predict_next(self) -> Optional[float]:
        """Predicted absolute time of the next invocation."""
        if self.mean is None or self.last_t is None:
            return None
        return self.last_t + self.mean

    def uncertainty(self) -> float:
        return self.var ** 0.5


class ExpSmoothingPredictor(EWMAPredictor):
    """Holt double exponential smoothing (level + trend) — HotC-style."""

    name = "holt"

    def __init__(self, alpha: float = 0.4, beta: float = 0.1):
        super().__init__(alpha)
        self.beta = beta
        self.trend = 0.0

    def observe(self, t: float) -> None:
        if self.last_t is not None:
            gap = t - self.last_t
            if self.mean is None:
                self.mean, self.trend = gap, 0.0
            else:
                prev = self.mean
                err = gap - (self.mean + self.trend)
                self.mean = self.alpha * gap + (1 - self.alpha) * (self.mean + self.trend)
                self.trend = self.beta * (self.mean - prev) + (1 - self.beta) * self.trend
                self.var = (1 - self.alpha) * (self.var + self.alpha * err * err)
        self.last_t = t

    def predict_next(self):
        if self.mean is None or self.last_t is None:
            return None
        return self.last_t + max(self.mean + self.trend, 1e-3)
