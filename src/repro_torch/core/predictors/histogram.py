"""Per-function inter-arrival histogram predictor (the 'application
knowledge' family, Bermbach et al. / serverless-in-the-wild shape):
prewarm at the p_low quantile of observed gaps, release at p_high."""
from __future__ import annotations

from typing import Optional

import numpy as np


class HistogramPredictor:
    name = "histogram"

    def __init__(self, p_low: float = 0.05, p_high: float = 0.95,
                 max_samples: int = 512):
        self.p_low, self.p_high = p_low, p_high
        self.gaps: list = []
        self.max_samples = max_samples
        self.last_t: Optional[float] = None

    def observe(self, t: float) -> None:
        if self.last_t is not None:
            self.gaps.append(t - self.last_t)
            if len(self.gaps) > self.max_samples:
                self.gaps.pop(0)
        self.last_t = t

    def window(self):
        """(prewarm_at, release_at) absolute times, or None."""
        if len(self.gaps) < 3 or self.last_t is None:
            return None
        lo = float(np.quantile(self.gaps, self.p_low))
        hi = float(np.quantile(self.gaps, self.p_high))
        return self.last_t + lo, self.last_t + hi

    def predict_next(self) -> Optional[float]:
        if len(self.gaps) < 1 or self.last_t is None:
            return None
        return self.last_t + float(np.median(self.gaps))

    def uncertainty(self) -> float:
        if len(self.gaps) < 3:
            return float("inf")
        return float(np.quantile(self.gaps, self.p_high)
                     - np.quantile(self.gaps, self.p_low))
